"""Batched ray geometry: camera basis, scene preparation, nearest-hit trace.

Array-first redesign of the reference's per-ray recursive intersection scan
(spec /root/reference/renderer/cpu/Raytracer.cpp): instead of looping objects
per ray, we intersect **all rays x all objects** as dense array ops and take a
masked argmin over the object axis. Object ids are planes-first then spheres,
matching the reference scan order (Raytracer.cpp:131-132) and its tie behavior
(a later object needs a strictly smaller t to win; argmin keeps the first).

Semantics replicated exactly:
  * rays are transformed to object space by the inverse transform; hit
    distances are scaled by the transform determinant (Raytracer.cpp:70,96);
  * sphere intersection uses the numerically stable quadratic with the
    sign(b) branch (Raytracer.cpp:34-41);
  * sphere normals are object-space hit points rotated by the forward matrix
    and normalized; the tangent uses the smallest-component permutation trick
    (Raytracer.cpp:52-64);
  * plane normals are the *negated* rotated local +Y, not re-normalized
    (Raytracer.cpp:90); plane tangent is the rotated +X;
  * `t == 0` is accepted (minDistance is 0 and the bound checks are strict).

Everything here is differentiable w.r.t. the scene pytree: `prepare_scene`
derives inverses/determinants with jnp inside the traced computation.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.types import Camera, Materials, Scene
from ..utils.math3d import unproject
from .sampling import safe_normalize, safe_sqrt

FLT_EPSILON = jnp.float32(1.1920928955078125e-07)
INF = jnp.float32(jnp.inf)
# All geometry matmuls must run at full f32: on a GPU a float32 product may
# otherwise run in TF32, which keeps about three decimal digits and visibly
# shifts ray-object intersections.
HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=HI)


def _pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    meta = [f for f in fields if f in getattr(cls, "_static_fields", ())]
    jax.tree_util.register_dataclass(
        cls, data_fields=[f for f in fields if f not in meta], meta_fields=meta
    )
    return cls


@_pytree_dataclass
class CameraBasis:
    """Image-plane basis from unprojected viewport corners (cpu/Renderer.cpp:30-34)."""

    origin: jax.Array  # [3]
    p1: jax.Array      # [3] world point of screen (0,0) on the near plane
    du: jax.Array      # [3] p2 - p1 (screen +x)
    dv: jax.Array      # [3] p3 - p1 (screen +y)


@_pytree_dataclass
class PreparedScene:
    """Derived, trace-ready scene. All leaves are functions of Scene leaves.

    ``rigid`` is static: True when every sphere transform is rigid
    (orthonormal linear part, det +1, checked at scene load). Rigid scenes
    use the fast world-space sphere path: the ray-sphere quadratic reduces to
    two [N,3]x[3,S] matmuls plus elementwise work, with *identical*
    results to the reference's object-space formulation (R^T preserves
    lengths, det=1 makes the t-scaling a no-op, and the world normal equals
    (hit - center)/radius exactly)."""

    _static_fields = ("rigid",)

    # planes: only the inverse-matrix row that yields object-space y is needed
    plane_nrow: jax.Array     # [P, 4]  (inv[1, :]) — o_loc.y = nrow[:3]·o + nrow[3]
    plane_det: jax.Array      # [P]
    plane_normal: jax.Array   # [P, 3]  world normal = -fwd3 @ (0,1,0) (unnormalized)
    plane_tangent: jax.Array  # [P, 3]  world tangent = fwd3 @ (1,0,0)
    # spheres
    sphere_inv3: jax.Array    # [S, 3, 3]
    sphere_invt: jax.Array    # [S, 3]
    sphere_fwd3: jax.Array    # [S, 3, 3]
    sphere_det: jax.Array     # [S]
    sphere_radius2: jax.Array # [S]
    sphere_center: jax.Array  # [S, 3] world-space centers (translation column)
    rigid: bool
    # lights (emissive spheres; static subset chosen at scene build)
    light_center: jax.Array   # [L, 3] world-space sphere center
    light_radius: jax.Array   # [L]
    light_emission: jax.Array # [L, 4]
    light_obj: jax.Array      # [L] int32 object id (planes-first indexing)
    # shading tables
    materials: Materials      # K = P + S
    background: jax.Array     # [4]
    camera: CameraBasis


@_pytree_dataclass
class SurfaceHit:
    """SoA SurfacePoint (cpu/SurfacePoint.h:13-29): obj == -1 means miss."""

    t: jax.Array         # [N] world-space (determinant-scaled) hit distance
    obj: jax.Array       # [N] int32, -1 on miss
    position: jax.Array  # [N, 3]
    normal: jax.Array    # [N, 3]
    tangent: jax.Array   # [N, 3]
    binormal: jax.Array  # [N, 3]
    view: jax.Array      # [N, 3] incident ray direction


def camera_basis(camera: Camera) -> CameraBasis:
    view = jnp.asarray(camera.transform, jnp.float32)
    proj = jnp.asarray(camera.projection, jnp.float32)
    p1 = unproject(jnp.array([0.0, 0.0, 0.0]), view, proj, xp=jnp)
    p2 = unproject(jnp.array([1.0, 0.0, 0.0]), view, proj, xp=jnp)
    p3 = unproject(jnp.array([0.0, 1.0, 0.0]), view, proj, xp=jnp)
    origin = jnp.matmul(
        jnp.linalg.inv(view), jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32), precision=HI
    )[:3]
    return CameraBasis(origin=origin, p1=p1, du=p2 - p1, dv=p3 - p1)


def generate_rays(basis: CameraBasis, sx: jax.Array, sy: jax.Array):
    """Camera rays through normalized screen coords (cpu/Renderer.cpp:55-59).

    Callers supply sy already flipped ((H - y) / H convention)."""
    d = (
        basis.p1[None, :]
        + basis.du[None, :] * sx[:, None]
        + basis.dv[None, :] * sy[:, None]
        - basis.origin[None, :]
    )
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(basis.origin, d.shape)
    return o, d


def prepare_scene(scene: Scene) -> PreparedScene:
    pt = jnp.asarray(scene.plane_transform, jnp.float32)
    st = jnp.asarray(scene.sphere_transform, jnp.float32)
    radius = jnp.asarray(scene.sphere_radius, jnp.float32)

    plane_inv = jnp.linalg.inv(pt) if pt.shape[0] else pt
    rigid = bool(getattr(scene, "rigid_spheres", False))
    # rigid scenes never touch the object-space sphere fields; skip the
    # per-sphere 4x4 inversions (matters at 100k spheres)
    sphere_inv = (
        st[:0] if rigid else (jnp.linalg.inv(st) if st.shape[0] else st)
    )

    num_planes = pt.shape[0]
    light_idx = jnp.asarray(scene.light_indices, jnp.int32).reshape(-1)
    light_transform = st[light_idx] if len(scene.light_indices) else st[:0]

    materials = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), scene.materials)

    prep = PreparedScene(
        plane_nrow=plane_inv[:, 1, :],
        plane_det=jnp.linalg.det(pt) if pt.shape[0] else jnp.zeros((0,), jnp.float32),
        plane_normal=-pt[:, :3, 1],
        plane_tangent=pt[:, :3, 0],
        sphere_inv3=sphere_inv[:, :3, :3],
        sphere_invt=sphere_inv[:, :3, 3],
        sphere_fwd3=st[:0, :3, :3] if rigid else st[:, :3, :3],
        sphere_det=jnp.zeros((0,), jnp.float32)
        if rigid
        else (jnp.linalg.det(st) if st.shape[0] else jnp.zeros((0,), jnp.float32)),
        sphere_radius2=radius * radius,
        sphere_center=st[:, :3, 3],
        rigid=rigid,
        light_center=light_transform[:, :3, 3],
        light_radius=radius[light_idx] if len(scene.light_indices) else radius[:0],
        light_emission=materials.emission[num_planes + light_idx]
        if len(scene.light_indices)
        else materials.emission[:0],
        light_obj=num_planes + light_idx,
        materials=materials,
        background=jnp.asarray(scene.background, jnp.float32),
        camera=camera_basis(scene.camera),
    )
    return prep


def _intersect_planes(prep: PreparedScene, o, d):
    """Plane hits (Raytracer.cpp:74-98). Returns (t_world [N,P], valid [N,P])."""
    n, c = prep.plane_nrow[:, :3], prep.plane_nrow[:, 3]
    denom = _mm(d, n.T)                 # [N, P] object-space d.y
    onum = _mm(o, n.T) + c[None, :]     # [N, P] object-space o.y
    t_loc = -onum / jnp.where(denom == 0, 1.0, denom)
    t = t_loc * prep.plane_det[None, :]
    valid = (jnp.abs(denom) >= FLT_EPSILON) & (t_loc >= 0) & (t >= 0)
    return jnp.where(valid, t, INF), t_loc


def _intersect_spheres(prep: PreparedScene, o, d):
    """Sphere hits via the stable quadratic (Raytracer.cpp:21-51).

    Returns (t_world [N,S], t_loc [N,S], o_loc [N,S,3], d_loc [N,S,3])."""
    o_loc = jnp.einsum("sij,nj->nsi", prep.sphere_inv3, o, precision=HI) + prep.sphere_invt[None, :, :]
    d_loc = jnp.einsum("sij,nj->nsi", prep.sphere_inv3, d, precision=HI)
    a = jnp.sum(d_loc * d_loc, -1)
    b = 2.0 * jnp.sum(d_loc * o_loc, -1)
    c = jnp.sum(o_loc * o_loc, -1) - prep.sphere_radius2[None, :]
    discr = b * b - 4.0 * a * c
    sq = safe_sqrt(discr)
    q = jnp.where(b < 0, (-b - sq) * 0.5, (-b + sq) * 0.5)
    t0 = q / jnp.where(a == 0, 1.0, a)
    t1 = c / jnp.where(q == 0, 1.0, q)
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    t_loc = jnp.where(lo < 0, hi, lo)
    t = t_loc * prep.sphere_det[None, :]
    valid = (discr >= 0) & (hi >= 0) & (a != 0) & (q != 0) & (t >= 0)
    return jnp.where(valid, t, INF), t_loc, o_loc, d_loc


def _intersect_spheres_rigid(prep: PreparedScene, o, d):
    """World-space sphere hits for rigid scenes: |o + t d - c|² = r² with
    |d| = 1. The ray-dependent work is two [N,3]x[3,S] matmuls; results
    match the object-space path exactly (isometry + det 1). Returns t [N,S]."""
    c = prep.sphere_center  # [S, 3]
    d_dot_c = _mm(d, c.T)  # [N, S]
    o_dot_c = _mm(o, c.T)  # [N, S]
    d_dot_o = jnp.sum(d * o, -1, keepdims=True)  # [N, 1]
    o2 = jnp.sum(o * o, -1, keepdims=True)  # [N, 1]
    cc = jnp.sum(c * c, -1) - prep.sphere_radius2  # [S]
    b = 2.0 * (d_dot_o - d_dot_c)
    cq = o2 - 2.0 * o_dot_c + cc[None, :]
    discr = b * b - 4.0 * cq
    sq = safe_sqrt(discr)
    q = jnp.where(b < 0, (-b - sq) * 0.5, (-b + sq) * 0.5)
    t0 = q  # a == 1
    t1 = cq / jnp.where(q == 0, 1.0, q)
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    t = jnp.where(lo < 0, hi, lo)
    valid = (discr >= 0) & (hi >= 0) & (q != 0) & (t >= 0)
    return jnp.where(valid, t, INF)


# dense [N, S] sphere sweeps above this object count would blow HBM
# (N rays x S spheres x 4B); the chunked path scans sphere blocks with a
# running nearest-hit instead. 100k spheres x 256k rays stays ~N*CHUNK.
BIG_SCENE_THRESHOLD = 8192
BIG_SCENE_CHUNK = 2048


def _intersect_spheres_rigid_chunked(prep: PreparedScene, o, d):
    """Running nearest-hit over sphere blocks (the big-scene path, rigid only).

    Returns (t_best [N], sidx_best [N]) with sidx -1 where no sphere hit.
    This is the object-axis analogue of ring/blocked attention: rays stay
    resident, scene chunks stream through, each block is two [N,3]x[3,C]
    matmuls + elementwise + a min-reduction, so peak memory is O(N*C)."""
    n = o.shape[0]
    s = prep.sphere_center.shape[0]
    # bound live [N, C] intermediates: ~6 of them per block must fit HBM
    # comfortably (a 2048 chunk at 100k rays faulted the device)
    c = min(BIG_SCENE_CHUNK, s, max(256, (1 << 25) // max(n, 1)))
    n_chunks = -(-s // c)
    pad = n_chunks * c - s
    # padding spheres can never hit: far-away center, negative radius²
    centers = jnp.concatenate(
        [prep.sphere_center, jnp.full((pad, 3), 1e30, jnp.float32)]
    ).reshape(n_chunks, c, 3)
    radius2 = jnp.concatenate(
        [prep.sphere_radius2, jnp.full((pad,), -1.0, jnp.float32)]
    ).reshape(n_chunks, c)

    d_dot_o = jnp.sum(d * o, -1, keepdims=True)
    o2 = jnp.sum(o * o, -1, keepdims=True)

    def block(carry, inputs):
        t_best, idx_best, base = carry
        cen, r2 = inputs
        d_dot_c = _mm(d, cen.T)
        o_dot_c = _mm(o, cen.T)
        cc = jnp.sum(cen * cen, -1) - r2
        b = 2.0 * (d_dot_o - d_dot_c)
        cq = o2 - 2.0 * o_dot_c + cc[None, :]
        discr = b * b - 4.0 * cq
        sq = safe_sqrt(discr)
        q = jnp.where(b < 0, (-b - sq) * 0.5, (-b + sq) * 0.5)
        t1 = cq / jnp.where(q == 0, 1.0, q)
        lo = jnp.minimum(q, t1)
        hi = jnp.maximum(q, t1)
        t = jnp.where(lo < 0, hi, lo)
        valid = (discr >= 0) & (hi >= 0) & (q != 0) & (t >= 0)
        t = jnp.where(valid, t, INF)
        t_min = jnp.min(t, axis=1)
        a_min = jnp.argmin(t, axis=1).astype(jnp.int32)
        better = t_min < t_best
        return (
            jnp.where(better, t_min, t_best),
            jnp.where(better, base + a_min, idx_best),
            base + c,
        ), None

    init = (jnp.full((n,), INF), jnp.full((n,), -1, jnp.int32), jnp.int32(0))
    (t_best, idx_best, _), _ = jax.lax.scan(block, init, (centers, radius2))
    return t_best, idx_best


def _intersect_spheres_general_chunked(prep: PreparedScene, o, d):
    """Running nearest-hit over sphere blocks for NON-rigid big scenes: the
    object-space quadratic with determinant-scaled t (Raytracer.cpp:21-51,70),
    streamed in blocks so peak memory stays O(N*C)."""
    n = o.shape[0]
    s = prep.sphere_inv3.shape[0]
    c = min(BIG_SCENE_CHUNK, s, max(256, (1 << 25) // max(n, 1)))
    n_chunks = -(-s // c)
    pad = n_chunks * c - s
    inv3 = jnp.concatenate(
        [prep.sphere_inv3, jnp.zeros((pad, 3, 3), jnp.float32)]
    ).reshape(n_chunks, c, 3, 3)
    invt = jnp.concatenate(
        [prep.sphere_invt, jnp.zeros((pad, 3), jnp.float32)]
    ).reshape(n_chunks, c, 3)
    radius2 = jnp.concatenate(
        [prep.sphere_radius2, jnp.full((pad,), -1.0, jnp.float32)]
    ).reshape(n_chunks, c)
    det = jnp.concatenate(
        [prep.sphere_det, jnp.zeros((pad,), jnp.float32)]
    ).reshape(n_chunks, c)

    def block(carry, inputs):
        t_best, idx_best, base = carry
        b_inv3, b_invt, b_r2, b_det = inputs
        o_loc = jnp.einsum("cij,nj->nci", b_inv3, o, precision=HI) + b_invt[None]
        d_loc = jnp.einsum("cij,nj->nci", b_inv3, d, precision=HI)
        a = jnp.sum(d_loc * d_loc, -1)
        b = 2.0 * jnp.sum(d_loc * o_loc, -1)
        cq = jnp.sum(o_loc * o_loc, -1) - b_r2[None]
        discr = b * b - 4.0 * a * cq
        sq = safe_sqrt(discr)
        q = jnp.where(b < 0, (-b - sq) * 0.5, (-b + sq) * 0.5)
        t0 = q / jnp.where(a == 0, 1.0, a)
        t1 = cq / jnp.where(q == 0, 1.0, q)
        lo = jnp.minimum(t0, t1)
        hi = jnp.maximum(t0, t1)
        t_loc = jnp.where(lo < 0, hi, lo)
        t = t_loc * b_det[None]
        valid = (discr >= 0) & (hi >= 0) & (a != 0) & (q != 0) & (t >= 0)
        t = jnp.where(valid, t, INF)
        t_min = jnp.min(t, axis=1)
        a_min = jnp.argmin(t, axis=1).astype(jnp.int32)
        better = t_min < t_best
        return (
            jnp.where(better, t_min, t_best),
            jnp.where(better, base + a_min, idx_best),
            base + c,
        ), None

    init = (jnp.full((n,), INF), jnp.full((n,), -1, jnp.int32), jnp.int32(0))
    (t_best, idx_best, _), _ = jax.lax.scan(block, init, (inv3, invt, radius2, det))
    return t_best, idx_best


def _sphere_tangent(n):
    """Smallest-component permutation tangent (Raytracer.cpp:55-64).

    The reference NaNs when the permuted vector degenerates to zero (normal
    exactly on a negative coordinate axis, measure-zero for jittered rays);
    we instead fall back to a perpendicular built from a safe up axis."""
    smallest = jnp.minimum(n[..., 2], jnp.minimum(n[..., 0], n[..., 1]))
    tx = jnp.stack([jnp.zeros_like(n[..., 0]), -n[..., 2], n[..., 1]], -1)
    ty = jnp.stack([-n[..., 2], jnp.zeros_like(n[..., 0]), n[..., 0]], -1)
    tz = jnp.stack([-n[..., 1], n[..., 0], jnp.zeros_like(n[..., 0])], -1)
    t = jnp.where(
        (n[..., 0] == smallest)[..., None],
        tx,
        jnp.where((n[..., 1] == smallest)[..., None], ty, tz),
    )
    norm2 = jnp.sum(t * t, axis=-1, keepdims=True)
    up = jnp.where(
        (jnp.abs(n[..., 1]) < 0.9)[..., None],
        jnp.array([0.0, 1.0, 0.0], n.dtype),
        jnp.array([1.0, 0.0, 0.0], n.dtype),
    )
    fallback = jnp.cross(n, jnp.broadcast_to(up, n.shape))
    t = jnp.where(norm2 < 1e-12, fallback, t)
    return safe_normalize(t)


def trace(prep: PreparedScene, o: jax.Array, d: jax.Array) -> SurfaceHit:
    """Nearest hit over all objects; batched equivalent of Raytracer::trace."""
    num_p = prep.plane_nrow.shape[0]
    num_s = prep.sphere_radius2.shape[0]
    if num_p + num_s == 0:  # empty scene: every ray misses
        n = o.shape[0]
        z3 = jnp.zeros((n, 3), jnp.float32)
        return SurfaceHit(
            t=jnp.full((n,), INF),
            obj=jnp.full((n,), -1, jnp.int32),
            position=o,
            normal=z3,
            tangent=z3,
            binormal=z3,
            view=d,
        )

    chunked = num_s > BIG_SCENE_THRESHOLD
    if chunked:
        # big-scene path: planes dense (P is small), spheres scanned in
        # blocks with a running nearest hit
        if num_p:
            tp, _ = _intersect_planes(prep, o, d)
            pidx = jnp.argmin(tp, axis=1).astype(jnp.int32)
            t_pl = jnp.take_along_axis(tp, pidx[:, None], axis=1)[:, 0]
        else:
            t_pl = jnp.full((o.shape[0],), INF, jnp.float32)
            pidx = jnp.zeros((o.shape[0],), jnp.int32)
        if prep.rigid:
            t_sph, sidx_best = _intersect_spheres_rigid_chunked(prep, o, d)
        else:
            t_sph, sidx_best = _intersect_spheres_general_chunked(prep, o, d)
        # planes scan first: a sphere needs a strictly smaller t to win
        sphere_wins = t_sph < t_pl
        obj = jnp.where(sphere_wins, num_p + sidx_best, pidx)
        t = jnp.where(sphere_wins, t_sph, t_pl)
        t_loc = t
        hit = jnp.isfinite(t)
    else:
        parts_t, parts_tloc = [], []
        if num_p:
            tp, tp_loc = _intersect_planes(prep, o, d)
            parts_t.append(tp)
            parts_tloc.append(tp_loc)
        if num_s:
            if prep.rigid:
                ts = _intersect_spheres_rigid(prep, o, d)
                ts_loc = ts  # det == 1: world t equals object-space t
            else:
                ts, ts_loc, o_loc, d_loc = _intersect_spheres(prep, o, d)
            parts_t.append(ts)
            parts_tloc.append(ts_loc)
        t_all = jnp.concatenate(parts_t, axis=1)
        t_loc_all = jnp.concatenate(parts_tloc, axis=1)

        obj = jnp.argmin(t_all, axis=1).astype(jnp.int32)
        t = jnp.take_along_axis(t_all, obj[:, None], axis=1)[:, 0]
        t_loc = jnp.take_along_axis(t_loc_all, obj[:, None], axis=1)[:, 0]
        hit = jnp.isfinite(t)

    is_sphere = obj >= num_p
    sidx = jnp.clip(obj - num_p, 0, max(num_s - 1, 0))

    if num_s and prep.rigid:
        # world normal = (hit point - center) / radius, normalized like the ref
        hit_pos = o + d * jnp.where(hit, t, 0.0)[:, None]
        n_sph = safe_normalize(hit_pos - prep.sphere_center[sidx])
        t_sph = _sphere_tangent(n_sph)
    elif num_s:
        if chunked:
            # no per-candidate arrays on the chunked path: recompute the
            # winner's object-space hit from its gathered transform
            inv3_w = prep.sphere_inv3[sidx]
            os_hit = jnp.einsum("nij,nj->ni", inv3_w, o, precision=HI) + prep.sphere_invt[sidx]
            ds_hit = jnp.einsum("nij,nj->ni", inv3_w, d, precision=HI)
            det_w = prep.sphere_det[sidx]
            tl = jnp.where(hit, t, 0.0) / jnp.where(det_w == 0, 1.0, det_w)
        else:
            os_hit = jnp.take_along_axis(o_loc, sidx[:, None, None], axis=1)[:, 0]
            ds_hit = jnp.take_along_axis(d_loc, sidx[:, None, None], axis=1)[:, 0]
            tl = t_loc
        n_loc = os_hit + ds_hit * tl[:, None]
        n_sph = safe_normalize(jnp.einsum("nij,nj->ni", prep.sphere_fwd3[sidx], n_loc, precision=HI))
        t_sph = _sphere_tangent(n_sph)
    else:
        n_sph = jnp.zeros_like(o)
        t_sph = jnp.zeros_like(o)

    if num_p:
        pidx = jnp.clip(obj, 0, num_p - 1)
        n_pl = prep.plane_normal[pidx]
        t_pl = prep.plane_tangent[pidx]
    else:
        n_pl = jnp.zeros_like(o)
        t_pl = jnp.zeros_like(o)

    normal = jnp.where(is_sphere[:, None], n_sph, n_pl)
    tangent = jnp.where(is_sphere[:, None], t_sph, t_pl)
    binormal = jnp.cross(normal, tangent)

    t_out = jnp.where(hit, t, INF)
    return SurfaceHit(
        t=t_out,
        obj=jnp.where(hit, obj, -1),
        position=o + d * jnp.where(hit, t, 0.0)[:, None],
        normal=jnp.where(hit[:, None], normal, 0.0),
        tangent=jnp.where(hit[:, None], tangent, 0.0),
        binormal=jnp.where(hit[:, None], binormal, 0.0),
        view=d,
    )


def light_visible(prep: PreparedScene, o, d, lobj, trace_fn=None):
    """NEE visibility: does the nearest hit along (o, d) land on light lobj?

    The reference's canReach (cpu/Shader.cpp:205-216): the shadow ray must
    FIND the light, so any strictly nearer object occludes. ``lobj`` is the
    queried light's object id per ray ([M] int32)."""
    return (trace_fn or trace)(prep, o, d).obj == lobj
