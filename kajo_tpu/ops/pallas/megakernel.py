"""Fused Pallas path-tracing megakernel (Triton route, CUDA GPUs).

The scheduler loop, the intersect/shade/sample path and the MIS weight
computation as one fused GPU kernel. Instead of ~300 XLA ops per wavefront
iteration, each round-tripping the whole ray state through device memory
(plus a host-visible loop condition per iteration), the *entire*
regenerating-wavefront loop (models/wavefront.py semantics, the same PCG4D
sample stream) runs inside a single `pallas_call(backend="triton")`:

  * the grid runs over blocks of LANES lanes (one path per lane); a block's
    state stays in registers for the whole path-tracing loop — device-memory
    traffic is one radiance write per lane per pass;
  * vec3s are component triples of [LANES] vectors;
  * the scene (spheres, planes, materials, lights, camera) is one packed
    flat f32 buffer in device memory, read with uniform scalar loads at
    static offsets (L1-cached); nearest-hit and NEE visibility are unrolled
    static loops over objects — the reference GL backend's baking of the
    scene into the shader (gl/Scene.cpp:82-192), with a fori loop above
    UNROLL_OBJECTS instead of its shader-length cap;
  * per-lane material fetch is a masked accumulation over the material
    table (one-hot select — no gathers).

There is no CPU lowering: tests run the kernel through the Pallas
interpreter inside ``interpret_mode()``.

Estimator semantics match models/wavefront.py exactly except the tangent
frame at plane hits (the frame only rotates azimuthally-symmetric sampling,
so results agree in distribution; the permutation-trick frame is used for
all surfaces here). Scope: any scene with <= MAX_KERNEL_OBJECTS objects —
rigid scenes use the 4-float world-space sphere record, general (scaled/
sheared) transforms the 23-float object-space record with determinant-scaled
hit distances and forward-rotated normals (Raytracer.cpp:21-72); the jax
wavefront engine is the fallback and the correctness spec.
"""

from __future__ import annotations

import contextlib
import contextvars
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ...models.integrator import RenderConfig
from ...ops.geometry import prepare_scene
from ...ops.rng import seed_from_key
from ...scene.types import Scene

# Lanes (paths) per program and warps per program: one or two lanes per
# thread keeps each path's ~25 loop-carried values in registers. The
# per-program while_loop runs until its slowest lane is done, so small
# blocks also waste less work on drained lanes.
LANES = 128
NUM_WARPS = 4
# Scenes with at most this many spheres get fully unrolled object loops;
# above it the kernel switches to a fori_loop with dynamic scalar loads, so
# compile time stays O(1) in the object count.
UNROLL_OBJECTS = 12
MAX_KERNEL_OBJECTS = 512
_INV24 = np.float32(1.0 / (1 << 24))
FLT_EPSILON = np.float32(1.1920928955078125e-07)
BIG = np.float32(3.0e38)
PI = np.float32(np.pi)

# packed-buffer record sizes
_PL = 8   # plane: nrow4, det, normal3
_SP = 4   # rigid sphere: cx, cy, cz, r2
# general (non-rigid) sphere: inv3 row-major (9), invt (3), r2, det,
# fwd3 row-major (9) — the reference's object-space formulation with
# determinant-scaled hit distance and forward-rotated normal
# (Raytracer.cpp:21-72)
_SPG = 23
_MA = 14  # material: diffuse3, specular3, emission3, transparency3, exp, ior
_LI = 8   # light: cx, cy, cz, radius, er, eg, eb, obj_id


# ----------------------------------------------------------- vec3 helpers
def vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vmul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def vwhere(m, a, b):
    return (jnp.where(m, a[0], b[0]), jnp.where(m, a[1], b[1]), jnp.where(m, a[2], b[2]))


def vnormalize(a):
    n2 = vdot(a, a)
    nz = n2 > 0
    inv = jax.lax.rsqrt(jnp.where(nz, n2, 1.0))
    return (
        jnp.where(nz, a[0] * inv, 0.0),
        jnp.where(nz, a[1] * inv, 0.0),
        jnp.where(nz, a[2] * inv, 0.0),
    )


def vfull(c3, like):
    return (like * 0 + c3[0], like * 0 + c3[1], like * 0 + c3[2])


def reflect(v, n):
    return vsub(v, vscale(n, 2.0 * vdot(n, v)))


@jax.custom_jvp
def safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


@safe_sqrt.defjvp
def _safe_sqrt_jvp(primals, tangents):
    # sqrt's derivative diverges at 0; the default jvp produces 0*inf = NaN
    # on the (masked) x <= 0 lanes of the forward-mode kernel. Clamp: exact
    # for x > 1e-12, zero for x <= 0, bounded at the (grazing) boundary.
    (x,), (xd,) = primals, tangents
    y = safe_sqrt(x)
    d = jnp.where(x > 0, 0.5 * jax.lax.rsqrt(jnp.maximum(x, 1e-12)), 0.0)
    return y, d * xd


@jax.custom_jvp
def safe_pow(x, n):
    m = x > 0
    return jnp.where(m, jnp.exp(n * jnp.log(jnp.where(m, x, 1.0))), jnp.where(n == 0, 1.0, 0.0))


@safe_pow.defjvp
def _safe_pow_jvp(primals, tangents):
    # d/dx = n x^(n-1), d/dn = x^n log x — written so that an underflowed
    # primal (x^100 at small x) yields 0, not 0 * inf = NaN
    (x, n), (xd, nd) = primals, tangents
    y = safe_pow(x, n)
    m = x > 0
    xs = jnp.where(m, x, 1.0)
    dx = jnp.where(m, n * safe_pow(x, n - 1.0), 0.0)
    dn = jnp.where(m, y * jnp.log(xs), 0.0)
    return y, dx * xd + dn * nd


# ----------------------------------------------------------------- PCG4D
def _pcg4d(a, b, c, d):
    u = jnp.uint32
    x = a * u(1664525) + u(1013904223)
    y = b * u(1664525) + u(1013904223)
    z = c * u(1664525) + u(1013904223)
    w = d * u(1664525) + u(1013904223)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return x, y, z, w


def _unit(u):
    # the top-24-bit value is positive, so the signed convert is exact
    return jax.lax.bitcast_convert_type(u >> 8, jnp.int32).astype(jnp.float32) * _INV24


def _uniforms4(lane, sample, salt, seed):
    a, b, c, d = _pcg4d(lane, sample, salt, seed)
    return _unit(a), _unit(b), _unit(c), _unit(d)


def _pack_scene(prep) -> jnp.ndarray:
    """Flatten the prepared scene into one flat f32 buffer [F].

    Layout: planes (P x _PL) | spheres (S x _SP) | materials (K x _MA) |
    lights (L x _LI) | background (3) | camera (12: origin, p1, du, dv)."""
    parts = []
    p = prep.plane_nrow.shape[0]
    if p:
        parts.append(
            jnp.concatenate(
                [prep.plane_nrow, prep.plane_det[:, None], prep.plane_normal], axis=1
            ).reshape(-1)
        )
    s = prep.sphere_center.shape[0]
    if s and prep.rigid:
        parts.append(
            jnp.concatenate([prep.sphere_center, prep.sphere_radius2[:, None]], axis=1).reshape(-1)
        )
    elif s:
        parts.append(
            jnp.concatenate(
                [
                    prep.sphere_inv3.reshape(s, 9),
                    prep.sphere_invt,
                    prep.sphere_radius2[:, None],
                    prep.sphere_det[:, None],
                    prep.sphere_fwd3.reshape(s, 9),
                ],
                axis=1,
            ).reshape(-1)
        )
    m = prep.materials
    parts.append(
        jnp.concatenate(
            [
                m.diffuse[:, :3],
                m.specular[:, :3],
                m.emission[:, :3],
                m.transparency[:, :3],
                m.specular_exponent[:, None],
                m.refractive_index[:, None],
            ],
            axis=1,
        ).reshape(-1)
    )
    l = prep.light_obj.shape[0]
    if l:
        parts.append(
            jnp.concatenate(
                [
                    prep.light_center,
                    prep.light_radius[:, None],
                    prep.light_emission[:, :3],
                    prep.light_obj[:, None].astype(jnp.float32),
                ],
                axis=1,
            ).reshape(-1)
        )
    parts.append(prep.background[:3])
    cam = prep.camera
    parts.append(jnp.concatenate([cam.origin, cam.p1, cam.du, cam.dv]))
    return jnp.concatenate(parts)


def _sphere_hit_general(rec, o, d):
    """General-transform sphere hit: object-space stable quadratic with
    determinant-scaled t (Raytracer.cpp:21-51,70) and the reference's
    normal convention — object-space hit point rotated by the FORWARD
    matrix, then normalized (Raytracer.cpp:52-54).

    ``rec``: 23 per-sphere scalars (inv3 row-major, invt, r2, det, fwd3
    row-major); ``o``/``d`` world-space ray component triples.
    Returns (t_world, valid, world_normal)."""
    ox = rec[0] * o[0] + rec[1] * o[1] + rec[2] * o[2] + rec[9]
    oy = rec[3] * o[0] + rec[4] * o[1] + rec[5] * o[2] + rec[10]
    oz = rec[6] * o[0] + rec[7] * o[1] + rec[8] * o[2] + rec[11]
    dx = rec[0] * d[0] + rec[1] * d[1] + rec[2] * d[2]
    dy = rec[3] * d[0] + rec[4] * d[1] + rec[5] * d[2]
    dz = rec[6] * d[0] + rec[7] * d[1] + rec[8] * d[2]
    r2, det = rec[12], rec[13]
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (dx * ox + dy * oy + dz * oz)
    cq = ox * ox + oy * oy + oz * oz - r2
    discr = b * b - 4.0 * a * cq
    sq = safe_sqrt(discr)
    q = jnp.where(b < 0, (-b - sq) * 0.5, (-b + sq) * 0.5)
    t0 = q / jnp.where(a == 0, 1.0, a)
    t1 = cq / jnp.where(q == 0, 1.0, q)
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    t_loc = jnp.where(lo < 0, hi, lo)
    t = t_loc * det
    valid = (discr >= 0) & (hi >= 0) & (a != 0) & (q != 0) & (t >= 0)
    nl = (ox + dx * t_loc, oy + dy * t_loc, oz + dz * t_loc)
    n = vnormalize(
        (
            rec[14] * nl[0] + rec[15] * nl[1] + rec[16] * nl[2],
            rec[17] * nl[0] + rec[18] * nl[1] + rec[19] * nl[2],
            rec[20] * nl[0] + rec[21] * nl[1] + rec[22] * nl[2],
        )
    )
    return t, valid, n


def _build_kernel(
    width, height, grid_n, eff, config: RenderConfig, P, S, L, jvp=False, rigid=True
):
    if config.gl_semantics:
        raise ValueError(
            "gl_semantics is implemented by the wavefront/parity engines, "
            "not the fused megakernel — render with engine='fast'"
        )
    K = P + S
    lanes = LANES
    max_depth = config.max_depth
    eps = np.float32(config.surface_epsilon)
    emit_after_scatter = bool((not config.direct_lighting) or config.full_mis)
    nee_on = bool(config.direct_lighting and L > 0)
    # one-of-L light sampling (see integrator.RenderConfig.one_light_nee):
    # one shadow trace per vertex, term scaled by L — unbiased, same uniform
    # budget as all-lights for L > 1 (max(5+3L, 9) == 5+3L), so the PCG4D
    # stream is identical to the wavefront's one-light path
    one_light = bool(config.one_light_nee and L > 1)
    ncalls = -(-max(5 + 3 * L, 9 if one_light else 0) // 4)
    CAM_SALT = np.uint32(0x7FFFFFFF)
    SPF = _SP if rigid else _SPG  # per-sphere record size
    off_planes = 0
    off_spheres = off_planes + P * _PL
    off_mats = off_spheres + S * SPF
    off_lights = off_mats + K * _MA
    off_bg = off_lights + L * _LI
    off_cam = off_bg + 3
    fgrid = np.float32(grid_n)
    fw = np.float32(width)
    fh = np.float32(height)

    def kernel(seed_ref, scn_ref, *refs):
        if jvp:
            tan_ref, *out_refs = refs
        else:
            out_refs = refs
        seed = seed_ref[0]
        # global lane offset of this kernel invocation: 0 unsharded, or the
        # device's block start under shard_map — lane ids (and therefore the
        # PCG4D streams and pixel assignment) are global either way, so a
        # sharded render is bit-identical to the unsharded one
        lane0 = seed_ref[1].astype(jnp.int32)
        lane_i = lane0 + pl.program_id(0) * lanes + jax.lax.broadcasted_iota(
            jnp.int32, (lanes,), 0
        )
        lane = lane_i.astype(jnp.uint32)
        in_image = lane_i < width * height
        # lax.rem/div: the Triton lowering of jnp's floor-mod/-div fails on
        # int32 vectors, and lane ids are non-negative so truncation is exact
        px = jax.lax.rem(lane_i, np.int32(width)).astype(jnp.float32)
        py = jax.lax.div(lane_i, np.int32(width)).astype(jnp.float32)
        zf = px * 0.0
        zi = lane_i * 0

        # the whole path-tracing loop as a pure function of the packed scene
        # scalars: the primal kernel calls it directly on lazy scalar loads;
        # the forward-mode kernel differentiates it with jax.jvp (tangents
        # of the full scene-parameter vector ride along every hit, pdf and
        # MIS weight — geometry gradients at kernel speed)
        def run(s_):
            origin0 = (s_(off_cam), s_(off_cam + 1), s_(off_cam + 2))
            p1 = (s_(off_cam + 3), s_(off_cam + 4), s_(off_cam + 5))
            du = (s_(off_cam + 6), s_(off_cam + 7), s_(off_cam + 8))
            dv = (s_(off_cam + 9), s_(off_cam + 10), s_(off_cam + 11))
            bg = (s_(off_bg), s_(off_bg + 1), s_(off_bg + 2))

            def plane_rec(i):
                b = off_planes + i * _PL
                return [s_(b + j) for j in range(_PL)]

            def sphere_rec(i):
                b = off_spheres + i * SPF
                return [s_(b + j) for j in range(SPF)]

            def mat_rec(i):
                b = off_mats + i * _MA
                return [s_(b + j) for j in range(_MA)]

            def light_rec(i):
                b = off_lights + i * _LI
                return [s_(b + j) for j in range(_LI)]

            def camera_ray(sample):
                su = sample.astype(jnp.uint32)
                gx = jax.lax.rem(sample, np.int32(grid_n)).astype(jnp.float32)
                gy = jax.lax.div(sample, np.int32(grid_n)).astype(jnp.float32)
                u1, u2, _, _ = _uniforms4(lane, su, CAM_SALT, seed)
                sx = (px + (gx + u1) / fgrid) / fw
                sy = ((fh - py) + (gy + u2) / fgrid) / fh
                d = vnormalize(vsub(vadd(vfull(p1, zf), vadd(vscale(vfull(du, zf), sx), vscale(vfull(dv, zf), sy))), vfull(origin0, zf)))
                return vfull(origin0, zf), d

            def trace(o, d):
                """Nearest hit via unrolled object scan -> (t, obj, normal)."""
                t_best = zf + BIG
                obj_best = zi - 1
                n_best = (zf, zf, zf)
                for i in range(P):
                    r = plane_rec(i)
                    denom = d[0] * r[0] + d[1] * r[1] + d[2] * r[2]
                    onum = o[0] * r[0] + o[1] * r[1] + o[2] * r[2] + r[3]
                    t_loc = -onum / jnp.where(denom == 0, 1.0, denom)
                    t = t_loc * r[4]
                    valid = (jnp.abs(denom) >= FLT_EPSILON) & (t_loc >= 0) & (t >= 0) & (t < t_best)
                    t_best = jnp.where(valid, t, t_best)
                    obj_best = jnp.where(valid, i, obj_best)
                    n_best = vwhere(valid, vfull((r[5], r[6], r[7]), zf), n_best)
                if not rigid:
                    # general transforms: object-space quadratic + det-scaled
                    # t + fwd3-rotated normal, per sphere (no world-space
                    # shortcut exists — each sphere has its own ray transform)
                    if S <= UNROLL_OBJECTS:
                        for i in range(S):
                            t, valid, n_new = _sphere_hit_general(sphere_rec(i), o, d)
                            valid = valid & (t < t_best)
                            t_best = jnp.where(valid, t, t_best)
                            obj_best = jnp.where(valid, P + i, obj_best)
                            n_best = vwhere(valid, n_new, n_best)
                        return t_best, obj_best, n_best

                    def sphere_step_g(i, carry):
                        t_best, obj_best, n0, n1, n2 = carry
                        base = off_spheres + i * SPF
                        rec = [s_(base + j) for j in range(SPF)]
                        t, valid, n_new = _sphere_hit_general(rec, o, d)
                        valid = valid & (t < t_best)
                        return (
                            jnp.where(valid, t, t_best),
                            jnp.where(valid, P + i, obj_best),
                            jnp.where(valid, n_new[0], n0),
                            jnp.where(valid, n_new[1], n1),
                            jnp.where(valid, n_new[2], n2),
                        )

                    t_best, obj_best, n0, n1, n2 = jax.lax.fori_loop(
                        0, S, sphere_step_g, (t_best, obj_best, n_best[0], n_best[1], n_best[2])
                    )
                    return t_best, obj_best, (n0, n1, n2)

                d_dot_o = vdot(d, o)
                o2 = vdot(o, o)
                if S <= UNROLL_OBJECTS:
                    for i in range(S):
                        cx, cy, cz, r2 = sphere_rec(i)
                        d_dot_c = d[0] * cx + d[1] * cy + d[2] * cz
                        o_dot_c = o[0] * cx + o[1] * cy + o[2] * cz
                        b = 2.0 * (d_dot_o - d_dot_c)
                        cq = o2 - 2.0 * o_dot_c + (cx * cx + cy * cy + cz * cz - r2)
                        discr = b * b - 4.0 * cq
                        sq = safe_sqrt(discr)
                        q = jnp.where(b < 0, (-b - sq) * 0.5, (-b + sq) * 0.5)
                        t1 = cq / jnp.where(q == 0, 1.0, q)
                        lo = jnp.minimum(q, t1)
                        hi = jnp.maximum(q, t1)
                        t = jnp.where(lo < 0, hi, lo)
                        valid = (discr >= 0) & (hi >= 0) & (q != 0) & (t >= 0) & (t < t_best)
                        t_best = jnp.where(valid, t, t_best)
                        obj_best = jnp.where(valid, P + i, obj_best)
                        n_new = vnormalize(vsub(vadd(o, vscale(d, t)), vfull((cx, cy, cz), zf)))
                        n_best = vwhere(valid, n_new, n_best)
                    return t_best, obj_best, n_best

                def sphere_step(i, carry):
                    # dynamic scalar loads keep the kernel size O(1) in the
                    # object count; via s_ so the jvp kernel's dual
                    # injection reaches dynamic reads too
                    t_best, obj_best, n0, n1, n2 = carry
                    base = off_spheres + i * _SP
                    cx = s_(base)
                    cy = s_(base + 1)
                    cz = s_(base + 2)
                    r2 = s_(base + 3)
                    d_dot_c = d[0] * cx + d[1] * cy + d[2] * cz
                    o_dot_c = o[0] * cx + o[1] * cy + o[2] * cz
                    b = 2.0 * (d_dot_o - d_dot_c)
                    cq = o2 - 2.0 * o_dot_c + (cx * cx + cy * cy + cz * cz - r2)
                    discr = b * b - 4.0 * cq
                    sq = safe_sqrt(discr)
                    q = jnp.where(b < 0, (-b - sq) * 0.5, (-b + sq) * 0.5)
                    t1 = cq / jnp.where(q == 0, 1.0, q)
                    lo = jnp.minimum(q, t1)
                    hi = jnp.maximum(q, t1)
                    t = jnp.where(lo < 0, hi, lo)
                    valid = (discr >= 0) & (hi >= 0) & (q != 0) & (t >= 0) & (t < t_best)
                    n_new = vnormalize(vsub(vadd(o, vscale(d, t)), vfull((cx, cy, cz), zf)))
                    return (
                        jnp.where(valid, t, t_best),
                        jnp.where(valid, P + i, obj_best),
                        jnp.where(valid, n_new[0], n0),
                        jnp.where(valid, n_new[1], n1),
                        jnp.where(valid, n_new[2], n2),
                    )

                t_best, obj_best, n0, n1, n2 = jax.lax.fori_loop(
                    0, S, sphere_step, (t_best, obj_best, n_best[0], n_best[1], n_best[2])
                )
                return t_best, obj_best, (n0, n1, n2)

            def tangent_frame(n):
                smallest = jnp.minimum(n[2], jnp.minimum(n[0], n[1]))
                mx = n[0] == smallest
                my = n[1] == smallest
                t = vwhere(mx, (zf, -n[2], n[1]), vwhere(my, (-n[2], zf, n[0]), (-n[1], n[0], zf)))
                up = vwhere(jnp.abs(n[1]) < 0.9, vfull((0.0, 1.0, 0.0), zf), vfull((1.0, 0.0, 0.0), zf))
                t = vwhere(vdot(t, t) < 1e-12, vcross(n, up), t)
                t = vnormalize(t)
                return t, vcross(n, t)

            def gather_mat(obj):
                if K <= UNROLL_OBJECTS + 8:  # kajo scenes: 11 spheres+planes -> 11..17 mats
                    fields = [zf] * _MA
                    for k in range(K):
                        rec = mat_rec(k)
                        m = (obj == k).astype(jnp.float32)
                        for f in range(_MA):
                            fields[f] = fields[f] + m * rec[f]
                    return fields

                def mat_step(k, fields):
                    base = off_mats + k * _MA
                    m = (obj == k).astype(jnp.float32)
                    return tuple(fields[f] + m * s_(base + f) for f in range(_MA))

                return list(jax.lax.fori_loop(0, K, mat_step, tuple([zf] * _MA)))

            def solid_angle(dist, rad):
                x = jnp.clip(rad / jnp.maximum(dist, 1e-30), 0.0, 1.0)
                # x²/(1+sqrt(1-x²)) == 1-sqrt(1-x²) without the cancellation
                # that rounds Ω to exactly 0 for far-grazing x (< ~2e-4),
                # whose 1/Ω pdf then NaNs every jvp (see ops/lights.py)
                omega = 2.0 * PI * (x * x) / (1.0 + safe_sqrt(1.0 - x * x))
                return jnp.where(dist < rad, 4.0 * PI, omega)

            def light_pdf_from(pos, prev_obj, hit_obj):
                pdf = zf
                for li in range(L):
                    r = light_rec(li)
                    delta = vsub(vfull((r[0], r[1], r[2]), zf), pos)
                    dist = safe_sqrt(vdot(delta, delta))
                    obj_id = jnp.int32(0) + r[7].astype(jnp.int32)
                    ok = (hit_obj == obj_id) & (prev_obj != obj_id)
                    pdf = pdf + jnp.where(ok, 1.0 / solid_angle(dist, r[3]), 0.0)
                return pdf

            def init_state():
                sample = jnp.where(in_image, 0, eff)
                o, d = camera_ray(sample * 0)
                one = zf + 1.0
                return (
                    sample, zi,
                    o[0], o[1], o[2], d[0], d[1], d[2],
                    one, one, one,          # throughput
                    zf, zf, zf,             # radiance
                    zi + 1,                 # emit
                    zi,                     # mis_pending
                    one,                    # pend_pdf_b
                    one, one, one,          # pend_fcos
                    zi,                     # pend_delta
                    zi - 1,                 # prev_obj
                    zf, zf, zf,             # prev_pos
                )

            def cond(st):
                # a max-reduce: the Triton lowering has no reduce_or
                return jnp.max((st[0] < eff).astype(jnp.int32)) > 0

            def body(st):
                (sample, depth, ox, oy, oz, dx, dy, dz, tr, tg, tb, ra, rg, rb,
                 emit_f, misp_f, ppdf, pfr, pfg, pfb, pdelta_f, prev_obj,
                 qx, qy, qz) = st
                o = (ox, oy, oz)
                d = (dx, dy, dz)
                t3 = (tr, tg, tb)
                r3 = (ra, rg, rb)
                active = sample < eff
                su = sample.astype(jnp.uint32)
                salt0 = depth.astype(jnp.uint32) * jnp.uint32(ncalls)
                us = []
                for i in range(ncalls):
                    us.extend(_uniforms4(lane, su, salt0 + jnp.uint32(i), seed))

                t_hit, obj, normal = trace(o, d)
                was_hit = obj >= 0
                pos_hit = vadd(o, vscale(d, jnp.where(was_hit, t_hit, 0.0)))

                # deferred MIS weight from the previous vertex
                pdf_l_vis = light_pdf_from((qx, qy, qz), prev_obj, obj) if L else zf
                if config.full_mis:
                    pdf_l_vis = jnp.where(pdelta_f > 0, 0.0, pdf_l_vis)
                denom = pdf_l_vis + ppdf
                w = 1.0 / jnp.where(denom == 0, 1.0, denom)
                apply_w = (misp_f > 0) & active
                t3 = vwhere(apply_w, vmul(t3, vscale((pfr, pfg, pfb), w)), t3)

                # miss -> background, path ends via ~was_hit below
                miss = active & ~was_hit
                r3 = vwhere(miss, vadd(r3, vmul(t3, vfull(bg, zf))), r3)
                on_path = active & was_hit

                mats = gather_mat(jnp.maximum(obj, 0))
                md = (mats[0], mats[1], mats[2])
                ms = (mats[3], mats[4], mats[5])
                me = (mats[6], mats[7], mats[8])
                mt = (mats[9], mats[10], mats[11])
                mexp = mats[12]
                mior = mats[13]

                # Russian roulette (+ depth limit)
                p_rr = jnp.maximum(
                    jnp.maximum(jnp.maximum(md[0], ms[0]), jnp.maximum(md[1], ms[1])),
                    jnp.maximum(
                        jnp.maximum(md[2], ms[2]),
                        jnp.maximum(jnp.maximum(mt[0], mt[1]), mt[2]),
                    ),
                )
                cont = (p_rr > 0) & (us[0] <= p_rr)
                # coin probabilities are DETACHED (stop_gradient), matching
                # the jax engines' unbiased convention (wavefront.py
                # flip_coin calls): under the in-kernel jax.jvp, material
                # tangents must not produce d(1/prob) terms — the discrete
                # coin outcome can't carry a derivative, so differentiating
                # its compensation factor alone would bias the estimate
                prob_rr = jax.lax.stop_gradient(jnp.where(cont, p_rr, 1.0 - p_rr))
                t3 = vwhere(on_path, vscale(t3, 1.0 / prob_rr), t3)
                tk = t3
                emitter = on_path & (emit_f > 0)
                survive = on_path & cont & (depth < max_depth)

                # BSDF lottery
                sum_d = md[0] + md[1] + md[2]
                sum_s = ms[0] + ms[1] + ms[2]
                sum_t = mt[0] + mt[1] + mt[2]
                total = sum_d + sum_s + sum_t
                p_t = jnp.where(total > 0, sum_t / jnp.where(total == 0, 1.0, total), 0.0)
                transmit = (p_t > 0) & (us[1] <= p_t)
                prob_t = jax.lax.stop_gradient(jnp.where(transmit, p_t, 1.0 - p_t))
                t3 = vwhere(survive, vscale(t3, 1.0 / prob_t), t3)
                dsum = sum_d + sum_s
                p_d = jnp.where(dsum > 0, sum_d / jnp.where(dsum == 0, 1.0, dsum), 0.0)
                diffc = (p_d > 0) & (us[2] <= p_d)
                prob_d = jax.lax.stop_gradient(jnp.where(diffc, p_d, 1.0 - p_d))
                t3 = vwhere(survive & ~transmit, vscale(t3, 1.0 / prob_d), t3)

                m_trans = survive & transmit
                m_lam = survive & ~transmit & diffc
                m_ph = survive & ~transmit & ~diffc & (mexp > 0)
                m_mir = survive & ~transmit & ~diffc & (mexp <= 0)
                scatter = m_lam | m_ph | m_mir

                view = d
                tangent, binormal = tangent_frame(normal)
                refl = reflect(view, normal)

                # NEE over lights
                if nee_on:

                    def nee_light(r, u1, u2, u3, scale):
                        # one light's NEE term: solid-angle sample, shadow
                        # trace, per-light MIS weight scale/(pdf_b + pdf_l).
                        # ``r`` fields may be scalars (per-light loop) or
                        # [LANES] arrays (one-hot-selected record)
                        rad = r[3]
                        sx_ = rad * jnp.sqrt(u1) * jnp.cos(2.0 * PI * u2)
                        sy_ = rad * jnp.sqrt(u1) * jnp.sin(2.0 * PI * u2)
                        sz_ = safe_sqrt(rad * rad - sx_ * sx_ - sy_ * sy_) * jnp.sin(PI * (u3 - 0.5))
                        c = vfull((r[0], r[1], r[2]), zf)
                        dl = vnormalize(vsub(vadd(c, (sx_, sy_, sz_)), pos_hit))
                        delta = vsub(c, pos_hit)
                        dist = safe_sqrt(vdot(delta, delta))
                        pdf_l = 1.0 / solid_angle(dist, rad)
                        _, st_obj, _ = trace(vadd(pos_hit, vscale(dl, eps)), dl)
                        obj_id = jnp.int32(0) + r[7].astype(jnp.int32)
                        visible = st_obj == obj_id
                        not_self = obj != obj_id
                        cosl = vdot(normal, dl)
                        lobe_l = (mexp + 1.0) / (2.0 * PI) * safe_pow(jnp.maximum(vdot(refl, dl), 0.0), mexp)
                        pdf_b_l = jnp.where(m_lam, cosl / PI, jnp.where(m_ph, lobe_l, 0.0))
                        fcos_l = vwhere(
                            m_lam,
                            vscale(md, jnp.maximum(cosl, 0.0) / PI),
                            vwhere(
                                m_ph,
                                vscale(ms, lobe_l * jnp.maximum(cosl, 0.0)),
                                (zf, zf, zf),
                            ),
                        )
                        ok = visible & not_self & (pdf_b_l != 0) & (pdf_l > 0)
                        wl = jnp.where(ok, scale / (pdf_b_l + pdf_l), 0.0)
                        return vscale(vmul(fcos_l, vfull((r[4], r[5], r[6]), zf)), wl)

                    if one_light:
                        # uniformly pick one light per lane (wavefront
                        # _nee3_one_light): us[5] selects, us[6:9] sample;
                        # the record is gathered by one-hot accumulation
                        li_v = jnp.minimum(
                            (us[5] * np.float32(L)).astype(jnp.int32), L - 1
                        )
                        rec = [zf] * _LI
                        for li in range(L):
                            r = light_rec(li)
                            m = (li_v == li).astype(jnp.float32)
                            rec = [rec[f] + m * r[f] for f in range(_LI)]
                        nee = nee_light(rec, us[6], us[7], us[8], np.float32(L))
                    else:
                        nee = (zf, zf, zf)
                        for li in range(L):
                            nee = vadd(
                                nee,
                                nee_light(
                                    light_rec(li),
                                    us[5 + 3 * li],
                                    us[6 + 3 * li],
                                    us[7 + 3 * li],
                                    np.float32(1.0),
                                ),
                            )
                    r3 = vwhere(scatter, vadd(r3, vmul(t3, nee)), r3)

                # continuation sample
                u1, u2 = us[3], us[4]
                # transmission
                cos_a = vdot(view, normal)
                entering = cos_a < 0
                n_eff = vwhere(entering, normal, vscale(normal, -1.0))
                eta = jnp.where(entering, 1.0 / mior, mior)
                ci = vdot(view, n_eff)
                kk = 1.0 - eta * eta * (1.0 - ci * ci)
                refr = vsub(vscale(view, eta), vscale(n_eff, eta * ci + safe_sqrt(kk)))
                d_trans = vwhere(kk < 0, reflect(view, n_eff), refr)
                # lambert (cosine hemisphere in the surface frame)
                rl = jnp.sqrt(u1)
                phi = u2 * 2.0 * PI
                lz = safe_sqrt(1.0 - u1)
                d_lam = vadd(
                    vadd(vscale(tangent, rl * jnp.cos(phi)), vscale(binormal, rl * jnp.sin(phi))),
                    vscale(normal, lz),
                )
                pdf_lam = lz / PI
                # phong lobe about the reflection
                zax = vfull((0.0, 0.0, 1.0), zf)
                uax = vcross(zax, refl)
                degen = vdot(uax, uax) < 1e-12
                uax = vnormalize(vwhere(degen, vcross(vfull((0.0, 1.0, 0.0), zf), refl), uax))
                vax = vcross(uax, refl)
                cos_ph = safe_pow(u1, 1.0 / (mexp + 1.0))
                sin_ph = safe_sqrt(1.0 - cos_ph * cos_ph)
                d_ph = vadd(
                    vadd(vscale(uax, sin_ph * jnp.cos(phi)), vscale(vax, sin_ph * jnp.sin(phi))),
                    vscale(refl, cos_ph),
                )
                pdf_ph = (mexp + 1.0) / (2.0 * PI) * safe_pow(cos_ph, mexp)

                new_d = vwhere(m_trans, d_trans, vwhere(m_lam, d_lam, vwhere(m_ph, d_ph, refl)))
                pdf_b = jnp.where(m_lam, pdf_lam, jnp.where(m_ph, pdf_ph, 1.0))
                cos_nd = vdot(normal, new_d)
                lobe_c = (mexp + 1.0) / (2.0 * PI) * safe_pow(jnp.maximum(vdot(refl, d_ph), 0.0), mexp)
                fcos = vwhere(
                    m_trans,
                    ms,
                    vwhere(
                        m_lam,
                        vscale(md, jnp.maximum(cos_nd, 0.0) / PI),
                        vwhere(
                            m_ph,
                            vscale(ms, lobe_c * jnp.maximum(cos_nd, 0.0)),
                            vwhere(cos_nd > 0, ms, (zf, zf, zf)),
                        ),
                    ),
                )

                t3 = vwhere(m_trans, vmul(t3, fcos), t3)
                r3 = vwhere(emitter, vadd(r3, vmul(vwhere(survive, t3, tk), me)), r3)
                continuing = survive & (m_trans | (pdf_b != 0))
                if config.regen_threshold > 0.0:
                    # GL-backend throughput culling (gl/SurfaceShader.cpp:88-93);
                    # see models/wavefront.py for the semantics note
                    tmax = jnp.maximum(jnp.maximum(t3[0], t3[1]), t3[2])
                    continuing = continuing & (tmax >= np.float32(config.regen_threshold))

                # regeneration
                path_end = active & ~continuing
                new_sample = jnp.where(path_end, sample + 1, sample)
                o_cam, d_cam = camera_ray(jnp.minimum(new_sample, eff - 1))
                new_o = vwhere(continuing, vadd(pos_hit, vscale(new_d, eps)), vwhere(path_end, o_cam, o))
                new_dir = vwhere(continuing, new_d, vwhere(path_end, d_cam, d))
                t3 = vwhere(path_end, vfull((1.0, 1.0, 1.0), zf), t3)
                sc = scatter & ~path_end
                return (
                    new_sample,
                    jnp.where(path_end, 0, depth + 1),
                    new_o[0], new_o[1], new_o[2], new_dir[0], new_dir[1], new_dir[2],
                    t3[0], t3[1], t3[2], r3[0], r3[1], r3[2],
                    jnp.where(path_end, 1, jnp.where(scatter, jnp.int32(emit_after_scatter), emit_f)),
                    jnp.where(sc, 1, 0).astype(jnp.int32),
                    jnp.where(sc, pdf_b, 1.0),
                    jnp.where(sc, fcos[0], 1.0),
                    jnp.where(sc, fcos[1], 1.0),
                    jnp.where(sc, fcos[2], 1.0),
                    jnp.where(m_mir & ~path_end, 1, 0).astype(jnp.int32),
                    jnp.where(sc, obj, -1),
                    jnp.where(sc, pos_hit[0], 0.0),
                    jnp.where(sc, pos_hit[1], 0.0),
                    jnp.where(sc, pos_hit[2], 0.0),
                )

            final = jax.lax.while_loop(cond, body, init_state())
            return final[11], final[12], final[13]

        if jvp:
            # dual-scalar injection: e has primal 0 / tangent 1, so every
            # scene read v + e * v_tan carries (v, v_tan) through jax.jvp —
            # INCLUDING dynamic-index reads inside fori object/material
            # loops (a Python list of eager reads can't be indexed by a
            # traced loop counter), so the forward-mode kernel scales to
            # MAX_KERNEL_OBJECTS like the primal
            rgb, rgb_dot = jax.jvp(
                lambda e: run(lambda i: scn_ref[i] + e * tan_ref[i]),
                (jnp.float32(0.0),),
                (jnp.float32(1.0),),
            )
            outs = (*rgb, *rgb_dot)
        else:
            outs = run(lambda i: scn_ref[i])
        # one output per channel: a (3, LANES) block is not a power of two
        for ref, v in zip(out_refs, outs):
            ref[...] = v

    return kernel


_INTERPRET = contextvars.ContextVar("kajo_megakernel_interpret", default=False)


@contextlib.contextmanager
def interpret_mode():
    """Run the megakernel through the Pallas interpreter inside this block.

    The kernel is compiled for CUDA GPUs only; tests and CPU cross-checks
    opt in to the interpreter here. Nothing turns it on implicitly."""
    token = _INTERPRET.set(True)
    try:
        yield
    finally:
        _INTERPRET.reset(token)


def available() -> bool:
    """Whether the kernel can run here: on a GPU, or inside interpret_mode()."""
    return _INTERPRET.get() or jax.default_backend() == "gpu"


def supports(scene: Scene) -> bool:
    """Rigid AND general (scaled/sheared) transforms are supported: rigid
    scenes use the 4-float world-space record, general scenes the 23-float
    object-space record (det-scaled t, fwd3-rotated normals)."""
    return bool(scene.num_objects <= MAX_KERNEL_OBJECTS and scene.num_objects > 0)


def _kernel_for(scene: Scene, rigid: bool, width, height, spp, config, jvp=False):
    """(kernel, divisor): the fused pass kernel and its sample normalization."""
    grid_n = max(int(spp**0.5), 1)
    eff = grid_n * grid_n
    kernel = _build_kernel(
        width, height, grid_n, eff, config,
        scene.num_planes, scene.num_spheres, scene.num_lights, jvp=jvp, rigid=rigid,
    )
    return kernel, float(spp if config.kajo_spp_quirk else eff)


def _n_blocks(n_lanes: int) -> int:
    return -(-n_lanes // LANES)


def _mega_call(kernel, n_blocks, interpret, seedbuf, *scene_bufs, n_out=3):
    """Launch ``kernel`` over ``n_blocks`` lane blocks -> n_out [n_blocks *
    LANES] channel arrays. Inputs are whole flat buffers (uniform scalar
    loads); each program writes its own LANES-wide slice of every output."""
    n_pad = n_blocks * LANES
    out = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((n_pad,), jnp.float32)] * n_out,
        grid=(n_blocks,),
        in_specs=[pl.no_block_spec] * (1 + len(scene_bufs)),
        out_specs=[pl.BlockSpec((LANES,), lambda i: (i,))] * n_out,
        backend="triton",
        # num_stages=1: the loops hold no tile loads for Triton to pipeline
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="kajo_megakernel",
    )(seedbuf, *scene_bufs)
    return tuple(out)


def _to_image(channels, width, height, divisor, alpha):
    n = width * height
    rgb = jnp.stack([c[:n] for c in channels], axis=1) / divisor
    img = jnp.concatenate([rgb, jnp.full((n, 1), alpha, jnp.float32)], axis=1)
    return img.reshape(height, width, 4)


def _seedbuf(key, lane0=0):
    seed = jnp.asarray(seed_from_key(key), jnp.uint32).reshape(())
    return jnp.stack([seed, jnp.asarray(lane0, jnp.uint32)])


def render_pass_megakernel(
    scene: Scene,
    key: jax.Array,
    width: int,
    height: int,
    spp: int,
    config: RenderConfig = RenderConfig(),
) -> jax.Array:
    """One progressive pass in a single fused kernel -> [H, W, 4]."""
    return _render_pass(scene, key, width, height, spp, config, _INTERPRET.get())


@partial(jax.jit, static_argnames=("width", "height", "spp", "config", "interpret"))
def _render_pass(scene, key, width, height, spp, config, interpret):
    prep = prepare_scene(scene)
    kernel, divisor = _kernel_for(scene, prep.rigid, width, height, spp, config)
    out = _mega_call(
        kernel, _n_blocks(width * height), interpret, _seedbuf(key), _pack_scene(prep)
    )
    return _to_image(out, width, height, divisor, 1.0)


def render_pass_megakernel_jvp(
    scene: Scene,
    scene_tangent: Scene,
    key: jax.Array,
    width: int,
    height: int,
    spp: int,
    config: RenderConfig = RenderConfig(),
):
    """Forward-mode megakernel: (image, d image/dε) in ONE fused kernel.

    ``scene_tangent`` is a Scene pytree of tangents (zeros except the
    perturbed leaves — e.g. a sphere center direction). The scene packing
    (prepare_scene + _pack_scene) is differentiated by XLA outside the
    kernel; inside, jax.jvp threads the tangents through the entire
    path-tracing loop — hit distances, normals, sampled directions, pdfs
    and MIS weights all carry derivatives, with the discrete coin
    probabilities detached exactly like the jax engines. Any scene size up
    to MAX_KERNEL_OBJECTS: the dual-scalar injection (see _build_kernel's
    jvp branch) threads tangents through the dynamic-load fori loops too.
    """
    return _render_pass_jvp(
        scene, scene_tangent, key, width, height, spp, config, _INTERPRET.get()
    )


@partial(jax.jit, static_argnames=("width", "height", "spp", "config", "interpret"))
def _render_pass_jvp(scene, scene_tangent, key, width, height, spp, config, interpret):
    kernel, divisor = _kernel_for(
        scene, bool(getattr(scene, "rigid_spheres", False)), width, height, spp,
        config, jvp=True,
    )
    packed, packed_dot = jax.jvp(
        lambda s: _pack_scene(prepare_scene(s)), (scene,), (scene_tangent,)
    )
    out = _mega_call(
        kernel, _n_blocks(width * height), interpret, _seedbuf(key), packed, packed_dot,
        n_out=6,
    )
    img = _to_image(out[:3], width, height, divisor, 1.0)
    img_dot = _to_image(out[3:], width, height, divisor, 0.0)
    return img, img_dot


def scene_zero_tangent(scene: Scene) -> Scene:
    """A Scene tangent pytree of zeros for render_pass_megakernel_jvp; set
    the perturbed leaves with dataclasses.replace / .at[] updates. (All
    Scene data leaves are float arrays; light_indices/rigid are static
    metadata carried over by tree.map.)"""
    return jax.tree.map(lambda x: jnp.zeros_like(jnp.asarray(x, jnp.float32)), scene)


def render_pass_megakernel_sharded(
    scene: Scene,
    key: jax.Array,
    width: int,
    height: int,
    spp: int,
    config: RenderConfig = RenderConfig(),
    mesh=None,
    axis_name: str = "data",
) -> jax.Array:
    """One megakernel pass with lane blocks sharded over ``mesh``.

    Each device runs the SAME fused kernel on its contiguous block of global
    lane ids (the SPMD form of the reference scheduler's scanline slices,
    cpu/Scheduler.cpp:32-42). Lane ids — and therefore pixel assignment and
    the counter-based PCG4D streams — are global, so the result is
    bit-identical to the unsharded megakernel. No communication: pixel
    blocks are disjoint; the output is assembled like the reference's
    shared image rows."""
    return _render_pass_sharded(
        scene, key, width, height, spp, config, mesh, axis_name, _INTERPRET.get()
    )


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "config", "mesh", "axis_name", "interpret"),
)
def _render_pass_sharded(
    scene, key, width, height, spp, config, mesh, axis_name, interpret
):
    from jax import shard_map
    from jax.sharding import PartitionSpec as Pspec

    prep = prepare_scene(scene)
    kernel, divisor = _kernel_for(scene, prep.rigid, width, height, spp, config)
    n_dev = mesh.shape[axis_name]
    # whole lane blocks per device
    blocks_dev = _n_blocks(-(-width * height // n_dev))

    def shard_fn(packed, seed):
        lane0 = jax.lax.axis_index(axis_name) * (blocks_dev * LANES)
        seedbuf = jnp.stack([seed.reshape(()), lane0.astype(jnp.uint32)])
        return _mega_call(kernel, blocks_dev, interpret, seedbuf, packed)

    out = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(Pspec(), Pspec()),
        out_specs=(Pspec(axis_name),) * 3,
        check_vma=False,
    )(_pack_scene(prep), jnp.asarray(seed_from_key(key), jnp.uint32).reshape(1))
    return _to_image(out, width, height, divisor, 1.0)


def render_passes_megakernel(
    scene: Scene,
    key: jax.Array,
    pass_offset: jax.Array,
    width: int,
    height: int,
    spp: int,
    n_passes: int,
    config: RenderConfig = RenderConfig(),
) -> jax.Array:
    """Sum of ``n_passes`` progressive passes in ONE dispatch (one jit +
    scan), amortizing per-call dispatch and host synchronization over the
    batch. Pass keys are fold_in(key, pass_offset + i), identical to the
    unbatched progressive loop."""
    return _render_passes(
        scene, key, pass_offset, width, height, spp, n_passes, config, _INTERPRET.get()
    )


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "n_passes", "config", "interpret"),
)
def _render_passes(scene, key, pass_offset, width, height, spp, n_passes, config, interpret):
    def body(carry, i):
        img = _render_pass(
            scene, jax.random.fold_in(key, pass_offset + i), width, height, spp,
            config, interpret,
        )
        return carry + img, None

    total, _ = jax.lax.scan(
        body, jnp.zeros((height, width, 4), jnp.float32), jnp.arange(n_passes)
    )
    return total
