"""Object-axis sharding: scene chunks per device, rays replicated.

The SURVEY §2.5 scaling design for scenes too large (or too slow) to trace
per chip: shard the *sphere array* over the mesh instead of the rays — the
ring-attention/CP analogue where the rays stay resident and the scene is the
sharded operand. Each device traces its sphere shard (through the same
dense / chunked paths as the single-device engine), then the global nearest
hit is reduced with XLA collectives:

    t_global   = pmin(t_local)
    winner_dev = pmin(device_index | not-winner -> +inf)
    hit fields = psum(local fields * is_unique_winner)

Everything else (materials, lights, wavefront state) is replicated, so after
the reduction every device continues the identical shading computation —
shading is cheap next to the O(S) trace this divides by the mesh size.
Object ids stay global (num_planes + device * shard + local index), so NEE
self-exclusion and light-visibility checks are unchanged.

Planes are replicated (P is small); padding spheres (r² = -1) can never hit.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models.integrator import RenderConfig
from ..ops.geometry import PreparedScene, SurfaceHit, prepare_scene, trace
from ..scene.types import Scene

OBJ_AXIS = "data"  # reuse the 1-D mesh's axis; semantics here are object-parallel


def _round_up(n, m):
    return -(-n // m) * m


def make_objsharded_trace(num_planes: int, shard: int, axis: str):
    """trace_fn computing the global nearest hit across sphere shards."""

    def trace_fn(prep_local, o, d):
        h = trace(prep_local, o, d)
        dev = jax.lax.axis_index(axis)
        gobj = jnp.where(h.obj >= num_planes, h.obj + dev * shard, h.obj)
        t_g = jax.lax.pmin(h.t, axis)
        hitmask = jnp.isfinite(t_g)
        win = (h.t == t_g) & hitmask
        wdev = jax.lax.pmin(jnp.where(win, dev, jnp.int32(1 << 30)), axis)
        mine = win & (dev == wdev)
        m1 = mine.astype(jnp.float32)[:, None]
        pos = jax.lax.psum(h.position * m1, axis)
        nor = jax.lax.psum(h.normal * m1, axis)
        tan = jax.lax.psum(h.tangent * m1, axis)
        bino = jax.lax.psum(h.binormal * m1, axis)
        obj_g = jax.lax.psum(jnp.where(mine, gobj, 0), axis)
        return SurfaceHit(
            t=t_g,
            obj=jnp.where(hitmask, obj_g, -1),
            position=jnp.where(hitmask[:, None], pos, o),
            normal=jnp.where(hitmask[:, None], nor, 0.0),
            tangent=jnp.where(hitmask[:, None], tan, 0.0),
            binormal=jnp.where(hitmask[:, None], bino, 0.0),
            view=d,
        )

    return trace_fn


def _pad_prep_spheres(prep: PreparedScene, s_pad: int) -> PreparedScene:
    """Pad per-sphere leaves with unhittable spheres (r² = -1, far center)."""
    s = prep.sphere_center.shape[0]
    pad = s_pad - s
    if pad == 0:
        return prep

    def padn(a, fill=0.0):
        if a.shape[0] == 0:
            return a
        return jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0
        )

    # Repeat the last real center (keeps every value finite and in range);
    # r² = -1 keeps the pads unhittable.
    last_center = prep.sphere_center[-1:] if s else jnp.zeros((1, 3), jnp.float32)

    def pad_center(a):
        if a.shape[0] == 0:
            return a
        return jnp.concatenate(
            [a, jnp.broadcast_to(last_center, (pad, 3)).astype(a.dtype)], axis=0
        )

    return dataclasses.replace(
        prep,
        sphere_center=pad_center(prep.sphere_center),
        sphere_radius2=padn(prep.sphere_radius2, -1.0),
        sphere_inv3=padn(prep.sphere_inv3),
        sphere_invt=padn(prep.sphere_invt),
        sphere_fwd3=padn(prep.sphere_fwd3),
        # pads are unhittable: inv3 = 0 makes the quadratic's a == 0
        sphere_det=padn(prep.sphere_det, 1.0),
    )


@partial(
    jax.jit, static_argnames=("width", "height", "spp", "config", "mesh", "axis_name")
)
def render_pass_fast_objsharded(
    scene: Scene,
    key: jax.Array,
    width: int,
    height: int,
    spp: int,
    config: RenderConfig = RenderConfig(),
    mesh: Mesh | None = None,
    axis_name: str = OBJ_AXIS,
) -> jax.Array:
    """Regenerating-wavefront pass with the SCENE sharded over the mesh.

    Produces the same image as the unsharded fast engine (global-lane PCG4D
    streams; the reduced hits equal the global nearest-hit scan) while each
    device only stores and traces S/n_dev spheres."""
    from jax import shard_map

    from ..models.wavefront import render_lanes
    from ..ops.rng import seed_from_key

    n_dev = mesh.shape[axis_name]
    prep = prepare_scene(scene)
    s = prep.sphere_center.shape[0]
    shard = _round_up(max(s, 1), n_dev) // n_dev
    prep = _pad_prep_spheres(prep, shard * n_dev)

    num_planes = prep.plane_nrow.shape[0]
    grid = max(int(spp**0.5), 1)
    eff = grid * grid
    divisor = float(spp if config.kajo_spp_quirk else eff)
    n = width * height
    lane = jnp.arange(n, dtype=jnp.uint32)
    seed = jnp.asarray(seed_from_key(key), jnp.uint32).reshape(1)

    sphere_leaves = {
        "sphere_center", "sphere_radius2", "sphere_inv3",
        "sphere_invt", "sphere_fwd3", "sphere_det",
    }
    prep_specs = dataclasses.replace(
        jax.tree.map(lambda _: P(), prep),
        **{k: P(axis_name) for k in sphere_leaves},
    )

    trace_fn = make_objsharded_trace(num_planes, shard, axis_name)

    def shard_fn(prep_l, lane, seed):
        rgb, _ = render_lanes(
            prep_l, lane, seed.reshape(()), width, height, eff, grid, config,
            trace_fn=trace_fn,
        )
        return rgb

    rgb = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(prep_specs, P(), P()),
        out_specs=P(),
        check_vma=False,
    )(prep, lane, seed)
    rgb = rgb / divisor
    img = jnp.concatenate([rgb, jnp.ones((n, 1), jnp.float32)], axis=1)
    return img.reshape(height, width, 4)
