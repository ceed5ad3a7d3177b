"""Wavefront Monte-Carlo path tracer with multiple importance sampling.

This is the flagship "model" of the framework: a TPU-native reformulation of
the reference's recursive estimator (spec /root/reference/renderer/cpu/
Shader.cpp:113-215, derivation in SURVEY.md §3.4) as a fixed-depth wavefront —
a `lax.scan` over bounces carrying an SoA ray state, the same execution shape
the reference's GL backend proved against its CPU backend
(gl/Renderer.cpp:213-344).

Estimator semantics replicated exactly (kajo parity):

  * miss → background color, at any depth (Shader.cpp:116-117);
  * emission is added only while the lane's ``emit`` flag is set: on camera
    segments and through chains of pure transmission; after a Lambert/Phong/
    mirror bounce with direct lighting on, the flag clears
    (``SampleNonEmissiveObjects``, Shader.cpp:121,212) — the reference never
    re-adds emission via BSDF rays, its MIS is NEE-with-balance-denominator;
  * Russian roulette from depth 0 with p = maxRGB(max(diffuse, specular,
    transparency)); the 1/p (or 1/(1-p) on kill) factor applies to the
    *local emission too* (Shader.cpp:124-127);
  * one-sample BSDF lottery: transparency coin p=ΣT/(ΣD+ΣS+ΣT), then diffuse
    coin p=ΣD/(ΣD+ΣS); every branch divides by its selection probability
    (Shader.cpp:130-177); transmission uses material.specular as its color;
  * NEE over emissive spheres only, skipping the shaded object itself, with
    one-sample balance-heuristic weights 1/(pdf_bsdf + pdf_light)
    (Shader.cpp:50-86); delta BSDFs are gated out by pdf_bsdf == 0;
  * the BSDF-sampled continuation is weighted 1/(pdf_light_vis + pdf_bsdf)
    where pdf_light_vis is the solid-angle pdf of the light actually hit by
    the continuation ray, if any (equivalent to the reference's per-light
    shadow-ray sum, Shader.cpp:88-111, because its light pdf is
    direction-independent and the "shadow" ray equals the continuation ray);
  * transmission carries no MIS weight and preserves the emit flag
    (Shader.cpp:137-151);
  * secondary rays offset by ε = 1e-3 (Shader.cpp:23), depth limit 8.

Discrete branch probabilities (RR + lottery coins) are wrapped in
stop_gradient: dividing by a *detached* selection probability is the unbiased
gradient estimator for discrete mixtures (E[X/p·p] telescopes), while sampled
directions stay reparameterized.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..ops import bsdf, lights, sampling
from ..ops.geometry import PreparedScene, generate_rays, prepare_scene, trace
from ..scene.types import Scene


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Estimator knobs (reference hardcodes: depth 8, ε=1e-3, NEE on)."""

    max_depth: int = 8
    surface_epsilon: float = 1e-3
    direct_lighting: bool = True
    # The reference never adds emission reached via BSDF rays once NEE is on
    # (Shader.cpp:212 always passes SampleNonEmissiveObjects), which drops the
    # BSDF-sampling half of the balance heuristic and under-counts direct
    # light where the BSDF pdf dominates. full_mis=True keeps the emit flag
    # set: the deferred 1/(pdf_light + pdf_bsdf) continuation weight then
    # yields the complete, unbiased one-sample balance-heuristic MIS.
    full_mis: bool = False
    # kajo divides the per-pass sum by spp while only taking floor(sqrt(spp))²
    # stratified samples (cpu/Renderer.cpp:21,38,71) — a constant 25/32-style
    # brightness bias. Keep for parity; set False for exact-spp normalization.
    kajo_spp_quirk: bool = True
    # The reference GL backend culls lanes whose path throughput drops below
    # 0.01, regenerating a fresh camera ray in place — a slightly biased
    # occupancy trick (gl/SurfaceShader.cpp:88-93). 0.0 (default) keeps the
    # exact estimator; set 0.01 to approximate the GL backend's semantics
    # (honored by the fast wavefront and megakernel engines; the parity scan
    # is fixed-depth and ignores it).
    regen_threshold: float = 0.0
    # NEE light-subset sampling: 0 (default) samples EVERY light per vertex
    # like the reference (Shader.cpp:55 loop); True samples ONE uniformly
    # chosen light scaled by L — unbiased (each light's estimator keeps its
    # exact per-light MIS weight), and cuts the shadow-ray cost from L to 1
    # per vertex, the dominant trace cost in many-light big scenes. Honored
    # by all three render engines (parity scan, fast wavefront, megakernel)
    # and the forward-mode megakernel. Higher per-sample variance.
    one_light_nee: bool = False
    # GL-backend-exact estimator (gl/SurfaceShader.cpp:31-98), honored by the
    # regenerating wavefront engines (fast/budget; `-r gl` sets it):
    #   * emission only on the path's FIRST vertex (the weight==vec4(1.0)
    #     test, SurfaceShader.cpp:37-38);
    #   * NO Russian roulette — paths continue until the throughput cull;
    #   * post-shade throughput cull (maxWeight < regen_threshold, default
    #     0.01, SurfaceShader.cpp:88-93) applied AFTER the MIS weight — our
    #     deferred-weight loop tests it at the next vertex before any of
    #     that vertex's contributions, which is the same estimator;
    #   * the continuation MIS light pdf keeps self-hits (GL's rayCanReach
    #     has no not-self test) and excludes delta (mirror) continuations
    #     from the light-pdf denominator (no lightProbability factor in the
    #     ideal-reflector weight, SurfaceShader.cpp:67-73);
    #   * NO background on miss (the GL pipeline never consumes
    #     backgroundColor — misses shade garbage; kajo scenes are closed).
    # Deviation: config.max_depth still bounds the loop (GL paths persist
    # across frames unbounded; a while_loop needs termination).
    gl_semantics: bool = False


def _maxrgb(c):
    return jnp.max(c[..., :3], axis=-1)


def _gather_materials(mats, obj):
    safe = jnp.maximum(obj, 0)
    return jax.tree.map(lambda a: a[safe], mats)


def _light_pdf_for_hit(prep: PreparedScene, hit_obj, prev_obj, prev_pos):
    """Σ over lights of (hit that light, not self) * 1/Ω(light, prev_pos).

    The reference sums per-light shadow traces along the BSDF direction
    (Shader.cpp:88-111); since the shadow ray coincides with the continuation
    ray and the light pdf is direction-independent, the sum reduces to a
    lookup on the object the continuation ray actually hit."""
    if prep.light_obj.shape[0] == 0:
        return jnp.zeros(hit_obj.shape, jnp.float32)
    is_light = hit_obj[:, None] == prep.light_obj[None, :]
    not_self = prev_obj[:, None] != prep.light_obj[None, :]
    pdf = lights.pdf(
        prep.light_center[None, :, :], prep.light_radius[None, :], prev_pos[:, None, :]
    )
    return jnp.sum(jnp.where(is_light & not_self, pdf, 0.0), axis=1)


def _nee(prep: PreparedScene, hit, mat, u_light, m_lambert, m_phong, eps):
    """Next-event estimation over all emissive spheres (Shader.cpp:50-86).

    Returns [N, 4] radiance-per-throughput. ``u_light`` is [3, N, L]."""
    num_l = prep.light_obj.shape[0]
    if num_l == 0:
        return jnp.zeros(hit.position.shape[:-1] + (4,), jnp.float32)

    n = hit.position.shape[0]
    pos = hit.position[:, None, :]  # [N, 1, 3]
    center = prep.light_center[None, :, :]  # [1, L, 3]
    radius = prep.light_radius[None, :]  # [1, L]
    dir_l, pdf_l = lights.sample(
        u_light[0], u_light[1], u_light[2], center, radius, pos
    )  # [N, L, 3], [N, L]

    # visibility: one batched shadow trace for all (lane, light) pairs
    origins = (pos + dir_l * eps).reshape(n * num_l, 3)
    sh = trace(prep, origins, dir_l.reshape(n * num_l, 3))
    visible = sh.obj.reshape(n, num_l) == prep.light_obj[None, :]
    not_self = hit.obj[:, None] != prep.light_obj[None, :]

    # active-BSDF pdf and f·cos toward each light
    normal = hit.normal[:, None, :]
    view = hit.view[:, None, :]
    exp = mat.specular_exponent[:, None]
    pdf_b = jnp.where(
        m_lambert[:, None],
        bsdf.lambert_pdf(normal, dir_l),
        jnp.where(m_phong[:, None], bsdf.phong_pdf(view, normal, dir_l, exp), 0.0),
    )
    fcos = jnp.where(
        m_lambert[:, None, None],
        bsdf.lambert_eval_cos(mat.diffuse[:, None, :], normal, dir_l),
        jnp.where(
            m_phong[:, None, None],
            bsdf.phong_eval_cos(mat.specular[:, None, :], view, normal, dir_l, exp),
            0.0,
        ),
    )  # [N, L, 4]

    ok = visible & not_self & (pdf_b != 0) & (pdf_l > 0)
    weight = jnp.where(ok, 1.0 / (pdf_b + pdf_l), 0.0)
    contrib = weight[..., None] * fcos * prep.light_emission[None, :, :]
    return jnp.sum(contrib, axis=1)


def _nee_one_light(prep: PreparedScene, hit, mat, u_sel, u3, m_lambert, m_phong, eps):
    """One-of-L NEE (the ``one_light_nee`` estimator): a uniformly chosen
    light per lane, its term scaled by L. Unbiased against `_nee`'s
    all-lights loop — each light's term keeps its exact per-light MIS weight
    1/(pdf_b + pdf_l); uniform selection contributes the factor L — with one
    shadow trace per vertex instead of L. Returns [N, 4]."""
    num_l = prep.light_obj.shape[0]
    li = jnp.minimum((u_sel * num_l).astype(jnp.int32), num_l - 1)
    center = prep.light_center[li]          # [N, 3]
    radius = prep.light_radius[li]          # [N]
    lobj = prep.light_obj[li]               # [N]
    emission = prep.light_emission[li]      # [N, 4]

    pos = hit.position
    dir_l, pdf_l = lights.sample(u3[0], u3[1], u3[2], center, radius, pos)
    sh = trace(prep, pos + dir_l * eps, dir_l)
    visible = sh.obj == lobj
    not_self = hit.obj != lobj

    exp = mat.specular_exponent
    pdf_b = jnp.where(
        m_lambert,
        bsdf.lambert_pdf(hit.normal, dir_l),
        jnp.where(m_phong, bsdf.phong_pdf(hit.view, hit.normal, dir_l, exp), 0.0),
    )
    fcos = jnp.where(
        m_lambert[:, None],
        bsdf.lambert_eval_cos(mat.diffuse, hit.normal, dir_l),
        jnp.where(
            m_phong[:, None],
            bsdf.phong_eval_cos(mat.specular, hit.view, hit.normal, dir_l, exp),
            0.0,
        ),
    )
    ok = visible & not_self & (pdf_b != 0) & (pdf_l > 0)
    weight = jnp.where(ok, num_l / (pdf_b + pdf_l), 0.0)
    return weight[:, None] * fcos * emission


def render_samples(
    prep: PreparedScene, o: jax.Array, d: jax.Array, key: jax.Array, config: RenderConfig
) -> jax.Array:
    """Path-trace one radiance sample per input ray. Returns [N, 4]."""
    n = o.shape[0]
    num_lights = prep.light_obj.shape[0]
    eps = jnp.float32(config.surface_epsilon)
    f4 = lambda v: jnp.full((n, 4), v, jnp.float32)

    if prep.materials.diffuse.shape[0] == 0:  # empty scene: background only
        return jnp.broadcast_to(prep.background, (n, 4))

    state = dict(
        o=o,
        d=d,
        throughput=f4(1.0),
        radiance=f4(0.0),
        alive=jnp.ones((n,), bool),
        emit=jnp.ones((n,), bool),
        mis_pending=jnp.zeros((n,), bool),
        pend_pdf_b=jnp.ones((n,), jnp.float32),
        pend_fcos=f4(1.0),
        pend_delta=jnp.zeros((n,), bool),
        prev_obj=jnp.full((n,), -1, jnp.int32),
        prev_pos=jnp.zeros((n, 3), jnp.float32),
    )

    def bounce(state, depth):
        k = jax.random.fold_in(key, depth)
        nu = 3 + 3 * num_lights + 2
        u = jax.random.uniform(k, (nu, n), dtype=jnp.float32)

        hit = trace(prep, state["o"], state["d"])
        alive = state["alive"]
        was_hit = hit.obj >= 0
        t = state["throughput"]
        r = state["radiance"]

        gl = bool(config.gl_semantics)

        # --- apply deferred MIS weight from the previous bounce -------------
        # GL mode: no not-self test (rayCanReach, gl/Raytracer.cpp:112-117)
        # and delta continuations carry no light pdf (SurfaceShader.cpp:67-73)
        pdf_l_vis = _light_pdf_for_hit(
            prep,
            hit.obj,
            jnp.full_like(state["prev_obj"], -1) if gl else state["prev_obj"],
            state["prev_pos"],
        )
        if config.full_mis or gl:
            # a delta BSDF cannot be sampled by NEE, so its continuation must
            # carry full weight (the reference's pdf_l+1 denominator here is a
            # kajo quirk we only keep in parity mode)
            pdf_l_vis = jnp.where(state["pend_delta"], 0.0, pdf_l_vis)
        denom = pdf_l_vis + state["pend_pdf_b"]
        weight = state["pend_fcos"] / jnp.where(denom == 0, 1.0, denom)[:, None]
        t = jnp.where((state["mis_pending"] & alive)[:, None], t * weight, t)

        if gl:
            # GL's post-shade throughput cull (SurfaceShader.cpp:88-93): in
            # the fixed-depth scan "regenerate" is simply path termination
            # (the next sample is its own lane); applied after the deferred
            # weight, before any of this vertex's contributions
            gl_cull = jnp.float32(
                config.regen_threshold if config.regen_threshold > 0.0 else 0.01
            )
            alive = alive & ~(jnp.max(t[..., :3], axis=-1) < gl_cull)

        # --- miss: lane dies; background only in the CPU scheme
        # (Shader.cpp:116-117 — the GL pipeline never consumes it) -----------
        miss = alive & ~was_hit
        if not gl:
            r = r + jnp.where(miss[:, None], t * prep.background[None, :], 0.0)
        alive = alive & was_hit

        mat = _gather_materials(prep.materials, hit.obj)

        # --- Russian roulette (Shader.cpp:124-127; GL mode: none — paths
        # run until the throughput cull) --------------------------------------
        if gl:
            cont = jnp.ones_like(alive)
        else:
            p_rr = _maxrgb(jnp.maximum(jnp.maximum(mat.diffuse, mat.specular), mat.transparency))
            cont, prob_rr = sampling.flip_coin(u[0], jax.lax.stop_gradient(p_rr))
            t = jnp.where(alive[:, None], t / prob_rr[:, None], t)
        # local emission is weighted by *all* of this vertex's stochastic
        # factors (RR + lottery + transmission f·|cos|), so it is accumulated
        # below once the final throughput for this vertex is known; lanes
        # killed here only carry the RR factor (Shader.cpp:126-127 vs 146-177).
        # GL adds emission only on the path's FIRST vertex (weight==vec4(1.0),
        # SurfaceShader.cpp:37-38)
        t_kill = t
        emitter = alive & ((depth == 0) if gl else state["emit"])
        alive = alive & cont & (depth < config.max_depth)

        # --- BSDF lottery (Shader.cpp:130-177) -------------------------------
        sum_d = jnp.sum(mat.diffuse[:, :3], -1)
        sum_s = jnp.sum(mat.specular[:, :3], -1)
        sum_t = jnp.sum(mat.transparency[:, :3], -1)
        total = sum_d + sum_s + sum_t
        p_t = jnp.where(total > 0, sum_t / jnp.where(total == 0, 1.0, total), 0.0)
        transmit, prob_t = sampling.flip_coin(u[1], jax.lax.stop_gradient(p_t))
        t = jnp.where(alive[:, None], t / prob_t[:, None], t)

        ds = sum_d + sum_s
        p_d = jnp.where(ds > 0, sum_d / jnp.where(ds == 0, 1.0, ds), 0.0)
        diff, prob_d = sampling.flip_coin(u[2], jax.lax.stop_gradient(p_d))
        t = jnp.where((alive & ~transmit)[:, None], t / prob_d[:, None], t)

        m_transmit = alive & transmit
        m_lambert = alive & ~transmit & diff
        m_phong = alive & ~transmit & ~diff & (mat.specular_exponent > 0)
        m_mirror = alive & ~transmit & ~diff & (mat.specular_exponent <= 0)

        # --- NEE (Lambert/Phong only; delta BSDFs gated by pdf==0) ----------
        if config.direct_lighting and num_lights:
            if config.one_light_nee and num_lights > 1:
                nee = _nee_one_light(
                    prep, hit, mat, u[3], (u[4], u[5], u[6]), m_lambert, m_phong, eps
                )
            else:
                u_l = u[3 : 3 + 3 * num_lights].reshape(3, num_lights, n).transpose(0, 2, 1)
                nee = _nee(prep, hit, mat, u_l, m_lambert, m_phong, eps)
            r = r + jnp.where((m_lambert | m_phong | m_mirror)[:, None], t * nee, 0.0)

        # --- continuation ray -------------------------------------------------
        u1, u2 = u[nu - 2], u[nu - 1]
        d_trans, _ = bsdf.transmission_sample(hit.view, hit.normal, mat.refractive_index)
        d_lam, pdf_lam = bsdf.lambert_sample(u1, u2, hit.tangent, hit.binormal, hit.normal)
        d_ph, pdf_ph = bsdf.phong_sample(u1, u2, hit.view, hit.normal, mat.specular_exponent)
        d_mir, _ = bsdf.reflector_sample(hit.view, hit.normal)

        new_d = jnp.where(
            m_transmit[:, None],
            d_trans,
            jnp.where(
                m_lambert[:, None], d_lam, jnp.where(m_phong[:, None], d_ph, d_mir)
            ),
        )
        pdf_b = jnp.where(
            m_lambert, pdf_lam, jnp.where(m_phong, pdf_ph, jnp.ones_like(pdf_lam))
        )
        fcos = jnp.where(
            m_transmit[:, None],
            bsdf.transmission_eval_abscos(mat.specular, hit.normal, d_trans),
            jnp.where(
                m_lambert[:, None],
                bsdf.lambert_eval_cos(mat.diffuse, hit.normal, d_lam),
                jnp.where(
                    m_phong[:, None],
                    bsdf.phong_eval_cos(
                        mat.specular, hit.view, hit.normal, d_ph, mat.specular_exponent
                    ),
                    bsdf.reflector_eval_cos(mat.specular, hit.normal, d_mir),
                ),
            ),
        )

        # transmission multiplies throughput immediately (no MIS deferral)
        t = jnp.where(m_transmit[:, None], t * fcos, t)
        # vertex emission with its exact per-branch weight (see RR note above)
        r = r + jnp.where(
            emitter[:, None], jnp.where(alive[:, None], t, t_kill) * mat.emission, 0.0
        )
        # zero-pdf BSDF samples kill the lane (Shader.cpp:193-194)
        alive = alive & (m_transmit | (pdf_b != 0))

        scatter = m_lambert | m_phong | m_mirror
        emit_after_scatter = (not config.direct_lighting) or config.full_mis
        new_state = dict(
            o=jnp.where(alive[:, None], hit.position + new_d * eps, state["o"]),
            d=jnp.where(alive[:, None], new_d, state["d"]),
            throughput=t,
            radiance=r,
            alive=alive,
            emit=jnp.where(scatter, jnp.full_like(alive, emit_after_scatter), state["emit"]),
            mis_pending=jnp.where(scatter, True, jnp.zeros_like(alive)),
            pend_pdf_b=jnp.where(scatter, pdf_b, 1.0),
            pend_fcos=jnp.where(scatter[:, None], fcos, f4(1.0)),
            pend_delta=m_mirror,
            prev_obj=jnp.where(scatter, hit.obj, -1),
            prev_pos=jnp.where(scatter[:, None], hit.position, 0.0),
        )
        return new_state, None

    # remat each bounce: the backward pass recomputes per-bounce internals
    # (trace candidates, NEE arrays) from the ~30-float/lane carry instead of
    # storing O(bounces x rays x objects) residuals — HBM is the bottleneck
    state, _ = jax.lax.scan(
        jax.checkpoint(bounce, prevent_cse=False), state, jnp.arange(config.max_depth + 1)
    )
    return state["radiance"]


def _stratified_coords(width, height, grid, u_jitter):
    """Per-stratum screen coords: kajo's 5x5-style grid + jitter
    (cpu/Renderer.cpp:38-57, including the (H - y) flip)."""
    x = jnp.arange(width, dtype=jnp.float32)
    y = jnp.arange(height, dtype=jnp.float32)
    xs, ys = jnp.meshgrid(x, y)  # [H, W]
    gx = u_jitter[0]  # [G2, H, W] stratum-x fraction with jitter folded in
    gy = u_jitter[1]
    sx = (xs[None] + gx) / width
    sy = ((height - ys)[None] + gy) / height
    return sx.reshape(-1), sy.reshape(-1)


@partial(jax.jit, static_argnames=("width", "height", "spp", "config"))
def render_pass(
    scene: Scene,
    key: jax.Array,
    width: int,
    height: int,
    spp: int,
    config: RenderConfig = RenderConfig(),
) -> jax.Array:
    """One progressive pass: stratified spp per pixel -> [H, W, 4] linear radiance.

    Matches cpu/Renderer.cpp:44-76 semantics: floor(sqrt(spp))² jittered
    strata, summed and divided by ``spp`` (kajo quirk) or by the effective
    count. Each stratum is one wavefront of W*H lanes, scanned to bound
    memory."""
    prep = prepare_scene(scene)
    grid = max(int(spp**0.5), 1)
    eff = grid * grid
    divisor = float(spp if config.kajo_spp_quirk else eff)

    def stratum(carry, idx):
        k = jax.random.fold_in(key, idx)
        gx = idx % grid
        gy = idx // grid
        uj = jax.random.uniform(k, (2, height, width), dtype=jnp.float32)
        offs_x = (gx.astype(jnp.float32) + uj[0]) / grid
        offs_y = (gy.astype(jnp.float32) + uj[1]) / grid
        sx, sy = _stratified_coords(width, height, grid, (offs_x[None], offs_y[None]))
        o, d = generate_rays(prep.camera, sx, sy)
        rad = render_samples(prep, o, d, jax.random.fold_in(k, 7919), config)
        return carry + rad, None

    total, _ = jax.lax.scan(
        jax.checkpoint(stratum, prevent_cse=False),
        jnp.zeros((width * height, 4), jnp.float32),
        jnp.arange(eff),
    )
    return (total / divisor).reshape(height, width, 4)


def render_image(
    scene: Scene,
    width: int,
    height: int,
    spp: int,
    key: jax.Array,
    passes: int = 1,
    config: RenderConfig = RenderConfig(),
) -> jax.Array:
    """Multi-pass progressive render: mean of ``passes`` independent passes."""
    total = jnp.zeros((height, width, 4), jnp.float32)
    for p in range(passes):
        total = total + render_pass(scene, jax.random.fold_in(key, p), width, height, spp, config)
    return total / passes
