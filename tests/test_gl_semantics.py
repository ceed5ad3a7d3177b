"""GL-backend estimator mode pinned by a scalar re-derivation.

``_replay_lane`` below is a literal transcription of the GL surface shader's
composition order (/root/reference/renderer/gl/SurfaceShader.cpp:31-98):

  * emission only while ``weight == vec4(1.0)`` (tracked literally, NOT via
    a depth counter — this gate also verifies the engine's depth==0 proxy);
  * transparency/diffuse coins from the material probabilities;
  * per-light NEE with the 1/(pdf_b + pdf_l) per-light MIS weight;
  * continuation weight with calculateLightProbabilities — a canReach trace
    along the BSDF direction from position + dir*0.001;
  * the ideal-reflector branch with NO light probability in its weight;
  * NO Russian roulette; the post-shade maxWeight < 0.01 cull regenerates a
    camera ray (weight = 1, next sample);
  * no background on miss.

It shares only primitives with the engine (trace, BSDF sample/eval, light
sampling, the PCG4D draws); the loop STRUCTURE is re-derived from the shader
text, so any composition drift in the gl_semantics engine breaks this gate.
The one documented deviation (config.max_depth bounds the path) is applied
identically in both.
"""

import jax
import jax.numpy as jnp
import numpy as np

from kajo_tpu.models.integrator import RenderConfig
from kajo_tpu.models.wavefront import _camera_ray, render_lanes
from kajo_tpu.ops import bsdf, lights, sampling
from kajo_tpu.ops.geometry import prepare_scene, trace
from kajo_tpu.ops.rng import uniforms4
from kajo_tpu.scene import parser

from conftest import CAUSTICS

W, H, GRID = 16, 12, 2
EFF = GRID * GRID
CFG = RenderConfig(gl_semantics=True, max_depth=8)


def _u(lane, sample, salt, seed):
    return [
        float(x[0])
        for x in uniforms4(
            jnp.array([lane], jnp.uint32),
            jnp.array([sample], jnp.uint32),
            jnp.uint32(salt),
            seed,
        )
    ]


def _trace1(prep, o, d):
    h = trace(prep, jnp.asarray(o, jnp.float32).reshape(1, 3), jnp.asarray(d, jnp.float32).reshape(1, 3))
    return (
        int(h.obj[0]),
        np.asarray(h.position[0]),
        np.asarray(h.normal[0]),
        np.asarray(h.tangent[0]),
        np.asarray(h.binormal[0]),
    )


def _replay_lane(prep, mats, lane, seed, config):
    num_l = int(prep.light_obj.shape[0])
    ncalls = -(-max(5 + 3 * num_l, 9 if config.one_light_nee else 0) // 4)
    eps = float(config.surface_epsilon)
    cull = float(config.regen_threshold if config.regen_threshold > 0.0 else 0.01)

    def camera(sample):
        o, d = _camera_ray(
            prep,
            jnp.array([lane], jnp.uint32),
            jnp.array([sample], jnp.int32),
            seed,
            W,
            H,
            GRID,
        )
        return np.asarray(o[0]), np.asarray(d[0])

    radiance = np.zeros(3, np.float64)
    sample = 0
    depth = 0
    weight = np.ones(3, np.float64)
    o, d = camera(0)

    def end_path():
        nonlocal sample, depth, weight, o, d
        sample += 1
        depth = 0
        weight = np.ones(3, np.float64)
        if sample < EFF:
            o, d = camera(sample)

    guard = 0
    while sample < EFF and guard < 500:
        guard += 1
        us = []
        for i in range(ncalls):
            us.extend(_u(lane, sample, depth * ncalls + i, seed))

        obj, pos, normal, tangent, binormal = _trace1(prep, o, d)
        if obj < 0:  # GL never consumes backgroundColor
            end_path()
            continue

        m = {k: np.asarray(getattr(mats, k)[obj], np.float64) for k in
             ("diffuse", "specular", "emission", "transparency",
              "specular_exponent", "refractive_index")}

        # "if (weight == vec4(1.0)) radiance += weight * emission"
        if np.all(weight == 1.0):
            radiance += weight * m["emission"][:3]

        view = d
        sum_d, sum_s, sum_t = m["diffuse"][:3].sum(), m["specular"][:3].sum(), m["transparency"][:3].sum()
        total = sum_d + sum_s + sum_t
        p_t = sum_t / total if total > 0 else 0.0
        transmit = p_t > 0 and us[1] <= p_t
        prob_t = p_t if transmit else 1.0 - p_t
        ds = sum_d + sum_s
        p_d = sum_d / ds if ds > 0 else 0.0
        diffuse = p_d > 0 and us[2] <= p_d
        prob_d = p_d if diffuse else 1.0 - p_d

        nj = lambda v: jnp.asarray(v, jnp.float32).reshape(1, -1)

        if transmit:
            dir_j, _ = bsdf.transmission_sample(nj(view), nj(normal), jnp.float32(m["refractive_index"]).reshape(1))
            fcos = np.asarray(
                bsdf.transmission_eval_abscos(nj(m["specular"][:3]), nj(normal), dir_j)[0],
                np.float64,
            )
            new_d = np.asarray(dir_j[0])
            weight = weight / prob_t * fcos
        else:
            # NEE (sampleLightsWith*BSDF): per-light loop, no self test —
            # the cos clamp zeroes chord directions on convex lights
            exp = float(m["specular_exponent"])
            is_phong = not diffuse and exp > 0
            is_mirror = not diffuse and exp <= 0
            if not is_mirror:
                nee = np.zeros(3, np.float64)
                for li in range(num_l):
                    u1, u2, u3 = us[5 + 3 * li], us[6 + 3 * li], us[7 + 3 * li]
                    dl_j, pdf_l_j = lights.sample(
                        jnp.float32(u1), jnp.float32(u2), jnp.float32(u3),
                        prep.light_center[li].reshape(1, 3),
                        prep.light_radius[li].reshape(1),
                        nj(pos),
                    )
                    dl = np.asarray(dl_j[0])
                    pdf_l = float(pdf_l_j[0])
                    if pdf_l <= 0:
                        continue
                    sobj, *_ = _trace1(prep, pos + dl * eps, dl)
                    if sobj != int(prep.light_obj[li]):
                        continue  # rayCanReach failed
                    if diffuse:
                        pdf_b = float(bsdf.lambert_pdf(nj(normal), nj(dl))[0])
                        fc = np.asarray(bsdf.lambert_eval_cos(nj(m["diffuse"][:3]), nj(normal), nj(dl))[0], np.float64)
                    else:
                        pdf_b = float(bsdf.phong_pdf(nj(view), nj(normal), nj(dl), jnp.float32(exp))[0])
                        fc = np.asarray(
                            bsdf.phong_eval_cos(nj(m["specular"][:3]), nj(view), nj(normal), nj(dl), jnp.float32(exp))[0],
                            np.float64,
                        )
                    if pdf_b == 0:
                        continue
                    nee += 1.0 / (pdf_b + pdf_l) * fc * np.asarray(prep.light_emission[li, :3], np.float64)
                radiance += weight * nee

            # continuation sample + weight update
            if diffuse:
                dj, pdf_j = bsdf.lambert_sample(
                    jnp.float32(us[3]).reshape(1), jnp.float32(us[4]).reshape(1),
                    nj(tangent), nj(binormal), nj(normal),
                )
                fc = np.asarray(bsdf.lambert_eval_cos(nj(m["diffuse"][:3]), nj(normal), dj)[0], np.float64)
            elif is_phong:
                dj, pdf_j = bsdf.phong_sample(
                    jnp.float32(us[3]).reshape(1), jnp.float32(us[4]).reshape(1),
                    nj(view), nj(normal), jnp.float32(exp).reshape(1),
                )
                fc = np.asarray(
                    bsdf.phong_eval_cos(nj(m["specular"][:3]), nj(view), nj(normal), dj, jnp.float32(exp))[0],
                    np.float64,
                )
            else:
                dj, pdf_j = bsdf.reflector_sample(nj(view), nj(normal))
                fc = np.asarray(bsdf.reflector_eval_cos(nj(m["specular"][:3]), nj(normal), dj)[0], np.float64)
            new_d = np.asarray(dj[0])
            if is_mirror:
                # no lightProbability factor (SurfaceShader.cpp:67-73)
                weight = weight / prob_t / prob_d * fc
            else:
                pdf_b = float(np.asarray(pdf_j)[0])
                if pdf_b == 0:
                    # engine kills zero-pdf continuations outright; GL's
                    # weight collapses to 0 and the cull below regenerates —
                    # same estimator, make the replay terminate identically
                    end_path()
                    continue
                # calculateLightProbabilities: canReach along the new
                # direction from position + dir*0.001
                sobj, *_ = _trace1(prep, pos + new_d * eps, new_d)
                light_prob = 0.0
                for li in range(num_l):
                    if sobj == int(prep.light_obj[li]):
                        light_prob += float(
                            lights.pdf(
                                prep.light_center[li].reshape(1, 3),
                                prep.light_radius[li].reshape(1),
                                nj(pos),
                            )[0]
                        )
                weight = weight / prob_t / prob_d / (light_prob + pdf_b) * fc

        # post-shade cull (SurfaceShader.cpp:88-93) + the max_depth deviation
        if np.max(weight) < cull or depth + 1 > config.max_depth:
            end_path()
            continue
        o = pos + new_d * eps
        d = new_d
        depth += 1

    return radiance


def test_gl_mode_matches_scalar_replay():
    scene = parser.load(CAUSTICS, W / H)
    prep = prepare_scene(scene)
    mats = prep.materials
    seed = jnp.uint32(12345)

    lanes = np.arange(0, W * H, 7, dtype=np.uint32)[:24]
    rgb, _ = render_lanes(
        prep, jnp.asarray(lanes, jnp.uint32), seed, W, H, EFF, GRID, CFG
    )
    rgb = np.asarray(rgb)

    rels = []
    for i, lane in enumerate(lanes):
        want = _replay_lane(prep, mats, int(lane), seed, CFG)
        got = rgb[i]
        scale = max(np.abs(want).max(), np.abs(got).max(), 1e-6)
        rels.append(np.abs(want - got).max() / scale)
    rels = np.array(rels)
    # f32 engine vs f64-accumulated replay over full paths: per-lane rel
    assert np.median(rels) < 2e-4, (np.median(rels), rels.max())
    assert (rels < 2e-2).all(), rels