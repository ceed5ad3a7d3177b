"""Benchmark: samples/s on the flagship config vs the C++ reference renderer.

Prints a JSON result line — INCREMENTALLY: the line is re-printed (flushed)
after the headline and after EVERY additional row, so a run killed on a
wall-clock timeout still leaves the most complete snapshot as the last
parseable stdout line. Rows past the wall-clock budget (env
KAJO_BENCH_BUDGET_S, default 480 s) are marked "skipped".

The baseline is the reference's own estimator (built headless via
tools/build_reference.sh) measured on this host's CPU at the same
scene/config, cached in the checkout so re-runs skip the build+measure; when
the oracle cannot be built the baseline fields are null. "Samples" are full
MIS path-tracing samples per pixel (the reference preview's own throughput
metric, Preview.cpp:160-166); both sides compute the same estimator, so
samples/s is the honest end-to-end comparison. Extras report rays/s
(primary + NEE shadow + bounce rays actually traced by the wavefront) and the
fwd+bwd (gradient) rates.

Every metric is the MEDIAN of >= 3 independently timed groups; the headline
also reports spread_pct = (max-min)/median over its groups. Each group's
clock stops at jax.block_until_ready on every output it produced.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(REPO, "data", "caustics.json")
W, H, SPP = 512, 384, 16
BASELINE_CACHE = os.path.join(REPO, ".kajo_cpp_baseline.json")


def device_info():
    """(JAX device description, nvidia-smi 'name, power limit' or None)."""
    import jax

    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        card = None
    d = jax.devices()[0]
    return f"{d.platform}:{d.device_kind} x{len(jax.devices())}", card


def timed_groups(fn, samples_per_iter, groups=3, iters=5):
    """Median-of-groups throughput. ``fn(i)`` runs one iteration (i is a
    global iteration counter so RNG keys stay distinct). Returns
    (median samples/s, spread fraction (max-min)/median)."""
    import jax

    jax.block_until_ready(fn(0))  # warm: compile + first dispatch
    rates = []
    k = 1
    for _ in range(groups):
        t0 = time.perf_counter()
        outs = []
        for _ in range(iters):
            outs.append(fn(k))
            k += 1
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        rates.append(iters * samples_per_iter / dt)
    med = statistics.median(rates)
    spread = (max(rates) - min(rates)) / med if med else 0.0
    return med, spread


def measure_reference():
    """C++ oracle samples/s, cached across processes (the build + 2-pass
    measure costs ~1 min). Returns (samples_per_s or None,
    "live"|"cached"|False)."""
    try:
        with open(BASELINE_CACHE) as f:
            c = json.load(f)
        if c.get("scene") == os.path.basename(SCENE) and c.get("config") == [W, H, SPP]:
            return float(c["samples_per_s"]), "cached"
    except (OSError, ValueError, KeyError):
        pass
    driver = os.path.join(REPO, "tools", "ref_driver")
    if not os.path.exists(driver):
        build = os.path.join(REPO, "tools", "build_reference.sh")
        try:
            subprocess.run(["bash", build], capture_output=True, timeout=300, check=True)
        except (OSError, subprocess.SubprocessError):
            return None, False
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = subprocess.run(
                [driver, SCENE, str(W), str(H), str(SPP), "2", os.path.join(tmp, "ref.raw")],
                capture_output=True,
                timeout=600,
                check=True,
            )
        stats = json.loads(out.stderr.decode().strip().splitlines()[-1])
        val = float(stats["samples_per_s"])
    except (OSError, subprocess.SubprocessError, ValueError, KeyError, IndexError):
        return None, False
    with open(BASELINE_CACHE, "w") as f:
        json.dump({"scene": os.path.basename(SCENE), "config": [W, H, SPP], "samples_per_s": val}, f)
    return val, "live"


class Rows:
    """Budgeted row runner: emits the (growing) result JSON line after every
    row so a timeout still leaves the last line parseable; rows started past
    the wall-clock budget are marked "skipped"."""

    def __init__(self, result, budget_s, t0):
        self.result = result
        self.t0 = t0
        self.budget = budget_s

    def emit(self):
        self.result["elapsed_s"] = round(time.time() - self.t0, 1)
        print(json.dumps(self.result), flush=True)

    def run(self, keys, fn):
        if isinstance(keys, str):
            keys = [keys]
        if time.time() - self.t0 > self.budget:
            for k in keys:
                self.result.setdefault(k, "skipped")
            self.emit()
            return False
        try:
            vals = fn()
        except Exception as e:
            import traceback

            print(f"[bench] row {keys[0]} failed: {e!r}", file=sys.stderr)
            traceback.print_exc()
            vals = None
        if not isinstance(vals, dict):
            vals = {keys[0]: vals}
        for k in keys:
            self.result[k] = vals.get(k)
        self.emit()
        return True


def main():
    budget_s = float(os.environ.get("KAJO_BENCH_BUDGET_S", "480"))
    t_start = time.time()

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    from kajo_tpu.models.engine import render_pass_engine, select_engine
    from kajo_tpu.models.integrator import RenderConfig
    from kajo_tpu.scene import parser
    from kajo_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    scene = parser.load(SCENE, W / H)
    config = RenderConfig()
    key = jax.random.PRNGKey(0)
    grid = max(int(SPP**0.5), 1)
    eff = grid * grid
    samples_per_pass = W * H * eff

    engine = select_engine(scene)
    iters = 7 if engine == "mega" else 2
    samples_per_s, headline_spread = timed_groups(
        lambda i: render_pass_engine(
            engine, scene, jax.random.fold_in(key, i + 1), W, H, SPP, config
        ),
        samples_per_pass,
        groups=3,
        iters=iters,
    )

    device, card = device_info()
    result = {
        "metric": f"samples/s/device {os.path.basename(SCENE)} {W}x{H} {eff}spp full-MIS path tracing",
        "value": round(samples_per_s),
        "unit": "samples/s",
        "spread_pct": round(100 * headline_spread, 1),
        "engine": engine,
        "device": device,
        "card": card,
    }
    rows = Rows(result, budget_s, t_start)
    rows.emit()  # the headline is on disk from this point on

    def _baseline_row():
        b, live = measure_reference()
        return {
            "baseline_cpp_samples_per_s": round(b) if b else None,
            "baseline_live": live,
            "vs_baseline": round(samples_per_s / b, 3) if b else None,
        }

    rows.run(["baseline_cpp_samples_per_s", "baseline_live", "vs_baseline"], _baseline_row)

    # fwd+bwd rate: reverse mode through the differentiable jax budget engine
    # (what InverseRenderer runs), material and geometry parameters alike
    def _grad_row():
        from kajo_tpu.models.wavefront import render_pass_budget

        def loss(scene_):
            im = render_pass_budget(scene_, key, W // 2, H // 2, 4, config)
            return jnp.mean(im[..., :3])

        gf = jax.jit(jax.grad(loss))
        rate, _ = timed_groups(lambda i: gf(scene), (W // 2) * (H // 2) * 4, groups=3, iters=2)
        return round(rate)

    rows.run("grad_samples_per_s", _grad_row)

    # geometry-only gradient rate (sphere transforms) on the same engine
    def _geom_grad_row():
        import dataclasses

        from kajo_tpu.models.wavefront import render_pass_budget

        gw, gh, gspp = W // 4, H // 4, 4

        def geo_loss(st):
            s2 = dataclasses.replace(jax.tree.map(jnp.asarray, scene), sphere_transform=st)
            im = render_pass_budget(s2, key, gw, gh, gspp, config)
            return jnp.mean(im[..., :3])

        ggf = jax.jit(jax.grad(geo_loss))
        st0 = jnp.asarray(scene.sphere_transform)
        rate, _ = timed_groups(lambda i: ggf(st0), gw * gh * gspp, groups=3, iters=2)
        return round(rate)

    rows.run("geom_grad_samples_per_s", _geom_grad_row)

    # big-scene scaling rows (BASELINE config 5): 100k spheres through the
    # XLA chunked trace. One-of-L light sampling is the documented big-scene
    # default (unbiased, one shadow trace per vertex — the CLI --procedural
    # default too); the all-lights parity loop is reported as its own row.
    import dataclasses as _dc

    from kajo_tpu.models.wavefront import render_passes_fast
    from kajo_tpu.scene.procedural import random_spheres_scene

    bcfg_all = RenderConfig(max_depth=2)
    bcfg = _dc.replace(bcfg_all, one_light_nee=True)
    bw, bh, bspp = 128, 96, 4
    big_samples = bw * bh * bspp
    big = random_spheres_scene(100_000, seed=0, extent=60.0)

    def _timed_big(scene_b, cfg_b, nb=8):
        # the CLI's production path: nb passes per dispatch under one
        # jit+scan (render_passes_fast)
        fn = lambda i: render_passes_fast(
            scene_b, key, jnp.int32(1 + nb * i), bw, bh, bspp, nb, cfg_b
        )
        rate, _ = timed_groups(fn, big_samples * nb, groups=5, iters=1)
        return round(rate)

    rows.run("bigscene_100k_samples_per_s", lambda: _timed_big(big, bcfg))
    rows.run("bigscene_100k_all_lights_samples_per_s", lambda: _timed_big(big, bcfg_all))

    # NON-RIGID big scene (general object-space layout, det-scaled t): the
    # same config with per-sphere rotations + scales
    def _bigscene_nonrigid_row():
        bignr = random_spheres_scene(100_000, seed=0, extent=60.0, scale_jitter=0.5)
        return _timed_big(bignr, bcfg)

    rows.run("bigscene_nonrigid_samples_per_s", _bigscene_nonrigid_row)

    # NON-RIGID scene through the auto engine: data/scaled.json (general
    # object-space record, det-scaled t, fwd3 normals)
    def _scene_engine_rate(path, salt):
        scene_x = parser.load(os.path.join(REPO, "data", path), W / H)
        eng_x = select_engine(scene_x)
        rate, _ = timed_groups(
            lambda i: render_pass_engine(
                eng_x, scene_x, jax.random.fold_in(key, salt + i), W, H, SPP, config
            ),
            samples_per_pass,
            groups=3,
            iters=iters,
        )
        return round(rate)

    rows.run("nonrigid_samples_per_s", lambda: _scene_engine_rate("scaled.json", 80))

    # forward-mode megakernel: primal+tangent of one scene direction per pass
    # (the few-parameter geometry-gradient path; GPU only)
    def _fwd_tangent_row():
        if engine != "mega":
            return None
        import dataclasses

        from kajo_tpu.ops.pallas.megakernel import (
            render_pass_megakernel_jvp,
            scene_zero_tangent,
        )

        tan = scene_zero_tangent(jax.tree.map(jnp.asarray, scene))
        tan = dataclasses.replace(
            tan, sphere_transform=tan.sphere_transform.at[1, 0, 3].set(1.0)
        )
        rate, _ = timed_groups(
            lambda i: render_pass_megakernel_jvp(
                scene, tan, jax.random.fold_in(key, 60 + i), W, H, SPP, config
            ),
            samples_per_pass,
            groups=3,
            iters=3,
        )
        return round(rate)

    rows.run("fwd_tangent_samples_per_s", _fwd_tangent_row)

    # rays/s from the live-lane counters (wavefront engine)
    def _rays_row():
        from kajo_tpu.models.wavefront import render_pass_fast_stats

        _, _, rays = render_pass_fast_stats(scene, key, W, H, SPP, config)
        rays_per_disp = float(rays)  # the count varies <1% across keys
        rate, _ = timed_groups(
            lambda i: render_pass_fast_stats(
                scene, jax.random.fold_in(key, 77 + i), W, H, SPP, config
            ),
            rays_per_disp,
            groups=3,
            iters=2,
        )
        return round(rate)

    rows.run("rays_per_s", _rays_row)

    # sharded megakernel on a 1-device mesh: the multi-device SPMD path
    # (shard_map over global lane blocks, bit-identical to unsharded —
    # tests/test_parallel.py); its ratio to the headline is the sharding
    # machinery's per-device overhead
    def _sharded_row():
        if engine != "mega":
            return None
        from kajo_tpu.ops.pallas.megakernel import render_pass_megakernel_sharded
        from kajo_tpu.parallel.render import make_mesh

        mesh1 = make_mesh(jax.devices()[:1])
        rate, _ = timed_groups(
            lambda i: render_pass_megakernel_sharded(
                scene, jax.random.fold_in(key, 40 + i), W, H, SPP, config, mesh1
            ),
            samples_per_pass,
            groups=3,
            iters=iters,
        )
        return round(rate)

    rows.run("sharded_mega_samples_per_s", _sharded_row)
    rows.emit()


if __name__ == "__main__":
    sys.exit(main())
