"""Smoke check: the main render paths on one CUDA GPU, through user entry points.

    python chip_smoke.py           # one card: phases below, then one JSON line
    python chip_smoke.py --multi   # four cards: only the multi-card path

Phases (one process; any failure exits non-zero and prints no result):

  a. progressive render through the CLI: data/caustics.json at 640x480,
     32 spp, depth 8, 4 passes, --engine auto (the megakernel) and
     --engine fast (the XLA wavefront);
  b. the 100k-sphere procedural scene through the CLI (256x192, depth 2:
     the chunked big-scene trace on the fast engine);
  c. inverse rendering: ~10 Adam steps recovering a perturbed albedo and a
     sphere position (engine auto = the XLA budget engine, then mega-fwd =
     the forward-mode megakernel);
  d. the megakernel against its plain reference (render_pass_fast, XLA) at
     640x480, and megakernel vs XLA pass times on caustics.json and
     scaled.json;
  e. the compiled kernel against itself in the CPU interpreter, same key;
  f. the jvp kernel's tangent image against central differences.

Every measurement line names the card and its power limit. The last line of
stdout is {"ok": true, "device": {...}}. There is no CPU fallback: without a
GPU backend the script exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CAUSTICS = os.path.join(REPO, "data", "caustics.json")
SCALED = os.path.join(REPO, "data", "scaled.json")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0].strip()


def timed(fn, reps=5):
    """(median seconds, all seconds) of ``fn(i)`` after one warm call; every
    call is synced with block_until_ready."""
    import jax

    jax.block_until_ready(fn(0))
    ts = []
    for i in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(1 + i))
        ts.append(time.perf_counter() - t)
    return float(np.median(ts)), ts


def run_cli(argv):
    """kajo_tpu.cli.main in-process (a second JAX process would not get the
    card's memory); returns (wall seconds, captured stderr)."""
    from kajo_tpu import cli

    err = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    wall = time.perf_counter() - t
    text = err.getvalue()
    check(rc == 0, f"cli {argv} returned {rc}:\n{text[-2000:]}")
    return wall, text


def cli_phase(card, name, argv, w, h, spp, passes, tmp, want_engine):
    """Run the CLI twice (compile, then steady state) and check its engine
    choice and the accumulated image from the checkpoint it writes."""
    eff = int(spp**0.5) ** 2
    out = os.path.join(tmp, f"{name}.png")
    ck = os.path.join(tmp, f"{name}.npz")
    common = ["-w", str(w), "-h", str(h), "--spp", str(spp), "--passes", str(passes),
              "-o", out, "--checkpoint", ck]
    t_cold, _ = run_cli(argv + common)
    t_warm, text = run_cli(argv + common)
    engine = [ln for ln in text.splitlines() if ln.startswith("engine:")][0].split()[-1]
    pass_line = [ln for ln in text.splitlines() if ln.startswith("pass ")][-1]
    check(engine == want_engine, f"{name}: engine {engine}, expected {want_engine}")
    data = np.load(ck)
    img = data["total"] / int(data["passes"])
    check(img.shape == (h, w, 4), f"{name}: image shape {img.shape}")
    check(np.isfinite(img).all(), f"{name}: non-finite pixels")
    check(img[..., :3].mean() > 0, f"{name}: black image")
    rate = passes * w * h * eff / t_warm
    print(f"[{card}] phase {name}: engine={engine} {w}x{h} spp={spp} passes={passes} "
          f"first run {t_cold:.2f} s (incl. compile), steady run {t_warm:.3f} s = "
          f"{rate:.4g} samples/s end to end; CLI: {pass_line!r}; "
          f"mean radiance {img[..., :3].mean():.5f}", flush=True)
    return engine, rate


def phase_inverse(card):
    """(c) a few Adam steps from a perturbed albedo + sphere position."""
    import jax
    import jax.numpy as jnp

    from kajo_tpu.diff.inverse import InverseRenderer
    from kajo_tpu.models.integrator import RenderConfig
    from kajo_tpu.models.wavefront import render_pass_fast
    from kajo_tpu.scene import parser

    w, h, spp = 320, 240, 4
    cfg = RenderConfig()
    truth = jax.tree.map(jnp.asarray, parser.load(CAUSTICS, w / h))
    # the ground plane's albedo (material 0) and the key light's height
    # (sphere 3, y): both shade most of the image, so interior gradients
    # carry them; both perturbations darken it, so they do not trade off
    mat, sph = 0, 3
    target = render_pass_fast(truth, jax.random.PRNGKey(123), w, h, 64, cfg)
    wrong = dataclasses.replace(
        truth,
        sphere_transform=truth.sphere_transform.at[sph, 1, 3].add(-0.25),
        materials=dataclasses.replace(
            truth.materials,
            diffuse=truth.materials.diffuse.at[mat, :3].multiply(0.6),
        ),
    )

    def err(params):
        pos = abs(float(params["sphere_transform"][sph, 1, 3] - truth.sphere_transform[sph, 1, 3]))
        alb = float(jnp.abs(params["diffuse"][mat, :3] - truth.materials.diffuse[mat, :3]).max())
        return pos, alb

    mask = {
        "sphere_transform": np.zeros((truth.num_spheres, 4, 4), bool),
        "diffuse": np.zeros((truth.num_objects, 4), bool),
    }
    mask["sphere_transform"][sph, 1, 3] = True
    mask["diffuse"][mat, :3] = True
    for engine in ("auto", "mega-fwd"):
        inv = InverseRenderer(
            wrong, target, w, h, spp=spp, config=cfg, learning_rate=2e-2,
            param_spec=("sphere_transform", "diffuse"), loss_clip=1.0,
            engine=engine, param_mask=mask if engine == "mega-fwd" else None,
        )
        e0 = err(inv.params)
        t = time.perf_counter()
        losses = [inv.step(jax.random.PRNGKey(1000))]
        t_first = time.perf_counter() - t
        t = time.perf_counter()
        for i in range(1, 10):
            losses.append(inv.step(jax.random.PRNGKey(1000 + i)))
        jax.block_until_ready(inv.params)
        t_step = (time.perf_counter() - t) / 9
        e1 = err(inv.params)
        check(np.isfinite(losses).all(), f"inverse[{engine}]: loss {losses}")
        # Adam's moments hold every gradient seen: all finite <=> all grads finite
        leaves = jax.tree.leaves((inv.params, inv.opt_state))
        check(all(bool(jnp.isfinite(x).all()) for x in leaves if jnp.issubdtype(x.dtype, jnp.floating)),
              f"inverse[{engine}]: non-finite gradient")
        check(e1[0] < e0[0] and e1[1] < e0[1],
              f"inverse[{engine}]: parameter error did not shrink: {e0} -> {e1}")
        print(f"[{card}] phase c inverse engine={inv.engine} {w}x{h} spp={spp}: "
              f"first step {t_first:.2f} s (incl. compile), step {t_step * 1e3:.2f} ms; "
              f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; |dy| {e0[0]:.4f} -> {e1[0]:.4f}, "
              f"albedo err {e0[1]:.4f} -> {e1[1]:.4f}", flush=True)


def _tonemap(x):
    return np.clip(x[..., :3], 0, 1) ** (1 / 2.2)


def _block_means(x, b=16):
    h, w = x.shape[0] // b * b, x.shape[1] // b * b
    x = x[:h, :w]
    return x.reshape(h // b, b, w // b, b, -1).mean(axis=(1, 3))


def phase_kernel_vs_reference(card):
    """(d) megakernel vs render_pass_fast at 640x480, and pass times."""
    import jax

    from kajo_tpu.models.integrator import RenderConfig
    from kajo_tpu.models.wavefront import render_pass_fast
    from kajo_tpu.ops.pallas.megakernel import render_pass_megakernel
    from kajo_tpu.scene import parser

    w, h, spp = 640, 480, 32
    cfg = RenderConfig()
    key = jax.random.PRNGKey(0)
    scene = parser.load(CAUSTICS, w / h)

    def avg(render, salt):
        return np.mean(
            [np.asarray(render(scene, jax.random.fold_in(key, salt + i), w, h, spp, cfg))
             for i in range(4)], axis=0)

    mega = avg(render_pass_megakernel, 0).astype(np.float64)
    ref = avg(render_pass_fast, 0).astype(np.float64)
    ref2 = avg(render_pass_fast, 100).astype(np.float64)  # the reference's own noise
    check(np.isfinite(mega).all(), "megakernel: non-finite pixels")
    rel = abs(mega[..., :3].mean() - ref[..., :3].mean()) / ref[..., :3].mean()
    mad = np.abs(_block_means(_tonemap(mega)) - _block_means(_tonemap(ref))).mean()
    mad_ref = np.abs(_block_means(_tonemap(ref2)) - _block_means(_tonemap(ref))).mean()
    bound = 1.5 * mad_ref
    print(f"[{card}] phase d megakernel vs render_pass_fast {w}x{h} spp={spp} x4 passes: "
          f"mean rel diff {rel:.3e} (limit 1e-2); tone-mapped 16x16-block MAD {mad:.3e} "
          f"(limit {bound:.3e} = 1.5 x the reference's seed-to-seed MAD {mad_ref:.3e})",
          flush=True)
    check(rel < 1e-2, f"megakernel mean differs from the reference by {rel:.3e}")
    check(mad < bound, f"megakernel block MAD {mad:.3e} above {bound:.3e}")

    for path in (CAUSTICS, SCALED):
        sc = parser.load(path, w / h)
        times = {}
        for name, render in (("megakernel", render_pass_megakernel), ("xla", render_pass_fast)):
            t = time.perf_counter()
            jax.block_until_ready(render(sc, key, w, h, spp, cfg))
            compile_s = time.perf_counter() - t
            med, ts = timed(lambda i: render(sc, jax.random.fold_in(key, i), w, h, spp, cfg))
            times[name] = med
            print(f"[{card}] phase d pass time {os.path.basename(path)} {w}x{h} spp={spp} "
                  f"{name}: median {med * 1e3:.3f} ms of {[round(x * 1e3, 3) for x in ts]} "
                  f"(first call {compile_s:.2f} s)", flush=True)
        print(f"[{card}] phase d {os.path.basename(path)}: megakernel "
              f"{times['xla'] / times['megakernel']:.2f}x the XLA wavefront", flush=True)


def phase_kernel_vs_interpreter(card):
    """(e) the compiled kernel vs the same kernel in the CPU interpreter."""
    import jax

    from kajo_tpu.ops.pallas import megakernel
    from kajo_tpu.scene import parser

    w, h, spp = 64, 48, 4
    scene = parser.load(CAUSTICS, w / h)
    key = np.asarray(jax.random.PRNGKey(5))
    gpu = np.asarray(megakernel.render_pass_megakernel(scene, key, w, h, spp))
    with jax.default_device(jax.devices("cpu")[0]), megakernel.interpret_mode():
        cpu = np.asarray(megakernel.render_pass_megakernel(scene, key, w, h, spp))
    gpu, cpu = gpu.astype(np.float64), cpu.astype(np.float64)
    # Triton's libdevice exp/log/sqrt and its FMA contraction differ from
    # XLA:CPU in the last bits; a glass sphere magnifies a last-bit change in
    # direction and Russian roulette turns it into another path, so at 4 spp
    # about 5% of pixels hold a diverged path. Most pixels must agree to
    # float noise, and the image mean to 1e-3.
    pix_rel = (np.abs(gpu - cpu)[..., :3] / np.maximum(np.abs(cpu[..., :3]), 1e-6)).max(axis=-1)
    frac = (pix_rel <= 1e-4).mean()
    med = float(np.median(pix_rel))
    rel = abs(gpu[..., :3].mean() - cpu[..., :3].mean()) / cpu[..., :3].mean()
    print(f"[{card}] phase e compiled kernel vs CPU interpreter {w}x{h} spp={spp}: "
          f"{frac:.4%} of pixels within 1e-4 relative (limit >= 90%), median pixel "
          f"rel diff {med:.3e} (limit 1e-5), image mean rel diff {rel:.3e} (limit 1e-3)",
          flush=True)
    check(frac >= 0.90, f"only {frac:.4%} of pixels match the interpreter")
    check(med < 1e-5, f"median pixel differs from the interpreter by {med:.3e}")
    check(rel < 1e-3, f"image mean differs from the interpreter by {rel:.3e}")


def phase_jvp(card):
    """(f) jvp tangent vs central differences, common random numbers.

    Direction: the back wall's red albedo. No coin probability depends on it
    (blue is that material's largest channel, and it has no specular or
    transparency), so the estimator is smooth in it and a central difference
    crosses no discontinuity."""
    import jax
    import jax.numpy as jnp

    from kajo_tpu.models.wavefront import render_pass_fast
    from kajo_tpu.ops.pallas import megakernel
    from kajo_tpu.scene import parser

    w, h, spp = 320, 240, 16
    scene = jax.tree.map(jnp.asarray, parser.load(CAUSTICS, w / h))
    mat = 1  # back wall (planes first)
    check(int(jnp.argmax(scene.materials.diffuse[mat, :3])) == 2, "back wall: blue is not max")
    key = jax.random.PRNGKey(7)
    tan = megakernel.scene_zero_tangent(scene)
    tan = dataclasses.replace(
        tan, materials=dataclasses.replace(tan.materials, diffuse=tan.materials.diffuse.at[mat, 0].set(1.0))
    )
    _, dot = megakernel.render_pass_megakernel_jvp(scene, tan, key, w, h, spp)
    dot = np.asarray(dot)[..., :3]
    eps = 1e-2

    def shifted(s):
        d = scene.materials.diffuse.at[mat, 0].add(s)
        return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, diffuse=d))

    fd_xla = (np.asarray(render_pass_fast(shifted(eps), key, w, h, spp))
              - np.asarray(render_pass_fast(shifted(-eps), key, w, h, spp)))[..., :3] / (2 * eps)
    fd_mega = (np.asarray(megakernel.render_pass_megakernel(shifted(eps), key, w, h, spp))
               - np.asarray(megakernel.render_pass_megakernel(shifted(-eps), key, w, h, spp)))[..., :3] / (2 * eps)
    check(np.isfinite(dot).all(), "jvp: non-finite tangent")
    scale = np.abs(fd_xla).mean()
    check(scale > 1e-3, "jvp: the direction has no effect on the image")
    err_mega = np.abs(dot - fd_mega).mean() / scale
    err_mean = abs(dot.mean() - fd_xla.mean()) / scale
    err_blocks = np.abs(_block_means(dot) - _block_means(fd_xla)).mean() / scale
    print(f"[{card}] phase f jvp tangent {w}x{h} spp={spp}, d/d(back-wall red albedo), "
          f"eps {eps}: vs FD of the kernel itself {err_mega:.3e} (limit 1e-2); vs FD of "
          f"render_pass_fast: image mean {err_mean:.3e} (limit 2e-2), 16x16-block L1 "
          f"{err_blocks:.3e} (limit 1e-1)", flush=True)
    check(err_mega < 1e-2, f"jvp vs kernel FD {err_mega:.3e}")
    check(err_mean < 2e-2, f"jvp vs XLA FD image mean {err_mean:.3e}")
    check(err_blocks < 1e-1, f"jvp vs XLA FD blocks {err_blocks:.3e}")


def phase_multi(card):
    """Four cards: lane-sharded engines, scene sharding, a sharded step.

    Every comparison runs and prints before the phase fails on any of them."""
    import jax
    import jax.numpy as jnp

    from kajo_tpu.diff.inverse import InverseRenderer
    from kajo_tpu.models.engine import render_pass_engine
    from kajo_tpu.models.integrator import RenderConfig
    from kajo_tpu.models.wavefront import render_pass_fast
    from kajo_tpu.parallel.objshard import render_pass_fast_objsharded
    from kajo_tpu.parallel.render import make_mesh, render_pass_sharded_engine
    from kajo_tpu.scene import parser
    from kajo_tpu.scene.procedural import random_spheres_scene

    devs = jax.devices()
    check(len(devs) == 4, f"--multi needs 4 GPUs, found {len(devs)}")
    mesh = make_mesh(devs)
    key = jax.random.PRNGKey(3)
    failures = []

    def soft_check(cond, msg):
        if not cond:
            failures.append(msg)

    def compare(a, b):
        """(bit-identical, share of pixels allclose at rtol 1e-4 / atol 1e-5
        — the tolerance of tests/test_parallel.py — and mean rel diff)"""
        close = np.isclose(a, b, rtol=1e-4, atol=1e-5).all(axis=-1).mean()
        rel = abs(a[..., :3].mean() - b[..., :3].mean()) / b[..., :3].mean()
        return bool(np.array_equal(a, b)), close, rel

    def spans_all(x, name):
        ds = x.sharding.device_set
        soft_check(len(ds) == 4, f"{name}: output lives on {len(ds)} device(s)")

    w, h, spp = 640, 480, 32
    cfg = RenderConfig()
    scene = parser.load(CAUSTICS, w / h)
    for engine in ("mega", "fast"):
        t = time.perf_counter()
        sharded = render_pass_sharded_engine(engine, scene, key, w, h, spp, cfg, mesh)
        jax.block_until_ready(sharded)
        t_first = time.perf_counter() - t
        spans_all(sharded, f"lane-sharded {engine}")
        med, _ = timed(lambda i: render_pass_sharded_engine(
            engine, scene, jax.random.fold_in(key, i), w, h, spp, cfg, mesh), reps=3)
        same, close, rel = compare(
            np.asarray(sharded), np.asarray(render_pass_engine(engine, scene, key, w, h, spp, cfg))
        )
        print(f"[{card}] multi lane-sharded {engine} {w}x{h} spp={spp} on 4 devices: "
              f"bit-identical to unsharded: {same}; {close:.4%} of pixels allclose; "
              f"mean rel diff {rel:.3e}; pass {med * 1e3:.3f} ms "
              f"(first {t_first:.2f} s)", flush=True)
        if engine == "mega":
            # one compiled kernel per device, global lane ids: bit-identical
            soft_check(same, "sharded megakernel differs from the unsharded render")
        else:
            # XLA compiles a differently shaped program per device, so fusion
            # and rounding may differ in the last bit, and a last-bit change
            # can flip a path's Russian-roulette coin: a few pixels diverge
            soft_check(close >= 0.95 and rel < 1e-3,
                       f"sharded fast differs from unsharded: {close:.4%}, {rel:.3e}")

    bw, bh, bspp = 256, 192, 4
    bcfg = RenderConfig(max_depth=2, one_light_nee=True)
    big = random_spheres_scene(100_000, seed=0, aspect_ratio=bw / bh)
    objs = np.asarray(render_pass_fast_objsharded(big, key, bw, bh, bspp, bcfg, mesh))
    single = np.asarray(render_pass_fast(big, key, bw, bh, bspp, bcfg))
    t_obj, _ = timed(lambda i: render_pass_fast_objsharded(
        big, jax.random.fold_in(key, i), bw, bh, bspp, bcfg, mesh), reps=3)
    t_single, _ = timed(lambda i: render_pass_fast(
        big, jax.random.fold_in(key, i), bw, bh, bspp, bcfg), reps=3)
    same, close, rel = compare(objs, single)
    print(f"[{card}] multi scene-sharded fast 100k spheres {bw}x{bh} spp={bspp}: "
          f"bit-identical to unsharded: {same}; {close:.4%} of pixels allclose; "
          f"mean rel diff {rel:.3e}; max abs diff {np.abs(objs - single).max():.3e}; "
          f"pass {t_obj * 1e3:.1f} ms on 4 devices, {t_single * 1e3:.1f} ms on one", flush=True)
    # per-shard programs change the matmul and fusion shapes, so values may
    # differ in the last bit and a few paths diverge (as for lane sharding)
    soft_check(close >= 0.95 and rel < 1e-3,
               f"scene-sharded render differs from unsharded: {close:.4%}, {rel:.3e}")

    iw, ih = 320, 240
    truth = jax.tree.map(jnp.asarray, parser.load(CAUSTICS, iw / ih))
    target = render_pass_fast(truth, jax.random.PRNGKey(123), iw, ih, 16, cfg)
    inv = InverseRenderer(truth, target, iw, ih, spp=4, config=cfg, mesh=mesh,
                          param_spec=("diffuse",), loss_clip=1.0)
    t = time.perf_counter()
    loss = inv.step(jax.random.PRNGKey(9))
    t_step = time.perf_counter() - t
    soft_check(np.isfinite(loss), f"sharded step loss {loss}")
    soft_check(all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(inv.opt_state)
                   if jnp.issubdtype(g.dtype, jnp.floating)), "sharded step: non-finite gradient")
    peaks = [d.memory_stats()["peak_bytes_in_use"] for d in devs]
    print(f"[{card}] multi sharded InverseRenderer.step {iw}x{ih} spp=4: loss {loss:.5f}, "
          f"first step {t_step:.2f} s; peak bytes per device {peaks}", flush=True)
    soft_check(min(peaks) > 0, f"a device held no arrays: {peaks}")
    check(not failures, "; ".join(failures))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card path (lane and scene sharding)")
    args = ap.parse_args(argv)

    if not (os.path.isdir(os.path.join(REPO, "kajo_tpu")) and os.path.exists(CAUSTICS)):
        print(f"chip_smoke: {REPO} is not a kajo-tpu checkout (no kajo_tpu/ or "
              f"data/caustics.json beside this script); nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    platforms = os.environ.get("JAX_PLATFORMS")
    import jax

    if platforms and "cpu" not in platforms.split(","):
        # phase e needs the CPU backend beside the GPU
        jax.config.update("jax_platforms", platforms + ",cpu")
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU backend (JAX default backend is "
              f"{jax.default_backend()!r}); nothing was run", file=sys.stderr)
        return 1

    from kajo_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = card_line()
    dev = jax.devices()[0]
    print(f"card: {card}; jax {jax.__version__}, {len(jax.devices())} x {dev.device_kind}",
          flush=True)
    t0 = time.perf_counter()
    try:
        if args.multi:
            phase_multi(card)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                cli_phase(card, "a-auto", ["--engine", "auto", "--depth", "8", CAUSTICS],
                          640, 480, 32, 4, tmp, "mega")
                cli_phase(card, "a-fast", ["--engine", "fast", "--depth", "8", CAUSTICS],
                          640, 480, 32, 4, tmp, "fast")
                # 100k objects is past MAX_KERNEL_OBJECTS: auto picks fast
                cli_phase(card, "b", ["--procedural", "100000", "--depth", "2"],
                          256, 192, 32, 4, tmp, "fast")
            phase_inverse(card)
            phase_kernel_vs_reference(card)
            phase_kernel_vs_interpreter(card)
            phase_jvp(card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"card: {card}; all phases passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
