"""Command-line renderer.

Flag-compatible with the reference binary (spec /root/reference/renderer/
Main.cpp:97-146: ``-w``, ``-h``, ``-r``, ``--help``, positional scene, no scene
-> built-in test scene, writes out.png on exit) and promotes the reference's
hardcoded knobs to flags (spp, depth, seed, epsilon — SURVEY.md §5 config
table). Headless "preview": a per-pass status line with elapsed time,
samples/pixel and SI-formatted samples/s, mirroring the reference preview's
metrics (Preview.cpp:160-166), plus optional periodic PNG saves and
checkpoint/resume of the progressive accumulation state.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kajo",
        description="differentiable Monte-Carlo path tracer",
        add_help=False,
    )
    p.add_argument("--help", action="help", help="show this help")
    p.add_argument("-w", dest="width", type=int, default=640, help="image width (640)")
    p.add_argument("-h", dest="height", type=int, default=480, help="image height (480)")
    p.add_argument(
        "-r",
        dest="renderer",
        default="jax",
        choices=["jax", "cpu", "gl"],
        help="renderer backend (jax; cpu/gl accepted as aliases for parity)",
    )
    p.add_argument("scene", nargs="?", default=None, help="scene JSON (default: built-in test scene)")
    p.add_argument(
        "--procedural",
        type=int,
        default=0,
        metavar="N",
        help="render the N-sphere procedural field instead of a scene file "
        "(the big-scene scaling config; exercises the chunked trace)",
    )
    p.add_argument(
        "--scale-jitter",
        type=float,
        default=0.0,
        help="with --procedural: per-sphere rotations + uniform scales in "
        "[1/(1+j), 1+j] (non-rigid object-space trace layout)",
    )
    p.add_argument("--spp", type=int, default=32, help="samples/pixel/pass (32, kajo default)")
    p.add_argument(
        "--batch",
        type=int,
        default=0,
        help="passes per device dispatch (0 = auto: 4 on the mega/fast "
        "engines; amortizes per-dispatch overhead and host syncs — "
        "preview/saves update per batch)",
    )
    p.add_argument("--passes", type=int, default=8, help="progressive passes (8; 0 = run until Ctrl-C)")
    p.add_argument("--depth", type=int, default=8, help="max path depth (8)")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--epsilon", type=float, default=1e-3, help="secondary-ray surface offset")
    p.add_argument("--full-mis", action="store_true", help="unbiased full balance-heuristic MIS")
    p.add_argument(
        "--regen-threshold",
        type=float,
        default=None,
        help="cull lanes when throughput max drops below this (the reference GL "
        "backend's biased occupancy trick, 0.01 there; default 0 = exact; "
        "-r gl implies 0.01)",
    )
    p.add_argument("--exact-spp", action="store_true", help="disable kajo's 25/32 spp quirk")
    p.add_argument(
        "--one-light-nee",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="sample ONE uniformly chosen light per vertex (x L) instead of "
        "every light — unbiased, 1 shadow ray/vertex; big win in many-light "
        "big scenes. Default: ON for --procedural scenes with >= 10000 "
        "spheres (the big-scene config), off otherwise; "
        "--no-one-light-nee forces the reference's all-lights loop",
    )
    p.add_argument("--no-direct", action="store_true", help="disable NEE (pure BSDF path tracing)")
    p.add_argument("-o", "--out", default="out.png", help="output PNG (out.png)")
    p.add_argument("--save-every", type=int, default=0, help="also save PNG every N passes")
    p.add_argument("--checkpoint", default=None, help="progressive-state checkpoint file (.npz)")
    p.add_argument("--resume", action="store_true", help="resume from --checkpoint if present")
    p.add_argument("--platform", default=None, help="force a jax platform (e.g. cpu)")
    p.add_argument("--preview", action="store_true", help="live ANSI preview in the terminal")
    p.add_argument("--shard", action="store_true", help="shard rays over all local devices")
    p.add_argument(
        "--shard-objects",
        action="store_true",
        help="shard the SCENE over devices instead of the rays (each device "
        "stores and traces S/n_dev spheres; nearest hits reduced with "
        "collectives) — for scenes too large to replicate",
    )
    p.add_argument("--profile", default=None, metavar="DIR", help="capture a jax profiler trace to DIR")
    p.add_argument(
        "--engine",
        default="auto",
        choices=["auto", "mega", "fast", "parity"],
        help="auto = fastest supported (default); mega = fused Pallas Triton "
        "megakernel (CUDA GPUs); "
        "fast = regenerating wavefront; parity = fixed-shape scan "
        "(differentiable, bit-spec of the estimator)",
    )
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    import jax

    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from .models.engine import render_pass_engine, select_engine
    from .models.integrator import RenderConfig
    from .scene import parser
    from .scene.testscene import build_test_scene
    from .utils.format import format_si
    from .utils.image import save_png

    if args.procedural > 0 and args.scene:
        print("error: give either a scene file or --procedural, not both", file=sys.stderr)
        return 2
    if args.procedural > 0:
        from .scene.procedural import random_spheres_scene

        scene = random_spheres_scene(
            args.procedural,
            seed=args.seed,
            aspect_ratio=args.width / args.height,
            scale_jitter=args.scale_jitter,
        )
    elif args.scene:
        scene = parser.load(args.scene, args.width / args.height)
    else:
        # the reference hardcodes a 4:3 projection for its built-in scene
        # regardless of -w/-h (Main.cpp:91); match it for parity
        scene = build_test_scene(4.0 / 3.0)

    regen = args.regen_threshold
    if regen is None:
        # the reference GL backend always culls at 0.01 (SurfaceShader.cpp:89)
        regen = 0.01 if args.renderer == "gl" else 0.0
    one_light = args.one_light_nee
    if one_light is None:
        # big-scene default: one-of-L light sampling is unbiased and traces
        # one shadow ray per vertex instead of L; parity configs opt out
        # with --no-one-light-nee
        one_light = args.procedural >= 10_000
        if one_light:
            print(
                "one-light NEE enabled for the big-scene config "
                "(--no-one-light-nee for the all-lights loop)",
                file=sys.stderr,
            )
    config = RenderConfig(
        max_depth=args.depth,
        surface_epsilon=args.epsilon,
        direct_lighting=not args.no_direct,
        full_mis=args.full_mis,
        kajo_spp_quirk=not args.exact_spp,
        regen_threshold=regen,
        one_light_nee=one_light,
        # -r gl is the GL backend's EXACT estimator (first-vertex-only
        # emission, no RR, post-shade cull, no background on miss — see
        # integrator.RenderConfig.gl_semantics)
        gl_semantics=args.renderer == "gl",
    )
    key = jax.random.PRNGKey(args.seed)
    grid = max(int(args.spp**0.5), 1)
    eff_spp = grid * grid

    # fields a checkpoint must match to be safely blended into this run's
    # accumulation (resuming a different scene/seed/config would silently
    # mix unrelated renders)
    ck_meta = dict(
        scene=(
            f"<procedural:{args.procedural}:{args.scale_jitter}>"
            if args.procedural > 0
            else str(args.scene or "<builtin>")
        ),
        width=args.width,
        height=args.height,
        spp=args.spp,
        seed=args.seed,
        # every estimator-shaping config knob: a resumed pass rendered with a
        # different depth/MIS/culling setting is a different estimator and
        # must not be blended into this accumulation
        config=repr(config),
    )
    total = np.zeros((args.height, args.width, 4), np.float32)
    start_pass = 0
    if args.resume and args.checkpoint:
        try:
            ck = np.load(args.checkpoint)
            mismatched = [
                k for k, v in ck_meta.items() if k in ck and str(ck[k]) != str(v)
            ]
            if mismatched:
                print(
                    f"checkpoint {args.checkpoint} does not match this run "
                    f"({', '.join(f'{k}: {ck[k]} != {ck_meta[k]}' for k in mismatched)}); "
                    "starting fresh",
                    file=sys.stderr,
                )
            else:
                total = ck["total"]
                start_pass = int(ck["passes"])
                print(f"resumed from {args.checkpoint} at pass {start_pass}", file=sys.stderr)
        except FileNotFoundError:
            pass

    # the reference's -r selects its backend; map those names onto engines
    # (cpu -> the scalar-spec parity scan, gl -> the wavefront lineage)
    requested = args.engine
    if requested == "auto" and args.renderer == "cpu":
        requested = "parity"
    elif requested == "auto" and args.renderer == "gl":
        requested = "fast"
    engine = select_engine(scene, requested)
    print(f"engine: {engine}", file=sys.stderr)
    if args.profile:
        jax.profiler.start_trace(args.profile)
    n_passes = args.passes if args.passes > 0 else 1 << 30
    # the megakernel and fast engines batch several passes per device
    # dispatch (preview still updates per batch), amortizing dispatch and
    # the per-batch host readback
    if args.batch > 0:
        batch = args.batch
    elif engine in ("mega", "fast") and not args.shard and not args.shard_objects:
        batch = 4
    else:
        batch = 1
    t0 = time.time()
    samples_done = 0
    done = start_pass
    first = True
    last_save_bucket = start_pass // args.save_every if args.save_every else 0
    n_dev = len(jax.devices()) if (args.shard or args.shard_objects) else 1
    from .utils.keys import CTRL_S, ESC, key_poller

    try:
        with key_poller() as poll_keys:
            p = start_pass
            while p < start_pass + n_passes:
                t_pass = time.time()
                nb = min(batch, start_pass + n_passes - p)
                if args.shard_objects:
                    from .parallel.objshard import render_pass_fast_objsharded
                    from .parallel.render import make_mesh

                    nb = 1
                    pass_img = render_pass_fast_objsharded(
                        scene, jax.random.fold_in(key, p), args.width,
                        args.height, args.spp, config, make_mesh(),
                    )
                elif args.shard:
                    from .parallel.render import make_mesh, render_pass_sharded_engine

                    nb = 1
                    pass_img = render_pass_sharded_engine(
                        engine, scene, jax.random.fold_in(key, p), args.width,
                        args.height, args.spp, config, make_mesh(),
                    )
                elif nb > 1 and engine == "mega":
                    from .ops.pallas.megakernel import render_passes_megakernel

                    pass_img = render_passes_megakernel(
                        scene, key, p, args.width, args.height, args.spp, nb, config
                    )
                elif nb > 1:
                    from .models.wavefront import render_passes_fast

                    pass_img = render_passes_fast(
                        scene, key, p, args.width, args.height, args.spp, nb, config
                    )
                else:
                    pass_img = render_pass_engine(
                        engine, scene, jax.random.fold_in(key, p), args.width, args.height, args.spp, config
                    )
                total += np.asarray(pass_img)
                done = p + nb
                p = done
                pass_samples = nb * args.width * args.height * eff_spp
                samples_done += pass_samples
                now = time.time()
                elapsed = now - t0
                rate = pass_samples / max(now - t_pass, 1e-9)
                # per-device throughput: the SPMD translation of the reference
                # preview's per-thread bars (Preview.cpp:183-201) — SPMD shards
                # are equal, so one number per device tells the same story
                per_dev = (
                    f" [{n_dev} devices x {format_si(rate / n_dev)}/dev]" if n_dev > 1 else ""
                )
                print(
                    f"pass {done}: {args.width}x{args.height}, {elapsed:.1f}s, "
                    f"{done * eff_spp} samples/pixel, {format_si(rate)} samples/s"
                    + per_dev
                    + (" (incl. compile)" if first else ""),
                    file=sys.stderr,
                )
                first = False
                if args.preview:
                    from .utils.preview import show

                    show(
                        total / done,
                        f"pass {done}  {args.width}x{args.height}  {elapsed:.1f}s  "
                        f"{done * eff_spp} spp  {format_si(rate)} samples/s",
                    )
                # bucket-based periodic save: batched engines advance several
                # passes at once, so exact divisibility would skip saves
                if args.save_every and done // args.save_every > last_save_bucket:
                    last_save_bucket = done // args.save_every
                    save_png(args.out, total / done)
                if args.checkpoint:
                    np.savez(args.checkpoint, total=total, passes=done, **ck_meta)
                # interactive keys (Preview.cpp:216-234): s / Ctrl-S saves the
                # running accumulation, ESC ends the render (still saved below)
                pressed = poll_keys()
                if any(c in ("s", "S", CTRL_S) for c in pressed):
                    save_png(args.out, total / done)
                    print(f"saved {args.out} (keypress)", file=sys.stderr)
                if ESC in pressed:
                    print("ESC: stopping", file=sys.stderr)
                    break
    except KeyboardInterrupt:
        print("interrupted, saving", file=sys.stderr)

    if args.profile:
        jax.profiler.stop_trace()
        print(f"profile trace in {args.profile}", file=sys.stderr)
    if done > 0:
        save_png(args.out, total / done)
        print(f"saved {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
