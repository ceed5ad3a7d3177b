"""Scaling-efficiency measurement over an N-device mesh.

BASELINE config 5 asks for rays/s at 1 chip / 1 host / N hosts with >=85%
scaling efficiency. This harness measures the *sharded code path* on a
virtual CPU mesh (the same `parallel/render.py` SPMD program that spans real
devices/hosts; forward rendering has no cross-device communication, so
virtual-mesh efficiency is a meaningful proxy for the sharding overhead).

CAVEAT: virtual CPU "devices" are threads contending for the same physical
cores and memory bandwidth, so absolute efficiency here reflects host
contention, NOT the SPMD program's scaling (forward rendering is
communication-free; on real chips the only overheads are the <0.1% lane
padding and the final gather). The number that matters from this harness is
``sharding_overhead``: sharded-on-1-device vs unsharded — the cost the mesh
machinery itself adds.

Usage: python tools/scaling_bench.py [--devices 8]
"""

import argparse
import json
import os
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--spp", type=int, default=4)
    args = ap.parse_args()

    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from kajo_tpu.models.integrator import RenderConfig
    from kajo_tpu.parallel.render import make_mesh, render_pass_sharded
    from kajo_tpu.scene import parser

    scene = parser.load("/root/reference/data/spheres.json", args.width / args.height)
    config = RenderConfig()
    key = jax.random.PRNGKey(0)
    samples = args.width * args.height * int(args.spp**0.5) ** 2

    # sharding overhead: unsharded vs mesh-of-1
    from kajo_tpu.models.integrator import render_pass

    render_pass(scene, key, args.width, args.height, args.spp, config).block_until_ready()
    t0 = time.time()
    for i in range(3):
        img = render_pass(scene, jax.random.fold_in(key, i), args.width, args.height, args.spp, config)
    img.block_until_ready()
    unsharded = 3 * samples / (time.time() - t0)

    base_rate = None
    n = 1
    while n <= args.devices:
        mesh = make_mesh(jax.devices()[:n])
        render_pass_sharded(
            scene, key, args.width, args.height, args.spp, config, mesh
        ).block_until_ready()
        t0 = time.time()
        reps = 3
        for i in range(reps):
            img = render_pass_sharded(
                scene, jax.random.fold_in(key, i), args.width, args.height, args.spp, config, mesh
            )
        img.block_until_ready()
        rate = reps * samples / (time.time() - t0)
        if base_rate is None:
            base_rate = rate
            print(
                json.dumps(
                    {
                        "unsharded_samples_per_s": round(unsharded),
                        "sharding_overhead": round(1.0 - rate / unsharded, 3),
                    }
                )
            )
        print(
            json.dumps(
                {
                    "devices": n,
                    "samples_per_s": round(rate),
                    "speedup_vs_1dev": round(rate / base_rate, 2),
                    "note": "virtual CPU devices share physical cores; see docstring",
                }
            )
        )
        n *= 2


if __name__ == "__main__":
    main()
