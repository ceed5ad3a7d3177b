"""Silhouette-only inverse rendering (edge-aware gradients demo).

The probe scene is the pathological case for interior autodiff: a
self-luminous (flat-lit) sphere on a uniform background. Its radiance
carries no shading gradient at all — the ONLY signal for position is the
silhouette sweeping across pixels, which ordinary differentiable rendering
cannot see (the visibility function is a step). The edge-aware boundary
term (kajo_tpu/diff/edges.py) samples the sphere's analytic silhouette
circle and recovers the position anyway.

Usage: python examples/silhouette_recovery.py [--steps 60] [--platform cpu]
Writes target/start/recovered PNGs and prints the position error per step.
"""

import argparse
import dataclasses

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--out-prefix", default="silhouette")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from kajo_tpu.diff.inverse import InverseRenderer
    from kajo_tpu.models.integrator import RenderConfig, render_image
    from kajo_tpu.scene.types import Camera, make_scene
    from kajo_tpu.utils import math3d
    from kajo_tpu.utils.image import save_png

    w = h = 64
    cfg = RenderConfig(max_depth=2)

    def scene_at(cx, cy):
        camera = Camera(
            transform=math3d.look_at([0, 0, -5], [0, 0, 0], [0, -1, 0]),
            projection=math3d.perspective(45.0, 1.0, 0.1, 100.0),
        )
        spheres = [
            {
                "transform": math3d.translate(math3d.identity(), [cx, cy, 0.0]),
                "radius": 1.0,
                "material": {"emission": np.array([2.0, 2.0, 2.0, 0.0], np.float32)},
            }
        ]
        return make_scene(camera, np.array([0.25, 0.3, 0.4, 1.0], np.float32), [], spheres)

    target_scene = scene_at(0.0, 0.0)
    target = render_image(target_scene, w, h, 16, jax.random.PRNGKey(7), passes=2, config=cfg)
    save_png(f"{args.out_prefix}_target.png", np.asarray(target))

    start = scene_at(0.7, -0.45)
    save_png(
        f"{args.out_prefix}_start.png",
        np.asarray(render_image(start, w, h, 16, jax.random.PRNGKey(8), passes=2, config=cfg)),
    )

    inv = InverseRenderer(
        start, target, w, h, spp=16, config=cfg,
        param_spec=("sphere_transform",), edge_gradients=True, n_edge=512,
        learning_rate=5e-2,
    )
    for i in range(args.steps):
        loss = inv.step(jax.random.fold_in(jax.random.PRNGKey(9), i))
        if i % 10 == 0 or i == args.steps - 1:
            st = np.asarray(inv.params["sphere_transform"])
            err = float(np.hypot(st[0, 0, 3], st[0, 1, 3] + 0.0))
            print(f"step {i:3d}  loss {loss:.5f}  |pos err| {err:.4f}")

    recovered = inv.current_scene()
    save_png(
        f"{args.out_prefix}_recovered.png",
        np.asarray(render_image(recovered, w, h, 16, jax.random.PRNGKey(10), passes=2, config=cfg)),
    )
    st = np.asarray(inv.params["sphere_transform"])
    print(f"recovered center: ({st[0,0,3]:.4f}, {st[0,1,3]:.4f}), truth (0, 0)")


if __name__ == "__main__":
    main()
