"""Inverse rendering demo (BASELINE.md config 4).

Perturbs a sphere position and the ground albedo in data/caustics.json,
then recovers them from a target render by gradient descent through the
differentiable path tracer. Writes before/target/after PNGs.

Usage: python examples/inverse_rendering.py [--steps 300] [--platform cpu]
"""

import argparse
import dataclasses
import os

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--out-prefix", default="inverse")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from kajo_tpu.diff.inverse import InverseRenderer
    from kajo_tpu.models.integrator import RenderConfig, render_pass
    from kajo_tpu.scene import parser
    from kajo_tpu.utils.image import save_png

    w, h, spp = 96, 72, 8
    config = RenderConfig(max_depth=2)
    scene = parser.load(
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "caustics.json"),
        w / h,
    )
    scene = jax.tree.map(jnp.asarray, scene)

    target = render_pass(scene, jax.random.PRNGKey(123), w, h, spp, config)
    save_png(f"{args.out_prefix}_target.png", np.asarray(target))

    # perturb: nudge the green sphere and tint the ground. Silhouette terms
    # carry no gradient (no edge sampling), so position recovery relies on
    # shading/shadow gradients — reliable for offsets within the feature size
    wrong = dataclasses.replace(
        scene,
        # the Phong sphere: its highlight/shadow footprint carries a strong
        # shading gradient at this resolution
        sphere_transform=scene.sphere_transform.at[2, 0, 3].add(0.2).at[2, 2, 3].add(-0.1),
        materials=dataclasses.replace(
            scene.materials, diffuse=scene.materials.diffuse.at[0, :3].set(jnp.array([0.2, 0.1, 0.3]))
        ),
    )
    save_png(f"{args.out_prefix}_start.png", np.asarray(render_pass(wrong, jax.random.PRNGKey(9), w, h, 16, config)))

    inv = InverseRenderer(
        wrong, target, w, h, spp=spp, config=config, learning_rate=2e-2,
        param_spec=("sphere_transform", "diffuse"),
        loss_clip=1.0,  # HDR light pixels otherwise dominate the loss
        decay_steps=args.steps,
    )
    for i in range(0, args.steps, 20):
        losses = inv.run(20, jax.random.fold_in(jax.random.PRNGKey(7), i))
        dx = float(np.asarray(inv.params["sphere_transform"])[2, 0, 3]) - float(
            np.asarray(scene.sphere_transform)[2, 0, 3]
        )
        gd = np.abs(np.asarray(inv.params["diffuse"])[0, :3] - np.asarray(scene.materials.diffuse)[0, :3]).max()
        print(f"step {i+20:4d}  loss {losses[-1]:.5f}  sphere dx err {dx:+.3f}  ground albedo err {gd:.3f}")

    final = inv.current_scene()
    save_png(f"{args.out_prefix}_recovered.png", np.asarray(render_pass(final, jax.random.PRNGKey(9), w, h, 16, config)))
    print(f"wrote {args.out_prefix}_{{target,start,recovered}}.png")


if __name__ == "__main__":
    main()
