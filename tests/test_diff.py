"""Differentiability: finite-difference checks and inverse-rendering recovery.

BASELINE.md config 4: pixel gradients w.r.t. sphere position/radius/albedo.
With a fixed RNG key the renderer is a deterministic function of the scene, so
central finite differences are well-defined and must match jax.grad away from
silhouette discontinuities (visibility terms are not edge-sampled; the FD test
uses albedo/emission/position directions whose local gradients are smooth).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from kajo_tpu.models.integrator import RenderConfig, render_pass
from kajo_tpu.scene import parser
from kajo_tpu.utils import math3d


def _two_sphere_scene():
    from kajo_tpu.scene.types import Camera, make_scene

    camera = Camera(
        transform=math3d.look_at([0, 0, -6], [0, 0, 0], [0, -1, 0]),
        projection=math3d.perspective(45.0, 1.0, 0.1, 100.0),
    )
    spheres = [
        {
            "transform": math3d.translate(math3d.identity(), [0, 0, 0]),
            "radius": 1.0,
            "material": {"diffuse": np.array([0.7, 0.4, 0.2, 1], np.float32)},
        },
        {
            "transform": math3d.translate(math3d.identity(), [0, -2.5, -1.5]),
            "radius": 0.4,
            "material": {"emission": np.array([30, 30, 30, 0], np.float32)},
        },
    ]
    scene = make_scene(camera, np.zeros(4, np.float32), [], spheres)
    return jax.tree.map(jnp.asarray, scene)  # .at[] updates need jax arrays


CFG = RenderConfig(max_depth=2)


def _mean_rgb(scene, key):
    img = render_pass(scene, key, 24, 24, 4, CFG)
    return jnp.mean(img[..., :3])


def test_grad_matches_finite_difference_albedo():
    scene = _two_sphere_scene()
    key = jax.random.PRNGKey(0)

    # perturb the BLUE channel (not the max one): Russian-roulette and
    # lottery probabilities stay constant, so the fixed-seed estimator is
    # smooth in this direction and FD is meaningful
    def f(albedo_b):
        mats = scene.materials
        diffuse = mats.diffuse.at[0, 2].set(albedo_b)
        s = dataclasses.replace(scene, materials=dataclasses.replace(mats, diffuse=diffuse))
        return _mean_rgb(s, key)

    g = jax.grad(f)(jnp.float32(0.2))
    h = 1e-2
    fd = (f(jnp.float32(0.2 + h)) - f(jnp.float32(0.2 - h))) / (2 * h)
    np.testing.assert_allclose(g, fd, rtol=0.08, atol=1e-4)


def test_grad_matches_finite_difference_emission():
    scene = _two_sphere_scene()
    key = jax.random.PRNGKey(1)

    def f(e):
        mats = scene.materials
        emission = mats.emission.at[1, :3].set(e)
        s = dataclasses.replace(scene, materials=dataclasses.replace(mats, emission=emission))
        return _mean_rgb(s, key)

    g = jax.grad(f)(jnp.float32(30.0))
    h = 1e-1
    fd = (f(jnp.float32(30 + h)) - f(jnp.float32(30 - h))) / (2 * h)
    np.testing.assert_allclose(g, fd, rtol=0.05, atol=1e-6)


def test_grad_matches_finite_difference_light_position():
    # moving the light changes NEE geometry smoothly (no silhouette crossing
    # for a small offset along z)
    scene = _two_sphere_scene()
    key = jax.random.PRNGKey(2)

    def f(dz):
        st = scene.sphere_transform.at[1, 2, 3].add(dz)
        s = dataclasses.replace(scene, sphere_transform=st)
        return _mean_rgb(s, key)

    g = jax.grad(f)(jnp.float32(0.0))
    h = 5e-3
    fd = (f(jnp.float32(h)) - f(jnp.float32(-h))) / (2 * h)
    np.testing.assert_allclose(g, fd, rtol=0.1, atol=5e-5)


def test_grad_radius_nonzero_and_finite():
    scene = _two_sphere_scene()

    def f(r):
        s = dataclasses.replace(scene, sphere_radius=scene.sphere_radius.at[0].set(r))
        return _mean_rgb(s, jax.random.PRNGKey(3))

    g = jax.grad(f)(jnp.float32(1.0))
    assert np.isfinite(g)


def test_inverse_rendering_recovers_albedo():
    # perturb the big sphere's albedo, recover it from the target render
    from kajo_tpu.diff.inverse import InverseRenderer, extract_params

    scene = _two_sphere_scene()
    target = render_pass(scene, jax.random.PRNGKey(42), 24, 24, 4, CFG)

    wrong = dataclasses.replace(
        scene,
        materials=dataclasses.replace(
            scene.materials,
            diffuse=scene.materials.diffuse.at[0, :3].set(jnp.array([0.3, 0.6, 0.6])),
        ),
    )
    inv = InverseRenderer(
        wrong, target, 24, 24, spp=4, config=CFG, learning_rate=1e-1,
        param_spec=("diffuse",), decay_steps=250,
    )
    losses = inv.run(250, jax.random.PRNGKey(7))
    # cross-estimator loss is variance-blind: recovery is tight
    recovered = np.asarray(inv.params["diffuse"])[0, :3]
    np.testing.assert_allclose(recovered, [0.7, 0.4, 0.2], atol=0.06)
    assert abs(losses[-1]) < abs(losses[0])


def test_inverse_rendering_recovers_position():
    from kajo_tpu.diff.inverse import InverseRenderer

    scene = _two_sphere_scene()
    target = render_pass(scene, jax.random.PRNGKey(42), 24, 24, 4, CFG)

    wrong = dataclasses.replace(
        scene, sphere_transform=scene.sphere_transform.at[0, 0, 3].add(0.3)
    )
    inv = InverseRenderer(
        wrong, target, 24, 24, spp=4, config=CFG, learning_rate=3e-2,
        param_spec=("sphere_transform",), decay_steps=150,
    )
    inv.run(150, jax.random.PRNGKey(9))
    offset = float(np.asarray(inv.params["sphere_transform"])[0, 0, 3])
    assert abs(offset) < 0.1, offset  # started at 0.3, true value 0.0


def test_interior_jvp_finite_on_far_grazing_scene():
    """Regression for the round-4 solid-angle underflow NaN: this exact
    moved-sphere configuration of data/scaled.json sends one camera ray
    grazing the ground plane ~3.7k units out; NEE from that hit makes the
    light's Ω round to 0 and 1/Ω's jvp NaN under the old form — through
    EVERY engine. The jvp (even with all-zero tangents) must be finite."""
    import dataclasses as dc

    import jax
    import jax.numpy as jnp
    import numpy as np

    from kajo_tpu.models.integrator import RenderConfig
    from kajo_tpu.models.wavefront import render_pass_budget
    from kajo_tpu.scene import parser

    s = jax.tree.map(jnp.asarray, parser.load("data/scaled.json", 16 / 12))
    jit = jnp.asarray(
        [[-0.05120649188756943, 0.1406901478767395, 0.1266857236623764],
         [0.25923579931259155, -0.23104041814804077, 0.13740907609462738],
         [0.25645434856414795, 0.2807557284832001, -0.2911762297153473],
         [0.21818405389785767, 0.28871703147888184, 0.2743261158466339]],
        jnp.float32,
    )
    st0 = s.sphere_transform.at[:, :3, 3].add(jit)
    key = jax.random.PRNGKey(7)

    def f(st):
        return render_pass_budget(
            dc.replace(s, sphere_transform=st), key, 16, 12, 8, RenderConfig(max_depth=3)
        )

    for tan in (jnp.zeros_like(st0), jnp.zeros_like(st0).at[3, 0, 3].set(1.0)):
        _, dot = jax.jvp(f, (st0,), (tan,))
        assert np.isfinite(np.asarray(dot)).all()
