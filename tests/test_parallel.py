"""Sharded rendering over the virtual 8-device mesh."""

import jax
import numpy as np

from kajo_tpu.models.integrator import RenderConfig, render_pass
from kajo_tpu.parallel.render import make_mesh, render_pass_sharded
from kajo_tpu.scene.testscene import build_test_scene

CFG = RenderConfig(max_depth=2)


def test_sharded_matches_unsharded():
    """Parity scan sharded over 8 devices == sharded over 1 device, per-pixel.

    (The sharded path's uniform draws use flat lane-shaped arrays, so it is
    stream-identical across mesh sizes; the unsharded render_pass uses [H,W]
    draws and is only statistically equal.)"""
    scene = build_test_scene(1.0)
    key = jax.random.PRNGKey(4)
    a = np.asarray(render_pass_sharded(scene, key, 24, 24, 4, CFG, make_mesh()))
    b = np.asarray(
        render_pass_sharded(scene, key, 24, 24, 4, CFG, make_mesh(jax.devices()[:1]))
    )
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    c = np.asarray(render_pass(scene, key, 24, 24, 4, CFG))
    assert abs(a[..., :3].mean() - c[..., :3].mean()) / c[..., :3].mean() < 0.15


def test_sharded_fast_bit_matches_unsharded():
    """The regenerating wavefront sharded over the mesh is bit-identical to
    the single-device engine (global-lane PCG4D streams)."""
    from kajo_tpu.models.wavefront import render_pass_fast
    from kajo_tpu.parallel.render import render_pass_fast_sharded

    scene = build_test_scene(1.0)
    key = jax.random.PRNGKey(7)
    a = np.asarray(render_pass_fast_sharded(scene, key, 16, 16, 4, CFG, make_mesh()))
    b = np.asarray(render_pass_fast(scene, key, 16, 16, 4, CFG))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_sharded_mega_bit_matches_unsharded():
    """The fused megakernel sharded over the mesh is bit-identical to the
    single-device kernel (interpreter on the CPU mesh)."""
    from kajo_tpu.ops.pallas import megakernel
    from kajo_tpu.scene import parser

    from conftest import CAUSTICS

    scene = parser.load(CAUSTICS, 1.0)
    key = jax.random.PRNGKey(3)
    with megakernel.interpret_mode():
        a = np.asarray(
            megakernel.render_pass_megakernel_sharded(scene, key, 16, 16, 4, CFG, make_mesh())
        )
        b = np.asarray(megakernel.render_pass_megakernel(scene, key, 16, 16, 4, CFG))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_objsharded_matches_unsharded():
    """Scene sharded over the mesh (rays replicated, nearest hit reduced with
    pmin/psum) == the single-device fast engine, per pixel."""
    from kajo_tpu.models.wavefront import render_pass_fast
    from kajo_tpu.parallel.objshard import render_pass_fast_objsharded
    from kajo_tpu.scene.procedural import random_spheres_scene

    scene = random_spheres_scene(66, seed=21, extent=12.0, n_lights=2)
    key = jax.random.PRNGKey(11)
    a = np.asarray(
        render_pass_fast_objsharded(scene, key, 16, 12, 4, CFG, make_mesh())
    )
    b = np.asarray(render_pass_fast(scene, key, 16, 12, 4, CFG))
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_objsharded_nonrigid():
    import dataclasses

    from kajo_tpu.models.wavefront import render_pass_fast
    from kajo_tpu.parallel.objshard import render_pass_fast_objsharded
    from kajo_tpu.scene.procedural import random_spheres_scene

    scene = random_spheres_scene(30, seed=22, extent=10.0, n_lights=1)
    st = np.asarray(scene.sphere_transform).copy()
    st[::3, 0, 0] = 1.2
    scene = dataclasses.replace(scene, sphere_transform=st, rigid_spheres=False)
    key = jax.random.PRNGKey(12)
    a = np.asarray(
        render_pass_fast_objsharded(scene, key, 12, 12, 4, CFG, make_mesh())
    )
    b = np.asarray(render_pass_fast(scene, key, 12, 12, 4, CFG))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_sharded_engine_dispatch():
    from kajo_tpu.parallel.render import render_pass_sharded_engine

    scene = build_test_scene(1.0)
    img = render_pass_sharded_engine(
        "fast", scene, jax.random.PRNGKey(0), 16, 16, 4, CFG, make_mesh()
    )
    assert img.shape == (16, 16, 4)
    assert np.isfinite(np.asarray(img)).all()


def test_sharded_uses_all_devices():
    scene = build_test_scene(1.0)
    mesh = make_mesh()
    assert mesh.devices.size == 8
    img = render_pass_sharded(scene, jax.random.PRNGKey(0), 16, 16, 4, CFG, mesh)
    img.block_until_ready()
    assert img.shape == (16, 16, 4)


def test_gradient_through_sharded_render():
    import jax.numpy as jnp

    scene = build_test_scene(1.0)
    scene = jax.tree.map(jnp.asarray, scene)
    mesh = make_mesh()

    def loss(s):
        img = render_pass_sharded(s, jax.random.PRNGKey(1), 16, 16, 4, CFG, mesh)
        return jnp.mean(img[..., :3])

    g = jax.grad(lambda d: loss(
        __import__("dataclasses").replace(
            scene,
            materials=__import__("dataclasses").replace(scene.materials, diffuse=d),
        )
    ))(scene.materials.diffuse)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).sum() > 0


def test_multihost_entrypoint_single_process(tmp_path):
    # single-process: initialize is a no-op, render lands on "host 0"
    from kajo_tpu.parallel import multihost
    from kajo_tpu.scene.testscene import build_test_scene

    multihost.initialize()
    img = multihost.render_distributed(
        build_test_scene(1.0), 16, 16, 4, jax.random.PRNGKey(0), passes=1, config=CFG
    )
    assert img is not None and img.shape == (16, 16, 4)
    assert np.isfinite(img).all()
