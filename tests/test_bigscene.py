"""Big-scene path: chunked sphere trace must match the dense path exactly,
and the procedural 100k-class scene must render."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kajo_tpu.ops import geometry
from kajo_tpu.scene.procedural import random_spheres_scene


def test_chunked_trace_matches_dense():
    # force chunking by lowering the threshold: same scene, both paths
    scene = random_spheres_scene(500, seed=3, extent=20.0, n_lights=2)
    assert scene.rigid_spheres
    prep = geometry.prepare_scene(scene)

    xs, ys = jnp.meshgrid(jnp.linspace(0.02, 0.98, 40), jnp.linspace(0.02, 0.98, 30))
    o, d = geometry.generate_rays(prep.camera, xs.ravel(), ys.ravel())

    dense = geometry.trace(prep, o, d)
    orig_threshold = geometry.BIG_SCENE_THRESHOLD
    try:
        geometry.BIG_SCENE_THRESHOLD = 64
        geometry.BIG_SCENE_CHUNK = 128
        chunked = geometry.trace(prep, o, d)
    finally:
        geometry.BIG_SCENE_THRESHOLD = orig_threshold
        geometry.BIG_SCENE_CHUNK = 2048

    np.testing.assert_array_equal(np.asarray(dense.obj), np.asarray(chunked.obj))
    # matmul tiling differs between one [N,S] sweep and per-block sweeps ->
    # last-ulp rounding differences only
    np.testing.assert_allclose(np.asarray(dense.t), np.asarray(chunked.t), rtol=1e-4)
    # grazing hits on tiny spheres amplify t-rounding into the normal; check
    # angular agreement for 99.5% of rays instead of elementwise equality
    cos = np.sum(np.asarray(dense.normal) * np.asarray(chunked.normal), -1)
    hit = np.asarray(dense.obj) >= 0
    assert np.percentile(cos[hit], 0.5) > 0.9999


def test_chunked_nonrigid_matches_dense():
    """The XLA fallback for non-rigid big scenes (no Pallas backend)."""
    scene = random_spheres_scene(300, seed=8, extent=15.0, n_lights=1)
    st = np.asarray(scene.sphere_transform).copy()
    st[::2, 0, 0] = 1.3  # non-uniform scale on half the spheres
    scene = dataclasses.replace(scene, sphere_transform=st, rigid_spheres=False)
    prep = geometry.prepare_scene(scene)

    xs, ys = jnp.meshgrid(jnp.linspace(0.02, 0.98, 24), jnp.linspace(0.02, 0.98, 18))
    o, d = geometry.generate_rays(prep.camera, xs.ravel(), ys.ravel())
    dense = geometry.trace(prep, o, d)
    orig = geometry.BIG_SCENE_THRESHOLD
    try:
        geometry.BIG_SCENE_THRESHOLD = 64
        geometry.BIG_SCENE_CHUNK = 128
        chunked = geometry.trace(prep, o, d)
    finally:
        geometry.BIG_SCENE_THRESHOLD = orig
        geometry.BIG_SCENE_CHUNK = 2048
    np.testing.assert_array_equal(np.asarray(dense.obj), np.asarray(chunked.obj))
    np.testing.assert_allclose(np.asarray(dense.t), np.asarray(chunked.t), rtol=1e-4)


@pytest.mark.parametrize("rigid", [True, False], ids=["rigid", "nonrigid"])
def test_chunked_trace_gradients_match_dense(rigid, monkeypatch):
    """Autodiff through the chunked big-scene trace (a scan over sphere
    blocks with a running nearest hit) == autodiff of the dense path:
    gradients of hit distances and normals w.r.t. sphere transforms and
    radii, for the rigid world-space and the general object-space records."""
    scene = random_spheres_scene(200, seed=9, extent=12.0, n_lights=1)
    if not rigid:
        st = np.asarray(scene.sphere_transform).copy()
        st[::2, 0, 0] = 1.3  # non-uniform scale on half the spheres
        scene = dataclasses.replace(scene, sphere_transform=st, rigid_spheres=False)
    scene = jax.tree.map(jnp.asarray, scene)
    base_prep = geometry.prepare_scene(scene)
    xs, ys = jnp.meshgrid(jnp.linspace(0.1, 0.9, 16), jnp.linspace(0.1, 0.9, 12))
    o, d = geometry.generate_rays(base_prep.camera, xs.ravel(), ys.ravel())

    def loss(st, radius):
        s = dataclasses.replace(scene, sphere_transform=st, sphere_radius=radius)
        hit = geometry.trace(geometry.prepare_scene(s), o, d)
        tt = jnp.where(hit.obj >= 0, hit.t, 0.0)
        # nonlinear in t to exercise the chain rule; normals too
        return jnp.sum(jnp.sin(tt)) + jnp.sum(hit.normal * d)

    grad = jax.grad(loss, argnums=(0, 1))
    args = (scene.sphere_transform, scene.sphere_radius)
    g_dense = grad(*args)
    monkeypatch.setattr(geometry, "BIG_SCENE_THRESHOLD", 64)
    monkeypatch.setattr(geometry, "BIG_SCENE_CHUNK", 64)
    g_chunk = grad(*args)
    assert np.abs(np.asarray(g_dense[1])).sum() > 0
    # near-tangent hits have ill-conditioned dt/dc; identical formulas in a
    # different accumulation order agree to ~0.3% there
    for a, b in zip(g_dense, g_chunk):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-2, atol=1e-4)


def test_procedural_scene_renders():
    from kajo_tpu.models.integrator import RenderConfig, render_pass

    scene = random_spheres_scene(2000, seed=1, extent=30.0)
    img = np.asarray(
        render_pass(scene, jax.random.PRNGKey(0), 32, 24, 4, RenderConfig(max_depth=2))
    )
    assert np.isfinite(img).all()
    assert img[..., :3].mean() > 0


def test_chunked_render_runs():
    # >threshold spheres exercises the chunked path inside a full render
    from kajo_tpu.models.integrator import RenderConfig, render_pass

    scene = random_spheres_scene(200, seed=2, extent=15.0, n_lights=1)
    orig = geometry.BIG_SCENE_THRESHOLD
    try:
        geometry.BIG_SCENE_THRESHOLD = 64
        geometry.BIG_SCENE_CHUNK = 64
        img = np.asarray(
            render_pass(scene, jax.random.PRNGKey(1), 16, 12, 4, RenderConfig(max_depth=2))
        )
    finally:
        geometry.BIG_SCENE_THRESHOLD = orig
        geometry.BIG_SCENE_CHUNK = 2048
    assert np.isfinite(img).all()
    assert img[..., :3].mean() > 0


def test_one_light_nee_statistically_equal():
    """one_light_nee=True: one uniformly chosen light x L == all-lights NEE
    in expectation (unbiasedness of the light-subset estimator)."""
    import dataclasses as dc

    import jax

    from kajo_tpu.models.integrator import RenderConfig
    from kajo_tpu.models.wavefront import render_pass_fast

    scene = random_spheres_scene(120, seed=17, extent=12.0, n_lights=3)
    cfg_all = RenderConfig(max_depth=2)
    cfg_one = dc.replace(cfg_all, one_light_nee=True)
    imgs_a, imgs_o = [], []
    for i in range(6):
        k = jax.random.PRNGKey(40 + i)
        imgs_a.append(np.asarray(render_pass_fast(scene, k, 32, 24, 16, cfg_all)))
        imgs_o.append(np.asarray(render_pass_fast(scene, k, 32, 24, 16, cfg_one)))
    a = np.mean(imgs_a, axis=0)[..., :3]
    o = np.mean(imgs_o, axis=0)[..., :3]
    assert np.isfinite(o).all()
    rel = abs(o.mean() - a.mean()) / a.mean()
    assert rel < 0.03, rel


def test_render_passes_fast_equals_single_passes():
    """Pass batching (render_passes_fast, one jit+scan dispatch — the CLI's
    default for the fast engine since round 4) is BIT-IDENTICAL to the sum
    of the individual passes: same fold_in keys, same estimator."""
    import jax

    from kajo_tpu.models.integrator import RenderConfig
    from kajo_tpu.models.wavefront import render_pass_fast, render_passes_fast

    scene = random_spheres_scene(120, seed=3, extent=12.0, n_lights=2)
    cfg = RenderConfig(max_depth=2)
    key = jax.random.PRNGKey(5)
    w, h, spp, nb = 24, 16, 4, 3
    single = sum(
        np.asarray(render_pass_fast(scene, jax.random.fold_in(key, 7 + i), w, h, spp, cfg))
        for i in range(nb)
    )
    batched = np.asarray(render_passes_fast(scene, key, jnp.int32(7), w, h, spp, nb, cfg))
    np.testing.assert_array_equal(batched, single)
