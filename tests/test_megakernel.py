"""Pallas Triton megakernel vs the jax wavefront spec.

The kernel has no CPU lowering, so every render here runs through the Pallas
interpreter (``megakernel.interpret_mode()``); the CUDA lowering itself is
checked by cross-lowering for the "cuda" platform, which needs no card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kajo_tpu.models.integrator import RenderConfig
from kajo_tpu.models.wavefront import render_pass_fast
from kajo_tpu.ops.pallas import megakernel
from kajo_tpu.scene import parser
from kajo_tpu.scene.procedural import random_spheres_scene
from kajo_tpu.scene.testscene import build_test_scene

from conftest import CAUSTICS, SCALED


def _mega(scene, key, w, h, spp, config=RenderConfig()):
    with megakernel.interpret_mode():
        return np.asarray(megakernel.render_pass_megakernel(scene, key, w, h, spp, config))


def _rel_mean(a, b):
    return abs(a[..., :3].mean() - b[..., :3].mean()) / max(b[..., :3].mean(), 1e-9)


def test_supports():
    scene = parser.load(CAUSTICS, 1.0)
    assert megakernel.supports(scene)
    # non-rigid scenes run the general 23-float record
    assert megakernel.supports(dataclasses.replace(scene, rigid_spheres=False))


def test_matches_wavefront_spheres():
    scene = parser.load(CAUSTICS, 32 / 24)
    a = _mega(scene, jax.random.PRNGKey(1), 32, 24, 16)
    b = np.asarray(render_pass_fast(scene, jax.random.PRNGKey(1), 32, 24, 16))
    assert np.isfinite(a).all()
    # same estimator, same RNG stream; only the plane tangent frame differs
    # (azimuthal rotation of cosine sampling) -> statistically equal
    assert _rel_mean(a, b) < 0.05


def test_caustics_finite():
    scene = parser.load(CAUSTICS, 1.0)
    img = _mega(scene, jax.random.PRNGKey(3), 16, 16, 4)
    assert np.isfinite(img).all()
    assert img[..., :3].mean() > 0


def test_nonrigid_scaled_scene_matches_wavefront():
    """Scaled transforms (data/scaled.json) run the 23-float general record:
    same RNG stream as the wavefront -> per-pixel agreement up to the plane
    tangent-frame difference (azimuthal rotation of cosine sampling on the
    ground plane — distribution-equal by design, a handful of bounce pixels
    differ; see the megakernel module docstring)."""
    scene = parser.load(SCALED, 32 / 24)
    assert not scene.rigid_spheres
    assert megakernel.supports(scene)
    a = _mega(scene, jax.random.PRNGKey(1), 32, 24, 16)
    b = np.asarray(render_pass_fast(scene, jax.random.PRNGKey(1), 32, 24, 16))
    assert np.isfinite(a).all()
    tm = lambda x: np.clip(x[..., :3], 0, 1) ** (1 / 2.2)
    assert np.abs(tm(a) - tm(b)).mean() < 5e-4


def test_nonrigid_fori_path_matches_wavefront():
    """> UNROLL_OBJECTS non-rigid spheres exercise the dynamic-load fori loop
    with the general record."""
    scene = random_spheres_scene(40, seed=3, extent=20.0, scale_jitter=0.5)
    assert not scene.rigid_spheres
    assert scene.num_spheres > megakernel.UNROLL_OBJECTS
    a = _mega(scene, jax.random.PRNGKey(2), 24, 16, 4)
    b = np.asarray(render_pass_fast(scene, jax.random.PRNGKey(2), 24, 16, 4))
    assert np.isfinite(a).all()
    assert _rel_mean(a, b) < 0.01


def test_nonrigid_caustics_scaled_element():
    """The caustics scene with one element rescaled (non-rigid): runs the
    general record through delta BSDFs + refraction."""
    scene = parser.load(CAUSTICS, 1.0)
    st = jnp.asarray(scene.sphere_transform)
    scale = jnp.diag(jnp.array([1.3, 0.8, 1.1, 1.0], jnp.float32))
    st = st.at[0].set(st[0] @ scale)
    scene_nr = dataclasses.replace(
        jax.tree.map(jnp.asarray, scene), sphere_transform=st, rigid_spheres=False
    )
    assert megakernel.supports(scene_nr)
    a = _mega(scene_nr, jax.random.PRNGKey(3), 16, 16, 4)
    b = np.asarray(render_pass_fast(scene_nr, jax.random.PRNGKey(3), 16, 16, 4))
    assert np.isfinite(a).all()
    assert a[..., :3].mean() > 0
    assert _rel_mean(a, b) < 0.02


def test_nonrigid_jvp_matches_fd():
    """Forward-mode megakernel on a non-rigid scene: radius tangent of the
    visible sphere matches central differences of the primal kernel."""
    sc = jax.tree.map(jnp.asarray, parser.load(SCALED, 1.0))
    key = jax.random.PRNGKey(4)
    tan = megakernel.scene_zero_tangent(sc)
    tan = dataclasses.replace(tan, sphere_radius=tan.sphere_radius.at[3].set(1.0))
    with megakernel.interpret_mode():
        _, dot = megakernel.render_pass_megakernel_jvp(sc, tan, key, 24, 24, 4)
    dot = np.asarray(dot)
    eps = 1e-3
    rp = dataclasses.replace(sc, sphere_radius=sc.sphere_radius.at[3].add(eps))
    rm = dataclasses.replace(sc, sphere_radius=sc.sphere_radius.at[3].add(-eps))
    ip = _mega(rp, key, 24, 24, 4)
    im = _mega(rm, key, 24, 24, 4)
    fd = (ip - im) / (2 * eps)
    scale = np.abs(fd[..., :3]).mean()
    assert scale > 0.1  # the perturbed sphere is visible
    err = np.abs(fd[..., :3] - dot[..., :3]).mean() / scale
    assert err < 0.01, err


def test_one_light_nee_matches_wavefront():
    """one_light_nee in the fused kernel: the selector/sample uniforms are
    the same PCG4D draws as the wavefront's one-light path, so the images
    agree up to the plane tangent-frame difference."""
    scene = random_spheres_scene(24, seed=17, extent=12.0, n_lights=3)
    cfg = RenderConfig(max_depth=2, one_light_nee=True)
    a = _mega(scene, jax.random.PRNGKey(9), 24, 16, 4, cfg)
    b = np.asarray(render_pass_fast(scene, jax.random.PRNGKey(9), 24, 16, 4, cfg))
    assert np.isfinite(a).all()
    assert _rel_mean(a, b) < 0.05
    # and it is a different (1-shadow-ray) estimator than all-lights, not a
    # silently ignored knob: same key, different NEE draws -> different image
    c = _mega(scene, jax.random.PRNGKey(9), 24, 16, 4, RenderConfig(max_depth=2))
    assert np.abs(a - c).max() > 1e-6


def test_full_mis_mode():
    scene = build_test_scene(1.0)
    kajo = _mega(scene, jax.random.PRNGKey(5), 16, 16, 4)
    full = _mega(scene, jax.random.PRNGKey(5), 16, 16, 4, RenderConfig(full_mis=True))
    assert full[..., :3].mean() >= kajo[..., :3].mean() * 0.999


# ---------------------------------------------------------------- variants
# The kernel's structural variants: rigid 4-float record with unrolled or
# fori object loops, the general 23-float record, the in-kernel jvp, and the
# shard_map wrapper.

def _variant_scene(variant):
    if variant == "rigid-unrolled":
        scene = build_test_scene(4 / 3)
        assert scene.rigid_spheres and scene.num_spheres <= megakernel.UNROLL_OBJECTS
    elif variant == "rigid-fori":
        scene = random_spheres_scene(20, seed=5, extent=10.0, n_lights=2)
        assert scene.rigid_spheres and scene.num_spheres > megakernel.UNROLL_OBJECTS
    else:
        scene = parser.load(SCALED, 4 / 3)
        assert not scene.rigid_spheres
    return scene


def _lower_for_cuda(variant):
    cfg = RenderConfig(max_depth=3)
    key = jax.random.PRNGKey(0)
    w, h, spp = 24, 16, 4
    if variant == "jvp":
        scene = jax.tree.map(jnp.asarray, parser.load(CAUSTICS, w / h))
        tan = megakernel.scene_zero_tangent(scene)
        tan = dataclasses.replace(tan, sphere_radius=tan.sphere_radius.at[0].set(1.0))
        traced = megakernel._render_pass_jvp.trace(scene, tan, key, w, h, spp, cfg, False)
    elif variant == "sharded":
        from kajo_tpu.parallel.render import make_mesh

        scene = parser.load(CAUSTICS, w / h)
        traced = megakernel._render_pass_sharded.trace(
            scene, key, w, h, spp, cfg, make_mesh(), "data", False
        )
    else:
        traced = megakernel._render_pass.trace(
            _variant_scene(variant), key, w, h, spp, cfg, False
        )
    return traced.lower(lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize(
    "variant", ["rigid-unrolled", "rigid-fori", "general", "jvp", "sharded"]
)
def test_cuda_cross_lowering(variant):
    """Each variant lowers to a Triton kernel call for CUDA with no card:
    the Pallas Triton lowering (power-of-two blocks, supported primitives)
    runs here; only PTX compilation is left to the card."""
    text = _lower_for_cuda(variant)
    assert "__gpu$xla.gpu.triton" in text, text[:2000]
    assert "kajo_megakernel" in text


@pytest.mark.parametrize("variant", ["rigid-unrolled", "rigid-fori", "general"])
def test_interpret_variant_matches_fast(variant):
    scene = _variant_scene(variant)
    key = jax.random.PRNGKey(11)
    a = _mega(scene, key, 24, 16, 4)
    b = np.asarray(render_pass_fast(scene, key, 24, 16, 4))
    assert a.shape == (16, 24, 4) and np.isfinite(a).all()
    np.testing.assert_array_equal(a[..., 3], 1.0)
    assert _rel_mean(a, b) < 0.05


def test_interpret_jvp_primal_matches_primal_kernel():
    """The jvp kernel's primal output is the primal kernel's image, and its
    tangent alpha channel is zero."""
    scene = jax.tree.map(jnp.asarray, parser.load(CAUSTICS, 4 / 3))
    tan = megakernel.scene_zero_tangent(scene)
    tan = dataclasses.replace(tan, sphere_radius=tan.sphere_radius.at[2].set(1.0))
    key = jax.random.PRNGKey(6)
    with megakernel.interpret_mode():
        img, dot = megakernel.render_pass_megakernel_jvp(scene, tan, key, 24, 16, 4)
    ref = _mega(scene, key, 24, 16, 4)
    np.testing.assert_allclose(np.asarray(img), ref, rtol=1e-6, atol=1e-6)
    dot = np.asarray(dot)
    assert np.isfinite(dot).all()
    np.testing.assert_array_equal(dot[..., 3], 0.0)


@pytest.mark.parametrize("w,h", [(13, 7), (20, 9)])
def test_lane_block_padding(w, h, monkeypatch):
    """width*height not a multiple of the lane block: pad lanes start
    finished and are cut off, and since lane ids are global the image is
    bit-identical whatever the block size."""
    assert (w * h) % megakernel.LANES != 0
    scene = build_test_scene(w / h)
    key = jax.random.PRNGKey(2)
    a = _mega(scene, key, w, h, 4)
    assert a.shape == (h, w, 4) and np.isfinite(a).all()
    monkeypatch.setattr(megakernel, "LANES", 32)
    megakernel._render_pass.clear_cache()
    try:
        b = _mega(scene, key, w, h, 4)
    finally:
        megakernel._render_pass.clear_cache()
    np.testing.assert_array_equal(a, b)


def test_mega_engine_without_interpret_raises_on_cpu():
    """On the CPU the kernel runs only when a caller opts into the
    interpreter; the engine choice says so instead of failing in lowering."""
    from kajo_tpu import cli
    from kajo_tpu.models.engine import select_engine

    scene = build_test_scene(1.0)
    assert not megakernel.available()
    with pytest.raises(ValueError, match="CUDA"):
        select_engine(scene, "mega")
    with pytest.raises(ValueError, match="CUDA"):
        cli.main(["--engine", "mega", "-w", "8", "-h", "8", "--spp", "1", "--passes", "1"])
    with megakernel.interpret_mode():
        assert megakernel.available()
        assert select_engine(scene, "mega") == "mega"
    assert not megakernel.available()
