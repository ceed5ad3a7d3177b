"""Scene parser tests against the reference DSL semantics (scene/Parser.cpp)."""

import numpy as np
import pytest

from kajo_tpu.scene import parser
from kajo_tpu.scene.testscene import build_test_scene

from conftest import CAUSTICS


def test_color_hex3():
    # '#888' -> (8/15)^2.2 on rgb, alpha 1 (Parser.cpp:78-79 + pow 2.2)
    c = parser.parse_color("#888")
    np.testing.assert_allclose(c[:3], (8 / 15.0) ** 2.2, rtol=1e-6)
    assert c[3] == 1.0


def test_color_hex6():
    c = parser.parse_color("#aabbcc")
    expected = np.power(np.array([0xAA, 0xBB, 0xCC]) / 255.0, 2.2)
    np.testing.assert_allclose(c[:3], expected, rtol=1e-6)


def test_color_rgb_unclamped():
    # rgb(16,16,16) -> 16^2.2 (the reference gamma-expands emission too)
    c = parser.parse_color("rgb(16, 16, 16)")
    np.testing.assert_allclose(c[:3], 16.0 ** 2.2, rtol=1e-6)
    assert c[3] == 1.0


def test_color_rgba():
    c = parser.parse_color("rgba(.5, .25, 1, .5)")
    np.testing.assert_allclose(c, np.power([0.5, 0.25, 1.0, 0.5], 2.2), rtol=1e-6)


def test_trailing_commas_tolerated():
    scene = parser.loads('{"objects": [{"type": "sphere", "radius": 1,},],}', 1.0)
    assert scene.num_spheres == 1


def test_spheres_json_structure():
    scene = parser.load(CAUSTICS, 640.0 / 480.0)
    assert scene.num_spheres == 4
    assert scene.num_planes == 6
    # one emissive sphere (the light), index 3
    assert scene.light_indices == (3,)
    np.testing.assert_allclose(scene.sphere_radius, [1, 0.8, 0.8, 0.25], rtol=1e-6)
    # translate(0, -0.2, 0) on the first sphere
    np.testing.assert_allclose(scene.sphere_transform[0][:3, 3], [0, -0.2, 0], atol=1e-6)
    # emission = rgb(24,24,22)^2.2 on the light's material (planes-first indexing)
    light_mat = scene.num_planes + 3
    np.testing.assert_allclose(
        scene.materials.emission[light_mat][:3], np.array([24.0, 24.0, 22.0]) ** 2.2, rtol=1e-5
    )
    # background black
    np.testing.assert_allclose(scene.background[:3], 0.0)


def test_spheres_json_camera_matches_testscene():
    # the camera DSL builds the same matrices as the built-in scene's math3d
    # calls (lookat(eye, center, up), perspective(fov, near, far) with the
    # aspect ratio supplied by the caller)
    from kajo_tpu.utils import math3d

    scene = parser.load(CAUSTICS, 4.0 / 3.0)
    np.testing.assert_allclose(
        scene.camera.transform, math3d.look_at([-5, -2.5, 5], [0, 0, 0], [0, -1, 0]), atol=1e-6
    )
    np.testing.assert_allclose(
        scene.camera.projection, math3d.perspective(45.0, 4.0 / 3.0, 0.1, 100.0), atol=1e-6
    )
    ts = build_test_scene(4.0 / 3.0)
    np.testing.assert_allclose(scene.camera.projection, ts.camera.projection, atol=1e-6)


def test_perspective_reads_only_three_numbers():
    # test.json says perspective(45, 1.33, .1, 100): reference reads (45, 1.33, .1)
    # meaning near=1.33, far=.1 — quirky but replicated (Parser.cpp:156-161).
    scene = parser.loads(
        '{"camera": {"projection": "perspective(45, 1.33, .1, 100)"}, "objects": []}', 1.0
    )
    from kajo_tpu.utils import math3d

    expected = math3d.perspective(45.0, 1.0, 1.33, 0.1)
    np.testing.assert_allclose(scene.camera.projection, expected, atol=1e-6)


def test_rotate_then_translate_plane():
    # "rotate(-90, 1, 0, 0) translate(0, 2, 0)" composes left-to-right
    scene = parser.loads(
        '{"objects": [{"type": "plane", "transform": "rotate(-90, 1, 0, 0) translate(0, 2, 0)"}]}',
        1.0,
    )
    from kajo_tpu.utils import math3d

    expected = math3d.translate(math3d.rotate(math3d.identity(), -90, [1, 0, 0]), [0, 2, 0])
    np.testing.assert_allclose(scene.plane_transform[0], expected, atol=1e-6)


def test_material_defaults():
    scene = parser.loads('{"objects": [{"type": "sphere", "radius": 2}]}', 1.0)
    m = scene.materials
    np.testing.assert_allclose(m.diffuse[0], 0.0)
    np.testing.assert_allclose(m.specular_exponent[0], 0.0)
    np.testing.assert_allclose(m.refractive_index[0], 1.0)
    assert scene.light_indices == ()


def test_scene_is_pytree():
    import jax

    scene = build_test_scene()
    leaves = jax.tree.leaves(scene)
    assert all(hasattr(l, "dtype") for l in leaves)
    # static structure survives tree mapping
    mapped = jax.tree.map(lambda x: x, scene)
    assert mapped.light_indices == scene.light_indices


def test_one_arg_scale_is_zero_filled_parity():
    """``scale(.5)`` == scale(.5, 0, 0): the reference's parseVec3 leaves
    failed stream extractions at 0 (Parser.cpp:49-62), so one-arg scale is a
    DEGENERATE transform there too — replicated, and documented so scene
    files always write three components (data/scaled.json does)."""
    import numpy as np

    from kajo_tpu.scene.parser import parse_transform

    m = parse_transform("scale(.5)")
    np.testing.assert_allclose(np.diag(m), [0.5, 0.0, 0.0, 1.0])
    m3 = parse_transform("scale(.5, .5, .5)")
    np.testing.assert_allclose(np.diag(m3), [0.5, 0.5, 0.5, 1.0])
