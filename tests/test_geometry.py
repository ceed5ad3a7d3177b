"""Geometry tests: sphere/plane intersection, nearest-hit, camera rays."""

import jax.numpy as jnp
import numpy as np

from kajo_tpu.ops import geometry
from kajo_tpu.scene import parser
from kajo_tpu.scene.testscene import build_test_scene
from kajo_tpu.utils import math3d

from conftest import CAUSTICS


def _scene_from_objects(planes=(), spheres=()):
    from kajo_tpu.scene.types import Camera, make_scene

    return make_scene(Camera.default(), np.zeros(4, np.float32), list(planes), list(spheres))


def _sphere(center, radius, **mat):
    return {
        "transform": math3d.translate(math3d.identity(), center),
        "radius": radius,
        "material": mat,
    }


def test_sphere_hit_distance_and_normal():
    scene = _scene_from_objects(spheres=[_sphere([3, 0, 0], 1.0)])
    prep = geometry.prepare_scene(scene)
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[1.0, 0.0, 0.0]])
    hit = geometry.trace(prep, o, d)
    np.testing.assert_allclose(hit.t, [2.0], rtol=1e-5)
    np.testing.assert_allclose(hit.position, [[2, 0, 0]], atol=1e-5)
    np.testing.assert_allclose(hit.normal, [[-1, 0, 0]], atol=1e-5)
    assert int(hit.obj[0]) == 0
    # frame is orthonormal
    np.testing.assert_allclose(np.dot(hit.normal[0], hit.tangent[0]), 0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(hit.binormal[0]), 1, atol=1e-5)


def test_ray_from_inside_sphere():
    scene = _scene_from_objects(spheres=[_sphere([0, 0, 0], 2.0)])
    prep = geometry.prepare_scene(scene)
    hit = geometry.trace(prep, jnp.zeros((1, 3)), jnp.array([[0.0, 0.0, 1.0]]))
    np.testing.assert_allclose(hit.t, [2.0], rtol=1e-5)
    # normal points outward (object-space hit point direction)
    np.testing.assert_allclose(hit.normal, [[0, 0, 1]], atol=1e-5)


def test_plane_negated_normal():
    # ground plane translate(0,1,0): world normal = -rotated(0,1,0) = (0,-1,0)
    planes = [{"transform": math3d.translate(math3d.identity(), [0, 1, 0]), "material": {}}]
    scene = _scene_from_objects(planes=planes)
    prep = geometry.prepare_scene(scene)
    hit = geometry.trace(prep, jnp.zeros((1, 3)), jnp.array([[0.0, 1.0, 0.0]]))
    np.testing.assert_allclose(hit.t, [1.0], rtol=1e-6)
    np.testing.assert_allclose(hit.normal, [[0, -1, 0]], atol=1e-6)
    np.testing.assert_allclose(hit.position, [[0, 1, 0]], atol=1e-6)


def test_parallel_ray_misses_plane():
    planes = [{"transform": math3d.translate(math3d.identity(), [0, 1, 0]), "material": {}}]
    scene = _scene_from_objects(planes=planes)
    prep = geometry.prepare_scene(scene)
    hit = geometry.trace(prep, jnp.zeros((1, 3)), jnp.array([[1.0, 0.0, 0.0]]))
    assert int(hit.obj[0]) == -1
    assert not bool(jnp.isfinite(hit.t[0]))


def test_nearest_hit_wins():
    scene = _scene_from_objects(
        spheres=[_sphere([6, 0, 0], 1.0), _sphere([3, 0, 0], 1.0)]
    )
    prep = geometry.prepare_scene(scene)
    hit = geometry.trace(prep, jnp.zeros((1, 3)), jnp.array([[1.0, 0.0, 0.0]]))
    assert int(hit.obj[0]) == 1  # second sphere is nearer
    np.testing.assert_allclose(hit.t, [2.0], rtol=1e-5)


def test_behind_ray_ignored():
    scene = _scene_from_objects(spheres=[_sphere([-3, 0, 0], 1.0)])
    prep = geometry.prepare_scene(scene)
    hit = geometry.trace(prep, jnp.zeros((1, 3)), jnp.array([[1.0, 0.0, 0.0]]))
    assert int(hit.obj[0]) == -1


def test_rotated_scaled_sphere_det_semantics():
    # determinant-scaled t: reference quirk (Raytracer.cpp:70). For a
    # uniformly scaled sphere, reported t is world-t * det. Bug-compatible.
    t = math3d.scale(math3d.translate(math3d.identity(), [3, 0, 0]), [2, 2, 2])
    scene = _scene_from_objects(spheres=[{"transform": t, "radius": 1.0, "material": {}}])
    prep = geometry.prepare_scene(scene)
    hit = geometry.trace(prep, jnp.zeros((1, 3)), jnp.array([[1.0, 0.0, 0.0]]))
    np.testing.assert_allclose(hit.t, [1.0 * 8.0], rtol=1e-4)  # world t=1, det=8


def test_spheres_json_primary_rays():
    scene = parser.load(CAUSTICS, 4.0 / 3.0)
    prep = geometry.prepare_scene(scene)
    basis = prep.camera
    # center-of-image ray must hit something (the scene encloses the camera)
    sx = jnp.array([0.5])
    sy = jnp.array([0.5])
    o, d = geometry.generate_rays(basis, sx, sy)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, rtol=1e-6)
    hit = geometry.trace(prep, o, d)
    assert int(hit.obj[0]) != -1
    # full image: every ray hits (closed box of walls)
    xs, ys = jnp.meshgrid(jnp.linspace(0.01, 0.99, 32), jnp.linspace(0.01, 0.99, 24))
    o, d = geometry.generate_rays(basis, xs.ravel(), ys.ravel())
    hit = geometry.trace(prep, o, d)
    assert bool(jnp.all(hit.obj >= 0))
    # the light sphere (object id planes+3 = 9) should be visible somewhere
    assert bool(jnp.any(hit.obj == scene.num_planes + scene.light_indices[0]))


def test_camera_basis_matches_reference_goldens():
    ts = build_test_scene()
    basis = geometry.camera_basis(ts.camera)
    np.testing.assert_allclose(
        np.asarray(basis.origin), [-6.00000048, -0.800000072, 4], atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(basis.p1), [-5.89046764, -0.747805119, 3.9933548], atol=1e-5
    )


def test_rigid_fast_path_matches_general_path():
    # same scene traced via the world-space fast path and the object-space
    # general path must agree to float tolerance
    import dataclasses
    import jax

    scene = parser.load(CAUSTICS, 4.0 / 3.0)
    assert scene.rigid_spheres
    general = dataclasses.replace(scene, rigid_spheres=False)

    xs, ys = jnp.meshgrid(jnp.linspace(0.01, 0.99, 48), jnp.linspace(0.01, 0.99, 32))
    for sc in [scene]:
        prep_r = geometry.prepare_scene(scene)
        prep_g = geometry.prepare_scene(general)
        o, d = geometry.generate_rays(prep_r.camera, xs.ravel(), ys.ravel())
        hr = geometry.trace(prep_r, o, d)
        hg = geometry.trace(prep_g, o, d)
        np.testing.assert_array_equal(np.asarray(hr.obj), np.asarray(hg.obj))
        np.testing.assert_allclose(np.asarray(hr.t), np.asarray(hg.t), rtol=2e-5)
        # grazing rays see slightly different catastrophic-cancellation noise
        # between the two (mathematically identical) quadratic arrangements
        np.testing.assert_allclose(np.asarray(hr.normal), np.asarray(hg.normal), atol=1e-3)
        np.testing.assert_allclose(np.asarray(hr.tangent), np.asarray(hg.tangent), atol=5e-3)


def test_scaled_scene_not_rigid():
    t = math3d.scale(math3d.identity(), [2, 2, 2])
    scene = _scene_from_objects(spheres=[{"transform": t, "radius": 1.0, "material": {}}])
    assert not scene.rigid_spheres
