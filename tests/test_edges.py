"""Edge-aware (silhouette) gradients vs finite differences.

The probe scene is the hardest case for interior autodiff: a self-luminous
(flat-lit) sphere on a uniform background — its radiance carries NO shading
gradient, so the only signal for position/radius is the silhouette moving
across pixels. Interior gradients are exactly zero; the boundary term must
match finite differences of the rendered loss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from kajo_tpu.diff.edges import make_silhouette_term, silhouette_loss_grads
from kajo_tpu.models.integrator import RenderConfig, render_image
from kajo_tpu.scene.types import Camera, make_scene
from kajo_tpu.utils import math3d

W = H = 32
CFG = RenderConfig(max_depth=2)


def _edge_scene(cx=0.0, cy=0.0, radius=1.0):
    camera = Camera(
        transform=math3d.look_at([0, 0, -5], [0, 0, 0], [0, -1, 0]),
        projection=math3d.perspective(45.0, 1.0, 0.1, 100.0),
    )
    spheres = [
        {
            "transform": math3d.translate(math3d.identity(), [cx, cy, 0.0]),
            "radius": float(radius),
            "material": {"emission": np.array([2.0, 2.0, 2.0, 0.0], np.float32)},
        }
    ]
    return make_scene(camera, np.array([0.3, 0.3, 0.3, 1.0], np.float32), [], spheres)


def _loss(scene, cot, spp=64, passes=6):
    img = render_image(scene, W, H, spp, jax.random.PRNGKey(0), passes=passes, config=CFG)
    return float(jnp.sum(cot * img[..., :3]))


def _cot_ramp():
    x = jnp.arange(W, dtype=jnp.float32) / W
    return jnp.broadcast_to(x[None, :, None], (H, W, 3))


def test_position_gradient_matches_fd():
    cot = _cot_ramp()
    scene = _edge_scene()
    gc, gr = silhouette_loss_grads(
        scene, jax.random.PRNGKey(1), cot, W, H, CFG, n_edge=2048
    )
    h = 0.05
    fd = (_loss(_edge_scene(cx=h), cot) - _loss(_edge_scene(cx=-h), cot)) / (2 * h)
    assert abs(fd) > 1.0  # the signal exists and is silhouette-only
    np.testing.assert_allclose(gc[0, 0], fd, rtol=0.15)
    # y-ramp cotangent has no y-asymmetry here: x-gradient dominates y
    assert abs(gc[0, 0]) > 5 * abs(gc[0, 1])


def test_radius_gradient_matches_fd():
    cot = jnp.ones((H, W, 3), jnp.float32)
    scene = _edge_scene()
    gc, gr = silhouette_loss_grads(
        scene, jax.random.PRNGKey(2), cot, W, H, CFG, n_edge=2048
    )
    h = 0.03
    fd = (_loss(_edge_scene(radius=1.0 + h), cot) - _loss(_edge_scene(radius=1.0 - h), cot)) / (2 * h)
    assert fd > 10.0  # growing a bright sphere on a dark background
    np.testing.assert_allclose(gr[0], fd, rtol=0.15)
    # uniform cotangent: position gradients vanish by symmetry
    assert abs(gc[0, 0]) < 0.1 * fd


def test_residual_cotangent_y_gradient_sign():
    """Regression: with an MSE-residual cotangent (sign flips across the
    rim), a one-row error in the edge-pixel lookup flips the y-gradient —
    check both position components against FD of the actual MSE loss."""
    target = render_image(_edge_scene(0.0, 0.0), W, H, 16, jax.random.PRNGKey(7), passes=4, config=CFG)
    start = _edge_scene(0.5, -0.35)
    img = render_image(start, W, H, 16, jax.random.PRNGKey(8), passes=4, config=CFG)
    cot = 2.0 * (img[..., :3] - target[..., :3]) / (W * H * 3)
    gc, _ = silhouette_loss_grads(start, jax.random.PRNGKey(1), cot, W, H, CFG, n_edge=4096)

    def loss_of(cx, cy):
        s = _edge_scene(cx, cy)
        i = render_image(s, W, H, 16, jax.random.PRNGKey(8), passes=4, config=CFG)
        return float(jnp.mean((i[..., :3] - target[..., :3]) ** 2))

    h = 0.05
    fdx = (loss_of(0.5 + h, -0.35) - loss_of(0.5 - h, -0.35)) / (2 * h)
    fdy = (loss_of(0.5, -0.35 + h) - loss_of(0.5, -0.35 - h)) / (2 * h)
    np.testing.assert_allclose(gc[0, 0], fdx, rtol=0.25)
    np.testing.assert_allclose(gc[0, 1], fdy, rtol=0.25)
    assert np.sign(gc[0, 0]) == np.sign(fdx) and np.sign(gc[0, 1]) == np.sign(fdy)


def _shadow_scene(ox=2.0, oz=0.0, radius=0.4):
    """Occluder OUTSIDE the camera frustum casting a shadow on a floor:
    the image depends on the occluder ONLY through NEE visibility (depth-1
    render: no bounces, absorbing occluder), the case
    `shadow_silhouette_grads` exists for. y grows downward (testscene.py
    convention): floor y=+1, light high above at y=-5."""
    camera = Camera(
        transform=math3d.look_at([3.0, -2.0, 0.0], [3.0, 1.0, 0.0], [0, 0, 1]),
        projection=math3d.perspective(30.0, 1.0, 0.1, 100.0),
    )
    planes = [
        {
            "transform": math3d.translate(math3d.identity(), [0.0, 1.0, 0.0]),
            "material": {"diffuse": np.array([0.8, 0.8, 0.8, 1.0], np.float32)},
        }
    ]
    spheres = [
        {
            "transform": math3d.translate(math3d.identity(), [ox, -1.0, oz]),
            "radius": float(radius),
            "material": {},  # fully absorbing: RR kills any path that hits it
        },
        {
            "transform": math3d.translate(math3d.identity(), [0.0, -5.0, 0.0]),
            "radius": 0.5,
            "material": {"emission": np.array([30.0, 30.0, 30.0, 0.0], np.float32)},
        },
    ]
    return make_scene(camera, np.array([0.0, 0.0, 0.0, 1.0], np.float32), planes, spheres)


SHADOW_CFG = RenderConfig(max_depth=1)


def _shadow_loss(scene, cot, spp=64, passes=6):
    img = render_image(
        scene, W, H, spp, jax.random.PRNGKey(0), passes=passes, config=SHADOW_CFG
    )
    return float(jnp.sum(cot * img[..., :3]))


def test_shadow_position_gradient_matches_fd():
    from kajo_tpu.diff.edges import shadow_silhouette_grads
    from kajo_tpu.models.wavefront import render_pass_budget

    cot = _cot_ramp()
    scene = _shadow_scene()
    gc, gr = shadow_silhouette_grads(
        scene, jax.random.PRNGKey(1), cot, W, H, SHADOW_CFG, n_edge=64
    )
    h = 0.05
    fd = (
        _shadow_loss(_shadow_scene(ox=2.0 + h), cot)
        - _shadow_loss(_shadow_scene(ox=2.0 - h), cot)
    ) / (2 * h)
    assert abs(fd) > 0.3, fd  # the shadow moves: signal exists
    np.testing.assert_allclose(gc[0, 0], fd, rtol=0.3)

    # interior autodiff really is blind to the occluder here
    def interior(st):
        s = dataclasses.replace(jax.tree.map(jnp.asarray, scene), sphere_transform=st)
        img = render_pass_budget(s, jax.random.PRNGKey(0), W, H, 16, SHADOW_CFG)
        return jnp.sum(cot * img[..., :3])

    g_int = jax.grad(interior)(jnp.asarray(scene.sphere_transform))
    assert abs(float(g_int[0, 0, 3])) < 0.1 * abs(fd)


def test_shadow_radius_gradient_matches_fd():
    from kajo_tpu.diff.edges import shadow_silhouette_grads

    cot = jnp.ones((H, W, 3), jnp.float32)
    scene = _shadow_scene()
    gc, gr = shadow_silhouette_grads(
        scene, jax.random.PRNGKey(2), cot, W, H, SHADOW_CFG, n_edge=64
    )
    h = 0.03
    fd = (
        _shadow_loss(_shadow_scene(radius=0.4 + h), cot)
        - _shadow_loss(_shadow_scene(radius=0.4 - h), cot)
    ) / (2 * h)
    assert fd < -1.0, fd  # growing the occluder darkens the floor
    np.testing.assert_allclose(gr[0], fd, rtol=0.3)


def test_inverse_recovery_from_cast_shadow():
    """Recover an out-of-frame occluder's position from its cast shadow —
    only the NEE-visibility boundary term can drive it."""
    from kajo_tpu.diff.inverse import InverseRenderer

    target = render_image(
        _shadow_scene(ox=2.0), W, H, 16, jax.random.PRNGKey(7), passes=2, config=SHADOW_CFG
    )
    inv = InverseRenderer(
        _shadow_scene(ox=2.3),
        target,
        W,
        H,
        spp=16,
        config=SHADOW_CFG,
        param_spec=("sphere_transform",),
        shadow_edges=True,
        n_shadow_edge=8,
        n_edge=64,
        learning_rate=3e-2,
    )
    assert inv.engine == "jax"
    inv.run(25, jax.random.PRNGKey(9))
    err = abs(float(inv.params["sphere_transform"][0, 0, 3]) - 2.0)
    assert err < 0.12, err


def test_interior_autodiff_is_blind_here():
    """Confirms the premise: the budget engine's interior gradient carries no
    position signal for the flat-lit sphere."""
    from kajo_tpu.models.wavefront import render_pass_budget

    cot = _cot_ramp()

    def loss(st):
        s = dataclasses.replace(_edge_scene(), sphere_transform=st)
        s = jax.tree.map(jnp.asarray, s)
        img = render_pass_budget(s, jax.random.PRNGKey(0), W, H, 16, CFG)
        return jnp.sum(cot * img[..., :3])

    g = jax.grad(loss)(jnp.asarray(_edge_scene().sphere_transform))
    # translation column gradient ~ 0 (no shading dependence on position)
    assert abs(float(g[0, 0, 3])) < 0.5  # vs the true boundary gradient ~75


def test_silhouette_term_composes_with_autodiff():
    """make_silhouette_term: zero primal, boundary VJP through a real loss."""
    term = make_silhouette_term(W, H, CFG, n_edge=1024)
    cot = _cot_ramp()
    base = _edge_scene()

    def loss(st):
        s = dataclasses.replace(jax.tree.map(jnp.asarray, base), sphere_transform=st)
        img = term(s, jax.random.PRNGKey(3))
        return jnp.sum(cot * img[..., :3])

    st = jnp.asarray(base.sphere_transform)
    assert float(loss(st)) == 0.0  # primal adds nothing
    g = jax.grad(loss)(st)
    gc, _ = silhouette_loss_grads(base, jax.random.PRNGKey(3), cot, W, H, CFG, 1024)
    np.testing.assert_allclose(np.asarray(g[0, :3, 3]), np.asarray(gc[0]), rtol=1e-5)


def test_inverse_renderer_edge_gradients_api():
    """InverseRenderer(edge_gradients=True) drives position through the
    silhouette term (the config-4 workflow surface)."""
    from kajo_tpu.diff.inverse import InverseRenderer

    target = render_image(_edge_scene(cx=0.0), W, H, 16, jax.random.PRNGKey(7), passes=2, config=CFG)
    inv = InverseRenderer(
        _edge_scene(cx=0.5),
        target,
        W,
        H,
        spp=16,
        config=CFG,
        param_spec=("sphere_transform",),
        edge_gradients=True,
        n_edge=512,
        learning_rate=5e-2,
    )
    assert inv.engine == "jax"
    inv.run(25, jax.random.PRNGKey(9))
    err = abs(float(inv.params["sphere_transform"][0, 0, 3]))
    assert err < 0.25, err


def test_inverse_position_recovery_through_silhouette():
    """The config-4 completion: recover a flat-lit sphere's position where
    interior gradients are zero — only the edge term can drive it."""
    import optax

    target_scene = _edge_scene(cx=0.0)
    target = render_image(target_scene, W, H, 16, jax.random.PRNGKey(7), passes=2, config=CFG)

    term = make_silhouette_term(W, H, CFG, n_edge=512)
    from kajo_tpu.models.wavefront import render_pass_budget

    start = _edge_scene(cx=0.6)
    base = jax.tree.map(jnp.asarray, start)

    @jax.jit
    def loss_fn(st, key):
        s = dataclasses.replace(base, sphere_transform=st)
        k1, k2 = jax.random.split(key)
        img = render_pass_budget(s, k1, W, H, 16, CFG) + term(s, k2)
        return jnp.mean((img[..., :3] - target[..., :3]) ** 2)

    st = jnp.asarray(start.sphere_transform)
    opt = optax.adam(5e-2)
    state = opt.init(st)
    err0 = abs(float(st[0, 0, 3]))

    @jax.jit
    def step(st, state, key):
        g = jax.grad(loss_fn)(st, key)
        upd, state = opt.update(g, state)
        return optax.apply_updates(st, upd), state

    for i in range(40):
        st, state = step(st, state, jax.random.fold_in(jax.random.PRNGKey(8), i))
    err = abs(float(st[0, 0, 3]))
    assert err < 0.25 * err0, (err0, err)

