"""Differentiable rendering and inverse-rendering optimization.

The integrator is differentiable end-to-end w.r.t. the scene pytree (sphere
transforms/radii, all material fields, camera): `prepare_scene` derives
inverses/determinants with jnp, samples are reparameterized, and discrete
branch probabilities are detached inside the integrator (see
models/integrator.py docstring). Visibility/silhouette discontinuities are
edge-sampled on request: ``edge_gradients=True`` adds the primary-silhouette
boundary term and ``shadow_edges=True`` the NEE-visibility (cast-shadow)
boundary term (diff/edges.py); without them gradients are exact for
shading/geometry interior terms and biased only at silhouettes.

This module provides the BASELINE.md config-4 workflow: recover sphere
position/radius/albedo from a target render by gradient descent, with
scene-parameter gradients all-reduced over the mesh automatically by XLA
(replicated params + sharded rays).
"""

from __future__ import annotations

import dataclasses

from typing import Any, Dict

import jax
import jax.numpy as jnp
import optax

from ..models.integrator import RenderConfig
from ..models.wavefront import render_pass_budget
from ..ops.pallas import megakernel
from ..parallel.render import render_pass_sharded
from ..scene.types import Scene

# Leaves exposed to the optimizer by default (config 4: position/radius/albedo).
DEFAULT_PARAM_SPEC = ("sphere_transform", "sphere_radius", "diffuse")


def extract_params(scene: Scene, spec=DEFAULT_PARAM_SPEC) -> Dict[str, jax.Array]:
    params = {}
    for name in spec:
        if hasattr(scene, name):
            params[name] = jnp.asarray(getattr(scene, name), jnp.float32)
        else:
            params[name] = jnp.asarray(getattr(scene.materials, name), jnp.float32)
    return params


def apply_params(scene: Scene, params: Dict[str, jax.Array]) -> Scene:
    mats = scene.materials
    scene_updates: Dict[str, Any] = {}
    mat_updates: Dict[str, Any] = {}
    for name, value in params.items():
        if hasattr(scene, name):
            scene_updates[name] = value
        else:
            mat_updates[name] = value
    if mat_updates:
        mats = dataclasses.replace(mats, **mat_updates)
    return dataclasses.replace(scene, materials=mats, **scene_updates)


def render_loss(
    params,
    scene: Scene,
    target: jax.Array,
    key: jax.Array,
    width: int,
    height: int,
    spp: int,
    config: RenderConfig = RenderConfig(),
    mesh=None,
    loss_clip=None,
):
    """Unbiased L2 loss between the stochastic render and the target.

    ``loss_clip`` clamps both render and target before comparing (display-space
    style): HDR direct-light pixels otherwise dominate the loss by orders of
    magnitude and their Monte-Carlo noise swamps every other gradient.

    Plain MSE of a noisy render against the target contains a θ-dependent
    *variance* term — E[(X(θ)-T)²] = (E[X]-T)² + Var[X(θ)] — which pulls the
    optimum toward low-variance (typically darker) parameters. We use the
    two-sample cross-estimator E[(X₁-T)(X₂-T)] with independent keys, whose
    expectation is exactly (E[X]-T)²: variance-blind, unbiased gradients.

    Unsharded runs use the differentiable regenerating wavefront (budget
    engine, ~3x the fixed-depth scan's gradient throughput); under a mesh
    the sharded parity path is used."""
    updated = apply_params(scene, params)
    k1, k2 = jax.random.split(key)
    if mesh is None:
        img1 = render_pass_budget(updated, k1, width, height, spp, config)
        img2 = render_pass_budget(updated, k2, width, height, spp, config)
    else:
        img1 = render_pass_sharded(updated, k1, width, height, spp, config, mesh)
        img2 = render_pass_sharded(updated, k2, width, height, spp, config, mesh)
    t = target[..., :3]
    i1, i2 = img1[..., :3], img2[..., :3]
    if loss_clip is not None:
        t = jnp.clip(t, 0.0, loss_clip)
        i1 = jnp.clip(i1, 0.0, loss_clip)
        i2 = jnp.clip(i2, 0.0, loss_clip)
    return jnp.mean((i1 - t) * (i2 - t))


@dataclasses.dataclass
class InverseRenderer:
    """Adam loop recovering scene parameters from a target image."""

    scene: Scene
    target: jax.Array
    width: int
    height: int
    spp: int = 4
    learning_rate: float = 2e-2
    config: RenderConfig = RenderConfig()
    mesh: Any = None
    param_spec: tuple = DEFAULT_PARAM_SPEC
    decay_steps: int = 0  # >0: cosine-decay the lr to 10% over this many steps
    # "auto"/"jax": reverse mode through the differentiable jax budget engine
    # (sharded parity scan under a mesh); "mega-fwd": see param_mask below.
    engine: str = "auto"
    loss_clip: Any = None  # clamp render+target in the loss (HDR stability)
    # Add the silhouette boundary term (diff/edges.py) to the render's VJP:
    # required whenever position/radius must be recovered through visibility
    # changes (interior autodiff is blind at silhouettes). jax engine only.
    edge_gradients: bool = False
    n_edge: int = 256
    # Also sample NEE-visibility (shadow) edges in the boundary term — needed
    # when the optimized sphere's signal is its cast shadow (diff/edges.py
    # shadow_silhouette_grads). Implies edge_gradients semantics.
    shadow_edges: bool = False
    n_shadow_edge: int = 4
    # engine="mega-fwd": gradients from the forward-mode megakernel — one
    # fused primal+tangent kernel per optimized scalar per render, for when
    # few scalars are optimized (sphere position/radius — BASELINE config
    # 4's geometry). GPU only (or megakernel.interpret_mode() in tests).
    # ``param_mask``: optional {name: bool array} restricting which entries
    # get directions (e.g. one sphere's translation column).
    param_mask: Any = None

    def __post_init__(self):
        if self.engine == "auto":
            self.engine = "jax"
        if self.engine not in ("jax", "mega-fwd"):
            raise ValueError(f"unknown engine {self.engine!r}: use 'auto', 'jax' or 'mega-fwd'")
        if self.engine == "mega-fwd" and not megakernel.available():
            raise ValueError(
                "engine='mega-fwd' runs the Pallas Triton megakernel, which "
                "needs a CUDA GPU; use engine='jax' here"
            )
        self.params = extract_params(self.scene, self.param_spec)
        if self.decay_steps:
            schedule = optax.cosine_decay_schedule(self.learning_rate, self.decay_steps, 0.1)
            self.opt = optax.adam(schedule)
        else:
            self.opt = optax.adam(self.learning_rate)
        self.opt_state = self.opt.init(self.params)

        cfg, mesh = self.config, self.mesh
        w, h, spp = self.width, self.height, self.spp

        # scene and target are closed over (they never change between steps):
        # as jit constants they fold into the compiled step, which both
        # compiles and runs much faster than passing them as traced arguments
        base_scene = jax.tree.map(jnp.asarray, self.scene)
        target = jnp.asarray(self.target)

        if self.engine == "mega-fwd":
            import numpy as np

            # enumerate optimized scalars -> one tangent direction each
            dirs = []
            for name, arr in self.params.items():
                size = int(np.asarray(arr).size)
                if self.param_mask and name in self.param_mask:
                    idxs = np.nonzero(np.asarray(self.param_mask[name]).ravel())[0]
                else:
                    idxs = np.arange(size)
                dirs.extend((name, int(i)) for i in idxs)
            if len(dirs) > 64:
                raise ValueError(
                    f"mega-fwd runs one kernel per optimized scalar; {len(dirs)} "
                    "directions is too many — restrict with param_mask or use the jax engine"
                )
            zero_tan = megakernel.scene_zero_tangent(base_scene)
            tans = []
            for name, i in dirs:
                pt = {
                    k: jnp.zeros_like(jnp.asarray(v, jnp.float32)) for k, v in self.params.items()
                }
                pt[name] = pt[name].reshape(-1).at[i].set(1.0).reshape(pt[name].shape)
                tans.append(apply_params(zero_tan, pt))
            stacked_tans = jax.tree.map(lambda *xs: jnp.stack(xs), *tans)
            clip = self.loss_clip
            npx = w * h * 3

            def loss_and_grad(params, key):
                updated = apply_params(base_scene, params)
                k1, k2 = jax.random.split(key)
                t = target[..., :3]
                if clip is not None:
                    t = jnp.clip(t, 0.0, clip)

                def one_dir(carry, tanscene):
                    i1, d1 = megakernel.render_pass_megakernel_jvp(
                        updated, tanscene, k1, w, h, spp, cfg
                    )
                    i2, d2 = megakernel.render_pass_megakernel_jvp(
                        updated, tanscene, k2, w, h, spp, cfg
                    )
                    i1, i2 = i1[..., :3], i2[..., :3]
                    d1, d2 = d1[..., :3], d2[..., :3]
                    if clip is not None:
                        d1 = jnp.where((i1 > 0) & (i1 < clip), d1, 0.0)
                        d2 = jnp.where((i2 > 0) & (i2 < clip), d2, 0.0)
                        i1 = jnp.clip(i1, 0.0, clip)
                        i2 = jnp.clip(i2, 0.0, clip)
                    loss = jnp.sum((i1 - t) * (i2 - t)) / npx
                    g = jnp.sum((i2 - t) * d1 + (i1 - t) * d2) / npx
                    return loss, g

                loss, gdirs = jax.lax.scan(one_dir, jnp.float32(0.0), stacked_tans)
                grads = {}
                pos = 0
                for name, arr in params.items():
                    size = int(np.asarray(self.params[name]).size)
                    own = [(j, i) for j, (n_, i) in enumerate(dirs) if n_ == name]
                    g_flat = jnp.zeros((size,), jnp.float32)
                    if own:
                        jidx = jnp.array([j for j, _ in own])
                        iidx = jnp.array([i for _, i in own])
                        g_flat = g_flat.at[iidx].set(gdirs[jidx])
                    grads[name] = g_flat.reshape(arr.shape)
                return loss, grads

            self._loss_and_grad = loss_and_grad

            def loss_fn(params, key):  # pragma: no cover - replaced by _loss_and_grad
                raise NotImplementedError

        elif self.edge_gradients or self.shadow_edges:
            from .edges import make_silhouette_term

            term = make_silhouette_term(
                w, h, cfg, self.n_edge, self.shadow_edges, self.n_shadow_edge
            )
            clip = self.loss_clip

            def loss_fn(params, key):
                updated = apply_params(base_scene, params)
                k1, k2, k3 = jax.random.split(key, 3)
                t = target[..., :3]
                edge = term(updated, k3)
                i1 = (render_pass_budget(updated, k1, w, h, spp, cfg) + edge)[..., :3]
                i2 = (render_pass_budget(updated, k2, w, h, spp, cfg) + edge)[..., :3]
                if clip is not None:
                    t = jnp.clip(t, 0.0, clip)
                    i1 = jnp.clip(i1, 0.0, clip)
                    i2 = jnp.clip(i2, 0.0, clip)
                return jnp.mean((i1 - t) * (i2 - t))

        else:

            def loss_fn(params, key):
                return render_loss(
                    params, base_scene, target, key, w, h, spp, cfg, mesh, self.loss_clip
                )

        if self.engine == "mega-fwd":
            lag = self._loss_and_grad
        else:

            def lag(params, key):
                return jax.value_and_grad(loss_fn)(params, key)

        @jax.jit
        def step(params, opt_state, key):
            loss, grads = lag(params, key)
            updates, opt_state = self.opt.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        self._step = step

    def step(self, key: jax.Array):
        self.params, self.opt_state, loss = self._step(self.params, self.opt_state, key)
        return float(loss)

    def run(self, steps: int, key: jax.Array):
        losses = []
        for i in range(steps):
            losses.append(self.step(jax.random.fold_in(key, i)))
        return losses

    def current_scene(self) -> Scene:
        return apply_params(self.scene, self.params)
