"""Engine selection: pick the fastest renderer that supports the scene.

  * ``mega``   — fused Pallas Triton megakernel (ops/pallas/megakernel.py):
    any scene (rigid or general transforms) up to MAX_KERNEL_OBJECTS
    objects; CUDA GPUs only.
  * ``fast``   — regenerating jax wavefront (models/wavefront.py): any scene,
    any backend (including the chunked 100k-sphere path).
  * ``parity`` — fixed-shape scan (models/integrator.py): the estimator
    spec; differentiable; used by the gradient/inverse-rendering path.
"""

from __future__ import annotations

import jax

from ..ops.pallas import megakernel
from ..scene.types import Scene
from .integrator import RenderConfig, render_pass
from .wavefront import render_pass_fast


def select_engine(scene: Scene, requested: str = "auto") -> str:
    if requested == "mega" and not megakernel.available():
        raise ValueError(
            "engine 'mega' is a Pallas Triton kernel compiled for CUDA GPUs; "
            f"the {jax.default_backend()!r} backend cannot run it — use "
            "--engine fast (tests wrap calls in megakernel.interpret_mode())"
        )
    if requested != "auto":
        return requested
    if jax.default_backend() == "gpu" and megakernel.supports(scene):
        return "mega"
    return "fast"


def render_pass_engine(
    engine: str,
    scene: Scene,
    key: jax.Array,
    width: int,
    height: int,
    spp: int,
    config: RenderConfig = RenderConfig(),
):
    if engine == "mega":
        return megakernel.render_pass_megakernel(scene, key, width, height, spp, config)
    if engine == "fast":
        return render_pass_fast(scene, key, width, height, spp, config)
    return render_pass(scene, key, width, height, spp, config)
