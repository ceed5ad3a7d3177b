"""Where the persistent XLA compile cache lives.

One rule for every entry point (the CLI, bench.py, chip_smoke.py): if
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is set
in code; otherwise the cache is ``<checkout>/.jax_cache``. The path must not
move between runs, because it is part of what a cache hit is looked up by.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    os.makedirs(CHECKOUT_CACHE, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE
