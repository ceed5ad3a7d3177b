"""Test configuration: force an 8-device virtual CPU platform.

Tests exercise multi-device sharding on a virtual mesh (SURVEY.md §4) and
the Pallas megakernel through its interpreter. ``jax_platforms`` is set
through jax.config before first backend use, so the CPU is used even where
JAX has a CUDA backend; what only the card can check (the compiled Triton
kernels) is run by chip_smoke.py.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

from kajo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# persistent compile cache makes repeated test runs cheap
enable_compile_cache()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
# in-repo scenes: caustics.json exercises all four BSDFs and the light (the
# stand-in for the reference's spheres.json); scaled.json the non-rigid
# object-space record
CAUSTICS = os.path.join(DATA, "caustics.json")
SCALED = os.path.join(DATA, "scaled.json")

