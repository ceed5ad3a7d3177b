"""Where the persistent compile cache goes (kajo_tpu/utils/compile_cache.py)."""

import os

import jax

from kajo_tpu.utils import compile_cache

from conftest import REPO


def test_env_var_wins_and_nothing_is_set_in_code(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_one_fixed_path_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.enable_compile_cache()
    assert first == compile_cache.enable_compile_cache() == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == first
    assert os.path.isdir(first)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
