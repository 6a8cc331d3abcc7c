"""Compile-cache directory choice (utils/compile_cache)."""

import os

import jax

from stereo_tpu.utils import compile_cache


def test_cache_dir_follows_env_var(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.cache_dir() == str(tmp_path)
    assert compile_cache.enable() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert compile_cache.cache_dir() == want
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
