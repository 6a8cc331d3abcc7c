"""Persistent XLA compilation cache shared by every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and nothing
is set here.  Otherwise the cache lives at a fixed ``<checkout>/.jax_cache``:
the directory is part of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache"))


def cache_dir() -> str:
    """The directory compiled programs are cached in."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()``; returns
    the directory.  Call before the first compilation."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
