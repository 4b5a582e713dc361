"""Persistent XLA compile cache, one rule for every entry point."""

from __future__ import annotations

import os

__all__ = ["CACHE_ENV", "compile_cache_dir", "enable_compile_cache"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """`$JAX_COMPILATION_CACHE_DIR` when set, else `<checkout>/.jax_cache`
    (a fixed path: the cache is keyed by it, so it must not move)."""
    return os.environ.get(CACHE_ENV) or os.path.join(_REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at `compile_cache_dir()`. When
    the environment variable is set JAX already reads it, so nothing else
    is set. Returns the directory."""
    path = compile_cache_dir()
    if not os.environ.get(CACHE_ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
