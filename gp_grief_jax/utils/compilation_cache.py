"""Persistent XLA compilation cache.

Entry points (bench.py, chip_smoke.py, benchmarks/, __graft_entry__.py,
the CLI) opt in; library imports stay side-effect free.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets no other directory; otherwise the cache lives at the fixed in-checkout
path :data:`DEFAULT_DIR` (the path is part of the cache key, so it must not
move between runs).
"""

from __future__ import annotations

import os

__all__ = ["enable_compilation_cache", "cache_dir"]

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory :func:`enable_compilation_cache` uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compilation_cache(min_compile_secs: float = 1.0) -> str:
    """Enable JAX's persistent compilation cache (idempotent, pre- or
    post-first-compile; applies to compiles that happen after the call).
    Returns the cache directory."""
    import jax

    path = cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", float(min_compile_secs))
    return path
