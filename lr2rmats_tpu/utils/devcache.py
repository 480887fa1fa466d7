"""Persistent XLA compilation cache for the device paths.

`run` (pipeline/stages.py), bench.py and chip_smoke.py call
`enable_compile_cache()` before their first compile.  The cache lives in
`JAX_COMPILATION_CACHE_DIR` when that is set, and otherwise at the fixed
path `<repo>/.jax_cache` (listed in .gitignore).  The directory is part of
the cache key, so it never depends on the process id or a temp dir.
"""

from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """Where compiled executables are kept."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at `cache_dir()` and cache every
    executable; returns the directory.  Idempotent."""
    import jax
    cache = cache_dir()
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache
