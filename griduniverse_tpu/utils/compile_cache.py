"""Persistent XLA compilation cache for the entry-point scripts.

`enable_compile_cache()` is called by `chip_smoke.py`, `bench.py` and the
example scripts (never by the tests). Where `JAX_COMPILATION_CACHE_DIR`
is set, JAX already reads it and nothing else is set. Otherwise the cache
goes to `<checkout>/.jax_cache`, a fixed path (git-ignored): the path is
part of the cache's key, so a directory that moved between runs would
never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return jax.config.jax_compilation_cache_dir
