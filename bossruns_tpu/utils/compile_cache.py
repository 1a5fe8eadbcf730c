"""Placement of JAX's persistent compilation cache.

The cache key includes the cache directory, so every entry point uses the
same one: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it (JAX
reads that variable itself, so nothing is overridden), otherwise
``<repo>/.jax_cache`` (gitignored).
"""
from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; return it.

    Call before the first compilation. Programs that compile in under a
    second are not worth a disk entry."""
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    env_dir = os.environ.get(ENV)
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
