"""The persistent compilation cache every entry point uses."""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE = Path(__file__).resolve().parents[2] / ".cache" / "jax_cc"


def enable_compile_cache() -> str:
    """Keep compiled executables across processes.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and it is
    left alone. Otherwise the cache lives at the fixed ``<repo>/.cache/jax_cc``:
    the path is part of the cache key, so it must not move between runs.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    REPO_CACHE.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    return str(REPO_CACHE)
