"""Persistent XLA compilation cache for cold-start latency.

The fused pipelines compile in seconds per (shape, strategy) configuration;
the streamed big-scene path compiles one program per (chunk-shape, pass).
A persistent cache makes every program after the first process a disk hit.

Enabled by the CLI/GUI entry points; library users call
`enable_compilation_cache()` themselves (a global jax.config mutation is
not something a library should do on import). Where the environment sets
`JAX_COMPILATION_CACHE_DIR`, JAX reads it on its own and this module sets
nothing; otherwise the cache lives at a fixed path inside the checkout
(`.jax_cache/`, gitignored) — the path is part of the cache key, so a
directory that moved would never hit.
"""
from __future__ import annotations

import os
import pathlib

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    DEFAULT_DIR.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    # cache even quick compiles: the streamed path dispatches several
    # small per-pass programs whose compile times sit near the default 1 s
    # threshold
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    return str(DEFAULT_DIR)
