"""Where the persistent XLA compilation cache lives.

A cache directory is part of the cache's key, so it must not move
between runs: `JAX_COMPILATION_CACHE_DIR` when the environment sets it,
otherwise one fixed directory inside the checkout (listed in
`.gitignore`).
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the fixed
    in-checkout default."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Turn the persistent cache on for this process; returns its
    directory.  Call before the first compilation."""
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)
    return path
