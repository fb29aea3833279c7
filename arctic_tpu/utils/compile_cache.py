"""Where compiled XLA programs persist between runs.

A cold frame program takes tens of seconds to compile; JAX's persistent
compilation cache keeps the result on disk. The cache key includes the
directory, so it must not move between runs: ``JAX_COMPILATION_CACHE_DIR``
when set (JAX reads that variable itself), otherwise ``<repo>/.jax_cache``.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
