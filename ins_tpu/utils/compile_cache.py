"""Persistent XLA compilation cache placement.

JAX reads `JAX_COMPILATION_CACHE_DIR` from the environment by itself, so
where it is set this module does nothing.  Otherwise the cache goes to a
fixed directory beside the package, `<repo>/.jax_cache`: the path is part
of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os

import jax

__all__ = ["CACHE_DIR", "enable_compile_cache"]

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache():
    """Point JAX's persistent compilation cache at `CACHE_DIR` unless
    `JAX_COMPILATION_CACHE_DIR` is set; returns the directory in effect."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
