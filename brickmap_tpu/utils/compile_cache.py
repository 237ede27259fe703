"""The persistent compilation cache, set up one way for every entry point.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here.  Otherwise the cache lives at one fixed, git-ignored path
inside the checkout, so that the next run of the same checkout finds it
(the path is part of what the cache is keyed on).
"""

from __future__ import annotations

import os

__all__ = ["CACHE_DIR", "enable_compile_cache"]

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's compilation cache at its directory; returns the path."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
