"""Persistent XLA compilation cache location.

Compiling the table loop for the card takes tens of seconds; the cache
keeps compiled programs across processes.  The path is part of a cache
entry's key, so it is fixed: ``JAX_COMPILATION_CACHE_DIR`` when set (JAX
reads that variable itself), otherwise ``.jax_cache`` at the root of the
source checkout.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
