"""Placement of JAX's persistent compilation cache.

Every entry point (bench.py, chip_smoke.py, __graft_entry__.py, tools/,
tests/conftest.py) calls `configure_compile_cache()` before its first
compile, so all of them share one cache per checkout.
"""
from __future__ import annotations

import os
import pathlib

import jax

CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> str:
    """Use $JAX_COMPILATION_CACHE_DIR when it is set (JAX reads it
    itself), else `<checkout>/.jax_cache`. Returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(CHECKOUT_CACHE)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
