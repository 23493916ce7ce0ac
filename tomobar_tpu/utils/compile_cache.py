"""Where JAX keeps its persistent compilation cache for this repository.

One rule for every entry point (tests, benchmarks, ``chip_smoke.py``):
when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set in code; otherwise the cache is the fixed ``.jax_cache/``
directory at the checkout root (listed in ``.gitignore``).  A fixed path
matters: the path is part of what a later run looks up, so a directory
that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["enable_compile_cache", "CHECKOUT_CACHE_DIR"]

CHECKOUT_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compile_cache() -> str:
    """Apply the rule above and return the cache directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return CHECKOUT_CACHE_DIR
