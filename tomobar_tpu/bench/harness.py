"""Benchmark + quality harness.

The reference times with ``timeit.default_timer`` in demos and NVTX ranges
in (disabled) perf tests (SURVEY.md §5-6); here timing and quality
measurement are a first-class module:

* :func:`time_fn` — steady-state timing of a jitted callable, each call
  ended by ``jax.block_until_ready``.
* :func:`rmse` / :func:`rel_rmse` — the RMSE-vs-phantom quality metric the
  reference demos compute via TomoPhantom's QualityTools
  (``Demos/tomophantom_3D_recon1.py:140-142``).
* :func:`trace` — context manager around ``jax.profiler`` for on-demand
  device traces.
"""

from __future__ import annotations

import contextlib
import timeit
from typing import Callable

import jax
import numpy as np

__all__ = ["time_fn", "rmse", "rel_rmse", "trace"]


def time_fn(fn: Callable, *args, warmup: int = 1, reps: int = 5) -> float:
    """Mean wall-clock seconds per call after ``warmup`` calls."""
    for _ in range(max(warmup, 1)):
        jax.block_until_ready(fn(*args))
    t0 = timeit.default_timer()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (timeit.default_timer() - t0) / reps


def rmse(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def rel_rmse(rec, ref) -> float:
    ref_n = np.sqrt(np.mean(np.asarray(ref, dtype=np.float64) ** 2))
    return rmse(rec, ref) / max(ref_n, 1e-30)


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace(dir): ...`` captures a jax.profiler device trace."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
