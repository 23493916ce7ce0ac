"""PD-TV (the XLA Chambolle-Pock chain in regularisers.py) against an
independent float64 NumPy transcription of the reference's fused CUDA
iteration (``primal_dual_for_total_variation.cu``): dual ascent on
forward differences with a reflected end, TV-ball projection (iso/aniso),
zero-boundary backward-difference divergence, relaxed primal step."""

import numpy as np
import pytest

from tomobar_tpu.regularisers import PD_TV


def _fwd(u, ax):
    nxt = np.concatenate(
        [np.take(u, range(1, u.shape[ax]), axis=ax),
         np.take(u, [u.shape[ax] - 2], axis=ax)], axis=ax,
    )
    return nxt - u


def _bwd_zero(p, ax):
    prev = np.concatenate(
        [np.zeros_like(np.take(p, [0], axis=ax)),
         np.take(p, range(0, p.shape[ax] - 1), axis=ax)], axis=ax,
    )
    return p - prev


def pd_tv_numpy(data, lam, iters, method_tv, nonneg, lip=8.0):
    f = np.asarray(data, np.float64)
    squeeze = f.ndim == 3 and f.shape[0] == 1
    if squeeze:
        f = f[0]
    axes = [-1, -2] + ([-3] if f.ndim == 3 else [])
    tau = lam * 0.1
    sigma = 1.0 / (lip * tau)
    lt = tau / lam
    u = f.copy()
    ps = [np.zeros_like(f) for _ in axes]
    for _ in range(iters):
        ps = [p + sigma * _fwd(u, ax) for p, ax in zip(ps, axes)]
        if method_tv == 0:
            nrm = sum(p * p for p in ps)
            scale = np.where(nrm > 1.0, 1.0 / np.sqrt(np.maximum(nrm, 1e-30)), 1.0)
            ps = [p * scale for p in ps]
        else:
            ps = [p / np.maximum(np.abs(p), 1.0) for p in ps]
        div = sum(_bwd_zero(p, ax) for p, ax in zip(ps, axes))
        uc = np.maximum(u, 0.0) if nonneg else u
        u_new = (uc + tau * div + lt * f) / (1.0 + lt)
        u = u_new + (u_new - uc)
    return u[None] if squeeze else u


def _data(nz, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((nz, 16, 24)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("method_tv", [0, 1], ids=["iso", "aniso"])
@pytest.mark.parametrize("nonneg", [0, 1])
def test_matches_numpy_reference(method_tv, nonneg):
    x = _data(3)
    got = PD_TV(x, 0.1, 15, method_tv, nonneg, 8.0)
    want = pd_tv_numpy(x, 0.1, 15, method_tv, nonneg, 8.0)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("nz", [1, 2, 3])
def test_slab_thickness(nz):
    """nz = 1 is a 2D problem (the singleton axis is squeezed and restored,
    regularisersCuPy.py:164-167); thicker slabs couple slices along z."""
    x = _data(nz, seed=nz)
    got = PD_TV(x, 0.05, 12, 0, 1, 8.0)
    want = pd_tv_numpy(x, 0.05, 12, 0, 1, 8.0)
    assert got.shape == (nz, 16, 24)
    assert _rel(got, want) < 1e-5


def test_bf16_duals_stay_close():
    x = _data(3, seed=7)
    got = PD_TV(x, 0.1, 15, 0, 0, 8.0, half_precision=True)
    want = pd_tv_numpy(x, 0.1, 15, 0, 0, 8.0)
    # the duals are stored in bfloat16 (8 mantissa bits)
    assert _rel(got, want) < 2e-2
    assert _rel(got, want) > 1e-6  # the duals really were rounded
