"""Proximal regularisers: ROF-TV and PD-TV (Chambolle-Pock).

Numerical semantics replicate the reference's fused CUDA kernels:

* ROF-TV: ``tomobar/cuda_kernels/rudin_osher_fatemi_total_variation.cu``
  (normalised forward differences with minmod denominators + explicit
  time-marching update, Neumann/reflect boundaries).
* PD-TV: ``tomobar/cuda_kernels/primal_dual_for_total_variation.cu``
  (one fused primal-dual iteration: dual ascent + TV-ball projection
  (iso/aniso), backward-difference divergence, relaxed primal step).

Implementation notes: each iteration is a chain of elementwise ops and
1-pixel shifts expressed in jnp inside ``lax.fori_loop`` — XLA fuses the
chain into a handful of kernels per iteration, which plays the same role as
the reference's hand-fused CUDA kernels.  ``half_precision=True`` stores
the gradient/dual buffers in bfloat16 (the analogue of the fp16 option,
``regularisersCuPy.py:77,212``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["ROF_TV", "PD_TV", "prox_regul"]

_EPS_ROF = 1.0e-8


def _squeeze_2d(data):
    """Mirror of reference ``__check_if_input_2d_or_3d``
    (``regularisersCuPy.py:299-315``): squeeze a singleton axis of 3D input."""
    if data.ndim == 2:
        return data, True, 0
    if data.ndim == 3:
        for i in range(3):
            if data.shape[i] == 1:
                return jnp.squeeze(data, axis=i), True, i
        return data, False, 0
    raise ValueError("2D or 3D arrays must be provided only")


def _fwd_diff(u, axis):
    """Forward difference with reflect-at-end boundary: d[-1]=u[-2]-u[-1]."""
    nxt = jnp.concatenate(
        [
            jax.lax.slice_in_dim(u, 1, u.shape[axis], axis=axis),
            jax.lax.slice_in_dim(u, u.shape[axis] - 2, u.shape[axis] - 1, axis=axis),
        ],
        axis=axis,
    )
    return nxt - u


def _prev_reflect(u, axis):
    """u[i-1] with reflect boundary at 0: prev[0]=u[1]."""
    return jnp.concatenate(
        [
            jax.lax.slice_in_dim(u, 1, 2, axis=axis),
            jax.lax.slice_in_dim(u, 0, u.shape[axis] - 1, axis=axis),
        ],
        axis=axis,
    )


def _bwd_diff_zero(p, axis):
    """Backward difference with zero boundary at 0: d[0]=p[0]."""
    prev = jnp.concatenate(
        [
            jnp.zeros_like(jax.lax.slice_in_dim(p, 0, 1, axis=axis)),
            jax.lax.slice_in_dim(p, 0, p.shape[axis] - 1, axis=axis),
        ],
        axis=axis,
    )
    return p - prev


def ROF_TV(
    data: jnp.ndarray,
    regularisation_parameter: float = 1e-05,
    iterations: int = 3000,
    time_marching_parameter: float = 0.001,
    half_precision: bool = False,
) -> jnp.ndarray:
    """Rudin-Osher-Fatemi explicit time-marching TV denoising."""
    data, input_is_2d, ind_axis = _squeeze_2d(data)
    ndim = data.ndim
    grad_dtype = jnp.bfloat16 if half_precision else jnp.float32
    lam = jnp.float32(regularisation_parameter)
    tau = jnp.float32(time_marching_parameter)
    data = data.astype(jnp.float32)

    # axis roles matching the CUDA kernels (see SURVEY #10):
    # D1 <-> axis -2 forward diff, D2 <-> axis -1, D3 <-> axis -3 (3D only).
    d_axes = [ndim - 2, ndim - 1] + ([ndim - 3] if ndim == 3 else [])

    def divergence(u):
        fdiffs = [ _fwd_diff(u, ax) for ax in d_axes ]
        bdiffs = [ u - _prev_reflect(u, ax) for ax in d_axes ]
        def minmod_sq(nom0, nom1):
            den = 0.5 * (jnp.sign(nom1) + jnp.sign(nom0)) * jnp.minimum(
                jnp.abs(nom1), jnp.abs(nom0)
            )
            return den * den
        sq = [f * f for f in fdiffs]
        mm = [minmod_sq(b, f) for b, f in zip(bdiffs, fdiffs)]
        Ds = []
        for k in range(len(d_axes)):
            denom_terms = [sq[k] if j == k else mm[j] for j in range(len(d_axes))]
            denom = jnp.sqrt(sum(denom_terms) + _EPS_ROF)
            Ds.append((fdiffs[k] / denom).astype(grad_dtype))
        return Ds

    def body(_, u):
        Ds = divergence(u)
        dv = sum(
            (D.astype(jnp.float32) - _prev_reflect(D, ax).astype(jnp.float32))
            for D, ax in zip(Ds, d_axes)
        )
        return u + tau * (lam * dv - (u - data))

    out = jax.lax.fori_loop(0, iterations, body, data)
    if input_is_2d:
        # reference expands squeezed/2D inputs back to 3D on output
        # (regularisersCuPy.py:164-167,293-296)
        out = jnp.expand_dims(out, axis=ind_axis)
    return out


def PD_TV(
    data: jnp.ndarray,
    regularisation_parameter: float = 1e-05,
    iterations: int = 1000,
    methodTV: int = 0,
    nonneg: int = 0,
    lipschitz_const: float = 8.0,
    half_precision: bool = False,
) -> jnp.ndarray:
    """Primal-Dual (Chambolle-Pock) TV denoising, iso/aniso, optional
    non-negativity, one fused update per iteration (XLA fuses each
    iteration's elementwise chain, the structural equivalent of the
    reference's fused CUDA kernel)."""
    data, input_is_2d, ind_axis = _squeeze_2d(data)
    ndim = data.ndim
    dual_dtype = jnp.bfloat16 if half_precision else jnp.float32
    data = data.astype(jnp.float32)

    tau = jnp.float32(regularisation_parameter * 0.1)
    sigma = jnp.float32(1.0 / (lipschitz_const * tau))
    theta = jnp.float32(1.0)
    lt = jnp.float32(tau / regularisation_parameter)

    # P1 <-> axis -1 (x), P2 <-> axis -2 (y), P3 <-> axis -3 (z): the CUDA
    # kernel strides xStride=1 (minor axis), yStride=dimX, zStride=dimX*dimY.
    d_axes = [ndim - 1, ndim - 2] + ([ndim - 3] if ndim == 3 else [])

    def body(_, carry):
        u, ps = carry
        # dual ascent on forward differences (reflect-at-end boundary)
        new_ps = [
            p.astype(jnp.float32) + sigma * _fwd_diff(u, ax)
            for p, ax in zip(ps, d_axes)
        ]
        if methodTV == 0:  # isotropic: project onto the unit ball jointly
            denom = sum(p * p for p in new_ps)
            scale = jnp.where(denom > 1.0, jax.lax.rsqrt(jnp.maximum(denom, 1e-30)), 1.0)
            new_ps = [p * scale for p in new_ps]
        else:  # anisotropic: per-component projection
            new_ps = [p / jnp.maximum(jnp.abs(p), 1.0) for p in new_ps]
        div = sum(_bwd_diff_zero(p, ax) for p, ax in zip(new_ps, d_axes))
        uc = jnp.maximum(u, 0.0) if nonneg else u
        u_new = (uc + tau * div + lt * data) / (1.0 + lt)
        u_out = u_new + theta * (u_new - uc)
        return (u_out, [p.astype(dual_dtype) for p in new_ps])

    ps0 = [jnp.zeros(data.shape, dtype=dual_dtype) for _ in d_axes]
    out, _ = jax.lax.fori_loop(0, iterations, body, (data, ps0))
    if input_is_2d:
        # reference expands squeezed/2D inputs back to 3D on output
        # (regularisersCuPy.py:164-167,293-296)
        out = jnp.expand_dims(out, axis=ind_axis)
    return out


def prox_regul(self, X: jnp.ndarray, _regularisation_: dict) -> jnp.ndarray:
    """Dispatch the proximal operator by ``_regularisation_["method"]``.

    Mirrors ``regularisersCuPy.py:6-38`` (substring matching, so combined
    strings like ``"PD_TV_WAVELETS"`` work) and restores the retired
    RecToolsIR surface (SURVEY.md §2.4) via
    :mod:`tomobar_tpu.regularisers_legacy`: FGP_TV, SB_TV, LLT_ROF, TGV,
    NDF, Diff4th, NLTV and the ``*_WAVELETS`` shrinkage combination
    (wavelet threshold = ``regul_param2``, the legacy demo convention).
    """
    method = _regularisation_["method"]
    out = None
    if method is not None and "ROF_TV" in method:
        out = ROF_TV(
            X,
            _regularisation_["regul_param"],
            _regularisation_["iterations"],
            _regularisation_["time_marching_step"],
            _regularisation_.get("half_precision", False),
        )
    elif method is not None and "PD_TV" in method:
        out = PD_TV(
            X,
            _regularisation_["regul_param"],
            _regularisation_["iterations"],
            _regularisation_["methodTV"],
            getattr(self, "nonneg_regul", 0),
            _regularisation_["PD_LipschitzConstant"],
            _regularisation_.get("half_precision", False),
        )
    elif method is not None and "FGP_TV" in method:
        from tomobar_tpu.regularisers_legacy import FGP_TV

        out = FGP_TV(
            X,
            _regularisation_["regul_param"],
            _regularisation_["iterations"],
            _regularisation_["methodTV"],
            getattr(self, "nonneg_regul", 0),
        )
    elif method is not None and "SB_TV" in method:
        from tomobar_tpu.regularisers_legacy import SB_TV

        out = SB_TV(
            X,
            _regularisation_["regul_param"],
            _regularisation_["iterations"],
            _regularisation_["methodTV"],
        )
    elif method is not None and "LLT_ROF" in method:
        from tomobar_tpu.regularisers_legacy import LLT_ROF

        out = LLT_ROF(
            X,
            _regularisation_["regul_param"],
            _regularisation_.get("regul_param2", 1e-05),
            _regularisation_["iterations"],
            _regularisation_["time_marching_step"],
        )
    elif method is not None and "TGV" in method:
        from tomobar_tpu.regularisers_legacy import TGV

        out = TGV(
            X,
            _regularisation_["regul_param"],
            _regularisation_.get("alpha1", 1.0),
            _regularisation_.get("alpha0", 2.0),
            _regularisation_["iterations"],
            _regularisation_.get("TGV_LipschitzConstant", 12.0),
        )
    elif method is not None and "NDF" in method:
        from tomobar_tpu.regularisers_legacy import NDF

        out = NDF(
            X,
            _regularisation_["regul_param"],
            _regularisation_.get("edge_param", 0.01),
            _regularisation_["iterations"],
            _regularisation_["time_marching_step"],
            _regularisation_.get("NDF_penalty", 1),
        )
    elif method is not None and "Diff4th" in method:
        from tomobar_tpu.regularisers_legacy import Diff4th

        out = Diff4th(
            X,
            _regularisation_["regul_param"],
            _regularisation_.get("edge_param", 0.01),
            _regularisation_["iterations"],
            _regularisation_["time_marching_step"],
        )
    elif method is not None and "NLTV" in method:
        from tomobar_tpu.regularisers_legacy import NLTV

        # legacy demo dicts (DemoFISTA_NLTV_2D.py) supply IterNumb and may
        # omit "iterations" entirely, so the fallback must be lazy
        nltv_iters = _regularisation_.get("IterNumb")
        if nltv_iters is None:
            nltv_iters = _regularisation_.get("iterations", 5)
        out = NLTV(
            X,
            _regularisation_["NLTV_H_i"],
            _regularisation_["NLTV_H_j"],
            _regularisation_["NLTV_Weights"],
            _regularisation_["regul_param"],
            nltv_iters,
        )
    elif method is not None and method.startswith("WAVELET"):
        out = X  # pure wavelet shrinkage handled below
    if out is None:
        raise ValueError(f"Unknown regularisation method: {method}")
    if "WAVELET" in method:
        from tomobar_tpu.regularisers_legacy import WAVELET_SHRINK

        # dedicated threshold key; pure WAVELETS uses regul_param, combined
        # strings (e.g. PD_TV_WAVELETS) keep the legacy regul_param2 demo
        # convention so regul_param2 is not consumed twice for LLT_ROF_WAVELETS
        thr = _regularisation_.get("wavelet_threshold")
        if thr is None:
            if method.startswith("WAVELET"):
                thr = _regularisation_["regul_param"]
            else:
                thr = _regularisation_.get("regul_param2", 1e-05)
        out = WAVELET_SHRINK(
            out,
            thr,
            _regularisation_.get("wavelet_levels", 3),
        )
    return out
