"""Data-fidelity gradients for FISTA/ADMM (LS, PWLS, SWLS, KL + robust
residual modifiers).

Equivalent of ``tomobar/data_fidelities.py:7-40`` expressed over the
projector pair.  ``b`` is post-log data for LS/PWLS/SWLS and
pre-log raw counts for KL.

The retired host class ``RecToolsIR`` (removed in reference v2026.3.0.0,
``CHANGELOG.md:3-24``; see SURVEY.md §2.4) additionally supported the SWLS
stripe-weighted model and Huber/Student's-t robust thresholds, exercised by
``Demos/methods_IR_legacy/DemoFISTA_artifacts2D.py:222-265``.  Its source is
not in the mirror, so the implementations here follow the documented intent:

* SWLS ("stripe-weighted least squares", ``beta_SWLS``): rays passing
  through detector columns whose post-log signal deviates persistently from
  an angle-smoothed version (the signature of a miscalibrated detector
  element, which backprojects into a ring) are down-weighted with the
  Geman-McClure-style weight ``w = beta^2 / (beta^2 + d^2)`` where ``d`` is
  the per-(detY, detX) median absolute deviation of ``b`` from its
  angle-median.  Weights are computed once from the data (like the PWLS
  weights, ``methodsIR_CuPy.py:392-397``) and enter the gradient as
  ``A^T (w * (Ax - b))``.
* Huber threshold (``huber_threshold``): gradient of the Huber loss —
  residuals are clipped to ``delta * sign(r)`` beyond the threshold,
  suppressing zingers/outlier rays.
* Student's-t threshold (``studentst_threshold``): gradient of the
  log-Student loss ``r -> r / (1 + (r/delta)^2)`` — redescending, so gross
  outliers are ignored entirely.

Modifiers compose with LS/PWLS/SWLS (applied to the weighted residual, as
the legacy demos combine ``SWLS + huber_threshold``).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

__all__ = ["grad_data_term", "swls_weights"]


def swls_weights(b: jnp.ndarray, beta: float = 0.1, window: int = 9) -> jnp.ndarray:
    """Stripe weights from post-log data ``b`` (detY, angles, detX).

    A stripe is an angle-invariant bias of one detector element, so its
    signature is the element's *angle-median* deviating from the angle-
    medians of its spatial neighbours.  ``d[z, t] = median_angles(b)[z, t] -
    median_{|t'-t|<=w/2}(median_angles(b)[z, t'])`` and
    ``w = beta^2 / (beta^2 + d^2)`` (Geman-McClure), max-normalised —
    constant along angles, so the whole corrupted ray family is
    down-weighted while genuine (angle-varying) structure is untouched.
    """
    med = jnp.median(b, axis=-2)  # (detY, detX): per-element angle-median
    # sliding spatial median over detX (reflect-padded shifted stack)
    half = window // 2
    padded = jnp.pad(med, ((0, 0), (half, half)), mode="reflect")
    stack = jnp.stack(
        [padded[:, i : i + med.shape[-1]] for i in range(window)], axis=0
    )
    smooth = jnp.median(stack, axis=0)
    d = med - smooth
    beta2 = jnp.float32(beta * beta)
    w = beta2 / (beta2 + d * d)
    w = (w / jnp.max(w))[:, None, :]
    return jnp.broadcast_to(w, b.shape).astype(jnp.float32)


def _apply_robust(res: jnp.ndarray, huber: Optional[float], studentst: Optional[float]):
    if huber is not None and huber > 0.0:
        d = jnp.float32(huber)
        res = jnp.clip(res, -d, d)  # psi'(r) = clamp(r, +-delta)
    if studentst is not None and studentst > 0.0:
        d = jnp.float32(studentst)
        res = res / (1.0 + (res / d) ** 2)
    return res


def grad_data_term(
    projector,
    x: jnp.ndarray,
    b: jnp.ndarray,
    sub_ind: Optional[int] = None,
    w: Optional[jnp.ndarray] = None,
    fidelity: str = "LS",
    huber_threshold: Optional[float] = None,
    studentst_threshold: Optional[float] = None,
) -> jnp.ndarray:
    """Gradient of the data-fidelity term: A^T r with
    r = (Ax - b) [optionally * w] for LS/PWLS/SWLS, or r = 1 - b/clip(Ax)
    for KL; robust modifiers reshape r before backprojection.

    Args:
        projector: :class:`tomobar_tpu.ops.projector.Projector`.
        x: current volume estimate.
        b: projection data (already subset-sliced when sub_ind is given).
        sub_ind: ordered-subset index; None for the full operator.
        w: PWLS or SWLS weights (already subset-sliced when sub_ind given).
        fidelity: "LS" | "PWLS" | "SWLS" | "KL".
        huber_threshold: optional Huber clip on the residual.
        studentst_threshold: optional redescending Student's-t reweighting.
    """
    use_os = sub_ind is not None

    def Ax(v):
        return projector.fp_sub(v, sub_ind) if use_os else projector.fp(v)

    def Atb(r):
        return projector.bp_sub(r, sub_ind) if use_os else projector.bp(r)

    if fidelity in ("LS", "PWLS", "SWLS"):
        res = Ax(x) - b
        if w is not None:
            res = res * w
        res = _apply_robust(res, huber_threshold, studentst_threshold)
    elif fidelity == "KL":
        res = 1.0 - b / jnp.clip(Ax(x), 1e-8, None)
    else:
        raise ValueError(f"Unsupported data fidelity: {fidelity}")
    return Atb(res)
