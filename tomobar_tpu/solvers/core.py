"""Iterative solver cores: power method, Landweber, SIRT, CGLS, FISTA,
ADMM, OSEM — functional, jit-compiled, device-resident.

These are the device-resident equivalents of the reference solver bodies in
``tomobar/methodsIR_CuPy.py`` (Landweber:128, SIRT:174, CGLS:233,
powermethod:311, FISTA:401, ADMM:486, OSEM:587).  Design notes:

* Outer iteration loops are ``lax.fori_loop`` (state never leaves the
  device); the ordered-subset inner loop is unrolled at trace time because
  each subset has its own static geometry (static shapes — no ragged
  dynamic slicing inside jit; the structural fix for SURVEY "hard part"
  #4).
* The sinogram is subset-sliced once, outside the loop, with static
  indices.
* Solver-level quirks of the reference are preserved deliberately for
  behavioural parity and documented inline (e.g. OSEM multiplying by the
  clipped normalisation volume, CGLS's in-loop nonnegativity clamp, ADMM's
  per-outer-iteration dual update).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tomobar_tpu.fidelity import grad_data_term, swls_weights
from tomobar_tpu.ops.projector import Projector

__all__ = [
    "power_method",
    "landweber",
    "sirt",
    "cgls",
    "fista",
    "admm",
    "osem",
]


def _subset_slices(projector: Projector, sino, w=None):
    """Pre-slice the sinogram (and optional weights) per OS subset with
    static indices."""
    n_sub = len(projector.subset_indices)
    subs = [projector.sino_subset(sino, s) for s in range(n_sub)]
    w_subs = (
        [projector.sino_subset(w, s) for s in range(n_sub)] if w is not None else
        [None] * n_sub
    )
    return subs, w_subs


# ---------------------------------------------------------------------------


def power_method(
    projector: Projector,
    vol_shape,
    iterations: int = 15,
    use_pwls: bool = False,
    seed: int = 0,
) -> float:
    """Spectral norm of A^T A (or A^T W A) via power iterations.

    Mirrors ``methodsIR_CuPy.py:311-354``: with OS enabled only subset 0 is
    used; for PWLS the weights start as ones (so the value matches LS, as in
    the reference).
    """
    use_os = len(projector.subset_indices) > 1

    def Ax(v):
        return projector.fp_sub(v, 0) if use_os else projector.fp(v)

    def Atb(r):
        return projector.bp_sub(r, 0) if use_os else projector.bp(r)

    @jax.jit
    def run(x1):
        y = Ax(x1)

        def body(_, carry):
            _, y = carry
            x1 = Atb(y)
            s = jnp.linalg.norm(jnp.ravel(x1))
            x1 = x1 / s
            y = Ax(x1)
            return (s, y)

        s, _ = jax.lax.fori_loop(0, iterations, body, (jnp.float32(1.0), y))
        return s

    del use_pwls  # weights are ones in the reference's power method
    x1 = jax.random.normal(jax.random.PRNGKey(seed), vol_shape, dtype=jnp.float32)
    return float(run(x1))


# ---------------------------------------------------------------------------


def landweber(
    projector: Projector,
    sino: jnp.ndarray,
    iterations: int = 1500,
    tau_step: float = 1e-5,
    nonnegativity: bool = False,
) -> jnp.ndarray:
    nz = sino.shape[0]
    n = projector.geom.recon_size

    @jax.jit
    def run(b):
        def body(_, x):
            residual = projector.fp(x) - b
            x = x - tau_step * projector.bp(residual)
            if nonnegativity:
                x = jnp.maximum(x, 0.0)
            return x

        x0 = jnp.zeros((nz, n, n), dtype=jnp.float32)
        return jax.lax.fori_loop(0, iterations, body, x0)

    return run(sino)


def sirt(
    projector: Projector,
    sino: jnp.ndarray,
    iterations: int = 200,
    nonnegativity: bool = False,
) -> jnp.ndarray:
    nz = sino.shape[0]
    n = projector.geom.recon_size

    @jax.jit
    def run(b):
        ones_vol = jnp.ones((nz, n, n), dtype=jnp.float32)
        R = 1.0 / projector.fp(ones_vol)
        R = jnp.nan_to_num(R, nan=1.0, posinf=1.0, neginf=1.0)
        C = 1.0 / projector.bp(jnp.ones_like(b))
        C = jnp.nan_to_num(C, nan=1.0, posinf=1.0, neginf=1.0)

        def body(_, x):
            x = x + C * projector.bp(R * (b - projector.fp(x)))
            if nonnegativity:
                x = jnp.maximum(x, 0.0)
            return x

        return jax.lax.fori_loop(0, iterations, body, ones_vol)

    return run(sino)


def cgls(
    projector: Projector,
    sino: jnp.ndarray,
    iterations: int = 30,
    nonnegativity: bool = False,
) -> jnp.ndarray:
    nz = sino.shape[0]
    n = projector.geom.recon_size

    @jax.jit
    def run(b):
        x = jnp.zeros((nz, n, n), dtype=jnp.float32)
        d = projector.bp(b)
        normr2 = jnp.vdot(d, d).real.astype(jnp.float32)
        r = b

        def body(_, carry):
            x, d, r, normr2 = carry
            Ad = projector.fp(d)
            alpha = normr2 / jnp.vdot(Ad, Ad).real.astype(jnp.float32)
            x = x + alpha * d
            r = r - alpha * Ad
            s = projector.bp(r)
            normr2_new = jnp.vdot(s, s).real.astype(jnp.float32)
            beta = normr2_new / normr2
            d = s + beta * d
            if nonnegativity:
                # NOTE: reference clamps x inside the CG loop
                # (methodsIR_CuPy.py:296-297); preserved for parity even
                # though it breaks CG theory.
                x = jnp.maximum(x, 0.0)
            return (x, d, r, normr2_new)

        x, _, _, _ = jax.lax.fori_loop(0, iterations, body, (x, d, r, normr2))
        return x

    return run(sino)


# ---------------------------------------------------------------------------


def _prepare_pwls_weights(sino: jnp.ndarray) -> jnp.ndarray:
    """PWLS weights from the (padded, post-log) data
    (``methodsIR_CuPy.py:392-397``)."""
    w = jnp.maximum(sino, 1e-6)
    return w / jnp.max(w)


def _prepare_weights(sino, fidelity: str, fid_kwargs: dict):
    if fidelity == "PWLS":
        return _prepare_pwls_weights(sino)
    if fidelity == "SWLS":
        return swls_weights(sino, fid_kwargs.get("beta_SWLS", 0.1))
    return None


def fista(
    projector: Projector,
    sino: jnp.ndarray,
    iterations: int,
    lipschitz_const: float,
    nonnegativity: bool = False,
    fidelity: str = "LS",
    regul_fn: Optional[Callable] = None,
    x0: Optional[jnp.ndarray] = None,
    fid_kwargs: Optional[dict] = None,
    tolerance: float = 0.0,
    verbose: bool = False,
    step_cache: Optional[dict] = None,
    step_key=None,
) -> jnp.ndarray:
    """FISTA with optional ordered subsets and proximal regularisation
    (``methodsIR_CuPy.py:401-484``).

    ``tolerance > 0`` enables real early stopping on the relative update
    norm per outer iteration (the reference accepts the parameter but
    never uses it, ``dicts.py:153-155`` — a consciously fixed quirk; the
    default 0.0 preserves reference behaviour).  ``verbose`` prints the
    per-outer-iteration relative update norm host-side (the equivalent of
    the reference's gated progress prints, ``methodsIR_CuPy.py:568-576``);
    the loop then runs one jitted sweep per outer iteration
    (:func:`_host_outer_loop`)."""
    nz = sino.shape[0]
    n = projector.geom.recon_size
    n_sub = len(projector.subset_indices)
    use_os = n_sub > 1
    fid_kwargs = fid_kwargs or {}
    L_inv = jnp.float32(1.0 / lipschitz_const)

    def sweep(carry, subs, w_subs):
        x, x_t, t = carry
        for s in range(n_sub):
            x_old = x
            t_old = t
            grad = grad_data_term(
                projector,
                x_t,
                subs[s],
                sub_ind=s if use_os else None,
                w=w_subs[s],
                fidelity=fidelity,
                huber_threshold=fid_kwargs.get("huber_threshold"),
                studentst_threshold=fid_kwargs.get("studentst_threshold"),
            )
            x = x_t - L_inv * grad
            if nonnegativity:
                x = jnp.maximum(x, 0.0)
            if regul_fn is not None:
                x = regul_fn(x)
            t = (1.0 + jnp.sqrt(1.0 + 4.0 * t * t)) * 0.5
            x_t = x + ((t_old - 1.0) / t) * (x - x_old)
        return (x, x_t, t)

    if x0 is None:
        x0 = jnp.zeros((nz, n, n), dtype=jnp.float32)

    if verbose:
        x = _host_outer_loop(
            "FISTA", sweep, (x0, x0, jnp.float32(1.0)), projector, sino,
            fidelity, fid_kwargs, iterations, tolerance,
            step_cache=step_cache, step_key=step_key,
        )
        return x

    @jax.jit
    def run(b, x_init):
        w = _prepare_weights(b, fidelity, fid_kwargs)
        subs, w_subs = _subset_slices(projector, b, w)

        init = (x_init, x_init, jnp.float32(1.0))
        if tolerance and tolerance > 0.0:
            tol = jnp.float32(tolerance)

            def cond(state):
                it, rel, _ = state
                return jnp.logical_and(it < iterations, rel >= tol)

            def wbody(state):
                it, _, carry = state
                x_prev = carry[0]
                carry = sweep(carry, subs, w_subs)
                x_new = carry[0]
                rel = jnp.linalg.norm(jnp.ravel(x_new - x_prev)) / jnp.maximum(
                    jnp.linalg.norm(jnp.ravel(x_new)), 1e-12
                )
                return (it + 1, rel, carry)

            _, _, (x, _, _) = jax.lax.while_loop(
                cond, wbody, (jnp.int32(0), jnp.float32(jnp.inf), init)
            )
        else:
            x, _, _ = jax.lax.fori_loop(
                0, iterations, lambda _, c: sweep(c, subs, w_subs), init
            )
        return x

    return run(sino, x0)


def _host_outer_loop(
    name, sweep, init, projector, sino, fidelity, fid_kwargs, iterations,
    tolerance, body_takes_iter=False, step_cache=None, step_key=None,
):
    """Host-driven outer loop for ``verbose`` solvers: one jitted sweep per
    outer iteration, progress printed from the host.

    Deliberate divergence from the reference: progress is printed EVERY
    outer iteration (with the relative update norm), whereas the reference
    prints roughly every ``iterations/5`` sweeps without a convergence
    metric (``methodsIR_CuPy.py:568-576``).  The per-iteration line is what
    makes ``tolerance`` early stopping observable, and outer iterations are
    seconds-long at production scale, so the denser cadence costs nothing.

    Printing from the host keeps the compiled step free of host callbacks
    and lets ``tolerance`` stop the loop early; the per-iteration dispatch
    overhead is paid only when verbose is on.

    ``sweep`` is a fresh closure on every solver call, so ``jax.jit``'s
    identity-keyed cache would recompile per invocation (the production
    warm-start ADMM pattern runs verbose, ``Demos/RealData.py:228-235``).
    Callers that hold a stable dict (the ``RecToolsIRTPU`` instance) pass
    ``step_cache`` plus a ``step_key`` capturing every non-array value the
    sweep closes over; a hit reuses the compiled step across calls."""
    w = _prepare_weights(sino, fidelity, fid_kwargs)
    subs, w_subs = _subset_slices(projector, sino, w)

    step = step_cache.get(step_key) if step_cache is not None else None
    if step is None:

        @jax.jit
        def step(it, carry, subs, w_subs):
            x_prev = carry[0]
            carry = (
                sweep(it, carry, subs, w_subs)
                if body_takes_iter
                else sweep(carry, subs, w_subs)
            )
            rel = jnp.linalg.norm(jnp.ravel(carry[0] - x_prev)) / jnp.maximum(
                jnp.linalg.norm(jnp.ravel(carry[0])), 1e-12
            )
            return carry, rel

        if step_cache is not None and step_key is not None:
            step_cache[step_key] = step

    carry = init
    for it in range(iterations):
        carry, rel = step(jnp.int32(it), carry, subs, w_subs)
        rel = float(rel)
        print(f"{name} iteration ({it + 1}) relative update: {rel:.3e}")
        if tolerance and tolerance > 0.0 and rel < tolerance:
            print(f"{name} stopped at iteration ({it + 1}): tolerance reached")
            break
    return carry[0]


def admm(
    projector: Projector,
    sino: jnp.ndarray,
    iterations: int,
    lipschitz_const: float,
    rho_const: float = 1.0,
    relax_par: float = 1.6,
    nonnegativity: bool = False,
    fidelity: str = "LS",
    regul_fn: Optional[Callable] = None,
    x0: Optional[jnp.ndarray] = None,
    fid_kwargs: Optional[dict] = None,
    tolerance: float = 0.0,
    verbose: bool = False,
    step_cache: Optional[dict] = None,
    step_key=None,
) -> jnp.ndarray:
    """Linearised + relaxed ADMM with ordered subsets
    (``methodsIR_CuPy.py:486-585``).  Note: relaxation activates from outer
    iteration index > 1, and the dual update runs once per OUTER iteration —
    both preserved for parity.

    ``verbose`` prints per-outer-iteration progress host-side (the
    reference's gated prints, ``methodsIR_CuPy.py:568-576``);
    ``tolerance > 0`` adds real early stopping on the relative x-update norm
    (the reference accepts the parameter but ignores it — consciously fixed,
    default 0.0 = parity)."""
    nz = sino.shape[0]
    n = projector.geom.recon_size
    n_sub = len(projector.subset_indices)
    use_os = n_sub > 1
    tau = jnp.float32(0.9 / (lipschitz_const + rho_const))
    fid_kwargs = fid_kwargs or {}

    def body(iter_no, carry, subs, w_subs):
        x, z, z_old, u = carry
        for s in range(n_sub):
            grad = grad_data_term(
                projector,
                z,
                subs[s],
                sub_ind=s if use_os else None,
                w=w_subs[s],
                fidelity=fidelity,
                huber_threshold=fid_kwargs.get("huber_threshold"),
                studentst_threshold=fid_kwargs.get("studentst_threshold"),
            )
            grad_admm = rho_const * (z - x + u)
            z = z - tau * (grad + grad_admm)
            if nonnegativity:
                z = jnp.maximum(z, 0.0)
            z = jnp.where(
                iter_no > 1, (1.0 - relax_par) * z_old + relax_par * z, z
            )
            z_old = z
            x_prox = z + u
            x = regul_fn(x_prox) if regul_fn is not None else x_prox
        u = u + (z - x)
        return (x, z, z_old, u)

    if x0 is None:
        x0 = jnp.zeros((nz, n, n), dtype=jnp.float32)
    init = (x0, x0, jnp.zeros_like(x0), jnp.zeros_like(x0))

    if verbose:
        x = _host_outer_loop(
            "ADMM", body, init, projector, sino, fidelity, fid_kwargs,
            iterations, tolerance, body_takes_iter=True,
            step_cache=step_cache, step_key=step_key,
        )
        return x

    @jax.jit
    def run(b, carry0):
        w = _prepare_weights(b, fidelity, fid_kwargs)
        subs, w_subs = _subset_slices(projector, b, w)

        if tolerance and tolerance > 0.0:
            tol = jnp.float32(tolerance)

            def cond(state):
                it, rel, _ = state
                return jnp.logical_and(it < iterations, rel >= tol)

            def wbody(state):
                it, _, carry = state
                x_prev = carry[0]
                carry = body(it, carry, subs, w_subs)
                rel = jnp.linalg.norm(
                    jnp.ravel(carry[0] - x_prev)
                ) / jnp.maximum(jnp.linalg.norm(jnp.ravel(carry[0])), 1e-12)
                return (it + 1, rel, carry)

            _, _, (x, _, _, _) = jax.lax.while_loop(
                cond, wbody, (jnp.int32(0), jnp.float32(jnp.inf), carry0)
            )
        else:
            x, _, _, _ = jax.lax.fori_loop(
                0, iterations, lambda i, c: body(i, c, subs, w_subs), carry0
            )
        return x

    return run(sino, init)


def osem(
    projector: Projector,
    sino: jnp.ndarray,
    iterations: int,
    regul_fn: Optional[Callable] = None,
    x0: Optional[jnp.ndarray] = None,
    normalisation_mode: str = "reference",
) -> jnp.ndarray:
    """OSEM (MLEM when OS=1) — multiplicative EM updates
    (``methodsIR_CuPy.py:587-667``).

    ``normalisation_mode``:

    * ``"reference"`` (default) — golden parity with the reference, which
      MULTIPLIES by the clipped sensitivity volume computed from subset 0:
      ``x *= backproj * normalisation`` (``methodsIR_CuPy.py:654``; the
      fossil ``normalisation /= 1`` at ``:626,:637`` shows a division was
      intended).  This diverges in scale by ~``A^T(1)^2`` per sweep on
      generic emission data.
    * ``"divide"`` — the textbook EM update ``x *= backproj /
      sensitivity`` with the per-subset sensitivity ``A_s^T(1)``; the
      actual Poisson maximum-likelihood iteration (see
      ``examples/osem_kl_counts.py``)."""
    if normalisation_mode not in ("reference", "divide"):
        raise ValueError(
            "osem_normalisation must be 'reference' or 'divide', got "
            f"{normalisation_mode!r}"
        )
    nz = sino.shape[0]
    n = projector.geom.recon_size
    n_sub = len(projector.subset_indices)
    use_os = n_sub > 1
    eps = 1e-8

    @jax.jit
    def run(b, x_init):
        subs, _ = _subset_slices(projector, b)
        if normalisation_mode == "reference":
            # one volume from subset 0, used for every subset (quirk)
            if not use_os:
                norm0 = projector.bp(jnp.ones_like(b))
            else:
                norm0 = projector.bp_sub(jnp.ones_like(subs[0]), 0)
            norms = [jnp.clip(norm0, eps, None)] * n_sub
        else:
            norms = [
                jnp.clip(
                    projector.bp_sub(jnp.ones_like(subs[s]), s)
                    if use_os
                    else projector.bp(jnp.ones_like(b)),
                    eps,
                    None,
                )
                for s in range(n_sub)
            ]

        def body(_, x):
            for s in range(n_sub):
                Ax = (
                    projector.fp_sub(x, s) if use_os else projector.fp(x)
                )
                ratio = subs[s] / jnp.clip(Ax, eps, None)
                backproj = (
                    projector.bp_sub(ratio, s) if use_os else projector.bp(ratio)
                )
                if normalisation_mode == "reference":
                    x = x * (backproj * norms[s])
                else:
                    x = x * (backproj / norms[s])
                if regul_fn is not None:
                    x = regul_fn(x)
            return x

        return jax.lax.fori_loop(0, iterations, body, x_init)

    if x0 is None:
        x0 = jnp.ones((nz, n, n), dtype=jnp.float32)
    return run(sino, x0)
