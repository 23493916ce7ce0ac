"""The north-star measurement: time-to-RMSE on the 2560^2 x 20 phantom.

BASELINE.json defines the headline metric as "FISTA-OS-TV iterations/s and
time-to-RMSE on 2560^2x20 TomoPhantom 3D ... at RMSE parity".  This module
measures exactly that, on-device, with *converging* data (a real phantom,
Poisson counting noise, powermethod Lipschitz constant) — mirroring the
reference workflow ``Demos/tomophantom_3D_recon1.py:140-142,259-262``
(QualityTools RMSE after FBP and after FISTA) plus the production
warm-start ADMM pattern (``Demos/RealData.py:228-235``).

Reported scalars (all wall-clock, post-compile, each step ended by
``block_until_ready``):

* ``rel_rmse_fbp``          — direct-method quality floor.
* ``fista.iter_s``          — steady-state outer-iteration rate with the
                              real data and the measured L.
* ``fista.time_to_fbp_rmse_s`` — seconds of FISTA to match FBP quality.
* ``fista.time_to_rmse_s``  — seconds to converge within 2% of the run's
                              best rel-RMSE (the "RMSE parity" point);
                              the full (t, rmse) trajectory rides along so
                              any other threshold can be read off.
* ``admm.*``                — warm-start (FBP) relaxed ADMM-OS24
                              trajectory, 3 outer iterations.

Run standalone:  python -m tomobar_tpu.bench.northstar
Or via bench.py (rides in "extra_configs.northstar").
"""

from __future__ import annotations

import json
import os
import timeit

import numpy as np

__all__ = ["ellipsoid_phantom_jax", "run_northstar"]


def ellipsoid_phantom_jax(n: int, nz: int):
    """Shepp-Logan-like ellipsoid stack, built on device (values >= 0).

    Same ellipsoids as ``examples/phantom3d_fista_os_tv.py`` — kept in
    sync so example and bench measure the same object.
    """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def build():
        z = jnp.linspace(-1, 1, nz)[:, None, None]
        y = jnp.linspace(-1, 1, n)[None, :, None]
        x = jnp.linspace(-1, 1, n)[None, None, :]
        vol = jnp.zeros((nz, n, n), jnp.float32)
        for cx, cy, cz, ax, ay, az, v in [
            (0.0, 0.0, 0.0, 0.69, 0.90, 0.92, 1.0),
            (0.0, -0.02, 0.0, 0.62, 0.85, 0.87, -0.6),
            (0.22, 0.0, 0.0, 0.11, 0.31, 0.25, -0.2),
            (-0.22, 0.0, 0.0, 0.16, 0.41, 0.30, -0.2),
            (0.0, 0.35, -0.15, 0.21, 0.25, 0.30, 0.3),
            (0.0, 0.1, 0.25, 0.046, 0.046, 0.05, 0.3),
            (-0.08, -0.605, 0.0, 0.046, 0.023, 0.02, 0.25),
            (0.06, -0.605, 0.1, 0.023, 0.046, 0.02, 0.25),
        ]:
            inside = ((x - cx) / ax) ** 2 + ((y - cy) / ay) ** 2 + (
                (z - cz) / az
            ) ** 2 <= 1.0
            vol = vol + v * inside.astype(jnp.float32)
        return jnp.clip(vol, 0.0, None)

    return build()


def _rel_rmse_fn():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def f(rec, ref):
        num = jnp.sqrt(jnp.mean((rec - ref) ** 2))
        den = jnp.maximum(jnp.sqrt(jnp.mean(ref**2)), 1e-30)
        return num / den

    return f


def _trajectory(step_c, carry, datas, phantom, outer, rel_fn):
    """Run ``outer`` compiled steps, recording (cumulative s, rel-RMSE)."""
    import jax

    t_total = 0.0
    traj = []
    for _ in range(outer):
        t0 = timeit.default_timer()
        carry = jax.block_until_ready(step_c(carry, *datas))
        t_total += timeit.default_timer() - t0
        traj.append((t_total, float(rel_fn(carry[0], phantom))))
    return carry, traj


def run_northstar(
    N: int = 2560,
    nz: int = 20,
    nproj: int = 1801,
    os_number: int = 10,
    tv_iters: int = 20,
    fista_outer: int = 20,
    admm_outer: int = 3,
    regul_param: float = 2e-4,
    i0: float = 8000.0,
    verbose: bool = True,
) -> dict:
    import jax
    import jax.numpy as jnp

    from tomobar_tpu import RecToolsDIRCuPy
    from tomobar_tpu.geometry import Geometry
    from tomobar_tpu.ops.projector import Projector
    from tomobar_tpu.regularisers import PD_TV
    from tomobar_tpu.solvers import core as solvers

    def log(msg):
        if verbose:
            print(f"[northstar] {msg}", flush=True)

    rel_fn = _rel_rmse_fn()
    out = {"shape": f"{nproj}x{nz}x{N}", "os": os_number, "tv": tv_iters}

    # -- phantom + forward data (device-resident end to end) ----------------
    angles = np.linspace(0, np.pi, nproj, endpoint=False).astype(np.float32)
    geom = Geometry(
        detectors_x=N, detectors_y=nz, angles=angles, recon_size=N,
        os_number=os_number,
    )
    P = Projector(geom)
    phantom = ellipsoid_phantom_jax(N, nz)
    jax.block_until_ready(phantom)
    log("phantom built")

    # Poisson counting noise in intensity space (same model as
    # examples/phantom3d_fista_os_tv.py): mu-units scaled so the sinogram
    # keeps the projector's native pixel-sum scale.
    mu_scale = 4.0 / N

    @jax.jit
    def make_sino(ph):
        clean = P.fp(ph)
        lam = i0 * jnp.exp(-clean * mu_scale)
        counts = jax.random.poisson(jax.random.PRNGKey(0), lam)
        noisy = -jnp.log(jnp.maximum(counts, 1.0) / i0) / mu_scale
        return noisy.astype(jnp.float32)

    sino = make_sino(phantom)
    jax.block_until_ready(sino)
    log("sinogram projected + Poisson noise applied")

    # PWLS weights (reference semantics: clip + max-normalise,
    # methodsIR_CuPy.py:392-397)
    w = jnp.clip(sino, 1e-6, None) / jnp.max(sino)

    # -- Lipschitz constant: the real powermethod, subset 0 -----------------
    # Split compile vs run: the second call hits jit's cache, so
    # (first - second) is compile cost.  RecToolsIRTPU caches L per
    # (geometry, OS) instance, so production repeat solves skip even the
    # run cost — time_to_rmse_warm_s below reports that case.
    t0 = timeit.default_timer()
    L = solvers.power_method(P, (nz, N, N), iterations=15)
    pm_total = timeit.default_timer() - t0
    t0 = timeit.default_timer()
    solvers.power_method(P, (nz, N, N), iterations=15)
    pm_run = timeit.default_timer() - t0
    out["lipschitz_const"] = round(float(L), 2)
    out["powermethod_s"] = round(pm_total, 2)
    out["powermethod_run_s"] = round(pm_run, 2)
    out["powermethod_compile_s"] = round(max(pm_total - pm_run, 0.0), 2)
    log(
        f"powermethod L={L:.1f} ({pm_total:.1f}s first call, "
        f"{pm_run:.1f}s run-only)"
    )

    # -- FBP quality floor + warm start -------------------------------------
    rt_dir = RecToolsDIRCuPy(N, 0, nz, 0.0, angles, N)
    fbp_fn = jax.jit(lambda d: rt_dir.FBP(jnp.swapaxes(d, 0, 1), cutoff_freq=1.1))
    fbp = fbp_fn(sino)
    jax.block_until_ready(fbp)
    t0 = timeit.default_timer()
    fbp = fbp_fn(sino)
    jax.block_until_ready(fbp)
    out["fbp_s"] = round(timeit.default_timer() - t0, 3)
    rmse_fbp = float(rel_fn(fbp, phantom))
    out["rel_rmse_fbp"] = round(rmse_fbp, 4)
    log(f"FBP rel-RMSE {rmse_fbp:.4f} ({out['fbp_s']}s)")

    # -- FISTA-OS-TV (PWLS) --------------------------------------------------
    n_sub = len(P.subset_indices)
    L_inv = jnp.float32(1.0 / L)

    def fista_step(carry, sino, w):
        x, x_t, t = carry
        for s in range(n_sub):
            x_old, t_old = x, t
            res = (P.fp_sub(x_t, s) - P.sino_subset(sino, s)) * P.sino_subset(w, s)
            grad = P.bp_sub(res, s)
            x = jnp.maximum(x_t - L_inv * grad, 0.0)
            x = PD_TV(x, regul_param, tv_iters, 0, 1, 12.0)
            t = (1.0 + jnp.sqrt(1.0 + 4.0 * t * t)) * 0.5
            x_t = x + ((t_old - 1.0) / t) * (x - x_old)
        return x, x_t, t

    x0 = jnp.zeros((nz, N, N), jnp.float32)
    carry0 = (x0, x0, jnp.float32(1.0))
    step_c = jax.jit(fista_step).lower(carry0, sino, w).compile()
    log("FISTA step compiled; running trajectory")
    carry, traj = _trajectory(
        step_c, carry0, (sino, w), phantom, fista_outer, rel_fn
    )
    rmses = [r for _, r in traj]
    best = min(rmses)
    tgt = 1.02 * best
    t_conv = next(t for t, r in traj if r <= tgt)
    t_fbp_par = next((t for t, r in traj if r <= rmse_fbp), None)
    fista_res = {
        "rel_rmse_final": round(rmses[-1], 4),
        "rel_rmse_best": round(best, 4),
        "rmse_target": round(tgt, 4),
        "time_to_rmse_s": round(t_conv, 2),
        # cold = first solve on a fresh instance (pays the powermethod run;
        # compile amortises across the persistent cache); warm = repeat
        # solve with the instance's cached L
        "time_to_rmse_cold_s": round(t_conv + pm_run, 2),
        "time_to_rmse_warm_s": round(t_conv, 2),
        "time_to_fbp_rmse_s": (
            round(t_fbp_par, 2) if t_fbp_par is not None else None
        ),
        "outer_iters": fista_outer,
        "total_s": round(traj[-1][0], 2),
        "trajectory": [(round(t, 2), round(r, 4)) for t, r in traj],
    }
    if len(traj) > 1:
        # steady rate, first iteration excluded
        dt = (traj[-1][0] - traj[0][0]) / (len(traj) - 1)
        fista_res["iter_s"] = round(1.0 / dt, 4)
    out["fista"] = fista_res
    log(
        f"FISTA: best rel-RMSE {best:.4f}, time-to-RMSE {t_conv:.1f}s, "
        f"{fista_res['iter_s']} iter/s"
    )

    # -- warm-start ADMM-OS24 (production pattern) --------------------------
    geom24 = Geometry(
        detectors_x=N, detectors_y=nz, angles=angles, recon_size=N,
        os_number=24,
    )
    P24 = Projector(geom24)
    n_sub24 = len(P24.subset_indices)
    rho = jnp.float32(1.0)
    tau = jnp.float32(0.9 / (float(L) + 1.0))
    alpha_r = jnp.float32(1.6)
    regul_admm = jnp.float32(regul_param / 1.0)  # regul_param / rho

    def admm_step(carry, sino):
        x, z, u = carry
        for s in range(n_sub24):
            z_old = z
            res = P24.fp_sub(z, s) - P24.sino_subset(sino, s)
            grad = P24.bp_sub(res, s) + rho * (z - x + u)
            z = jnp.maximum(z - tau * grad, 0.0)
            z = (1.0 - alpha_r) * z_old + alpha_r * z
            x = PD_TV(z + u, regul_admm, tv_iters, 0, 1, 12.0)
        u = u + (z - x)
        return x, z, u

    carry_a = (fbp, fbp, jnp.zeros_like(fbp))
    step_a = jax.jit(admm_step).lower(carry_a, sino).compile()
    log("ADMM step compiled; running warm-start trajectory")
    carry_a, traj_a = _trajectory(
        step_a, carry_a, (sino,), phantom, admm_outer, rel_fn
    )
    out["admm"] = {
        "warm_start": "FBP",
        "os": 24,
        "rel_rmse_final": round(traj_a[-1][1], 4),
        "outer_iters": admm_outer,
        "total_s": round(traj_a[-1][0], 2),
        "trajectory": [(round(t, 2), round(r, 4)) for t, r in traj_a],
    }
    log(
        f"ADMM warm-start: rel-RMSE {traj_a[-1][1]:.4f} after "
        f"{admm_outer} outer ({traj_a[-1][0]:.1f}s)"
    )
    return out


def main():
    from tomobar_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    res = run_northstar(
        N=int(os.environ.get("TOMOBAR_NS_N", 2560)),
        nz=int(os.environ.get("TOMOBAR_NS_NZ", 20)),
        nproj=int(os.environ.get("TOMOBAR_NS_NPROJ", 1801)),
        os_number=int(os.environ.get("TOMOBAR_NS_OS", 10)),
        tv_iters=int(os.environ.get("TOMOBAR_NS_TV", 20)),
        fista_outer=int(os.environ.get("TOMOBAR_NS_OUTER", 20)),
        regul_param=float(os.environ.get("TOMOBAR_NS_REG", 2e-4)),
    )
    print(json.dumps(res))


if __name__ == "__main__":
    main()
