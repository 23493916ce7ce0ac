"""Per-component timing + roofline breakdown of the flagship FISTA config.

Times FP-subset, BP-subset and PD-TV separately and reports, for each, the
achieved useful-FLOP rate and effective device-memory bandwidth against
the card's published peaks, so "fast" is auditable rather than asserted.
Run on the card:

    python -m tomobar_tpu.bench.breakdown

Useful-FLOP accounting (algorithmic work, not implementation ops):

* FP/BP (Joseph): every (z, angle, driven row, detector cell) sample does
  one 2-tap interpolation (2 mul + 1 add) and one accumulate add ->
  4 flops x nz x A x n x det_x.  The least device-memory traffic of one
  call reads the volume once and writes the subset sinogram (or the
  reverse for BP).
* PD-TV: the Chambolle-Pock iteration does ~42 flops/voxel/iter
  (3 forward diffs, norm + projection, divergence, primal + relaxation).
  XLA runs it as one fused chain per iteration, whose least traffic is 9
  float32 moves per voxel (read u, data and three duals; write u and the
  duals).

Peaks come from :data:`PEAKS`, keyed by the device's ``device_kind``; a
device missing from the table is an error, not a default.
"""

import json
import os

import numpy as np

# Published peaks, dense, no sparsity (NVIDIA H100 SXM data sheet).  They
# assume the card's full 700 W power limit; report the card's actual limit
# beside any share of them.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops": 67e12,
        "bf16_flops": 989e12,
        "mem_bytes_s": 3.35e12,
        "source": "NVIDIA H100 SXM data sheet",
    },
}


def peaks(device_kind: str) -> dict:
    """The peak table entry for ``device_kind``; raises for unknown kinds."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            "tomobar_tpu.bench.breakdown.PEAKS"
        ) from None


def projector_flops(nz, n_ang, n, det_x):
    """Useful flops of one FP or BP application (see module docstring)."""
    return 4.0 * nz * n_ang * n * det_x


def projector_bytes(nz, n_ang, n, det_x):
    """Least device-memory traffic of one FP or BP application."""
    return 4.0 * nz * (n * n + n_ang * det_x)


def pd_tv_flops(nz, ny, nx, iters):
    return 42.0 * nz * ny * nx * iters


def pd_tv_bytes(nz, ny, nx, iters):
    return 9.0 * nz * ny * nx * 4.0 * iters


# Below this, a stage timing is dominated by timer noise and any derived
# rate is meaningless.
_MIN_RATE_DT = 5e-5  # 50 us


def _util(rec, key, achieved, peak):
    """Record achieved/peak.  A share above 1.0 is physically impossible,
    so it means the work model is wrong: raise instead of reporting it."""
    util = achieved / peak
    if util > 1.0:
        raise ValueError(
            f"{key} = {util:.3f} exceeds the peak: the work model is wrong"
        )
    rec[key] = round(util, 3)
    return util


def stage_report(name, dt, pk, flops=None, bytes_moved=None):
    """Print + record one stage: ms, achieved float32 GF/s against
    ``pk["fp32_flops"]`` and effective GB/s against ``pk["mem_bytes_s"]``
    (``pk`` from :func:`peaks`).

    Rates are only derived when the timing is above ``_MIN_RATE_DT``."""
    dt = max(dt, 1e-9)
    parts = [f"{name:26s} {dt * 1e3:9.2f} ms"]
    rec = {"ms": round(dt * 1e3, 3)}
    if dt < _MIN_RATE_DT:
        if flops or bytes_moved:
            rec["below_timer_resolution"] = True
            parts.append("(too fast to rate)")
        print("  ".join(parts))
        return rec
    if flops:
        gfs = flops / dt
        rec["gflops"] = round(gfs / 1e9, 1)
        util = _util(rec, "fp32_util", gfs, pk["fp32_flops"])
        parts.append(f"{gfs / 1e9:8.0f} GF/s ({100 * util:5.1f}% fp32)")
    if bytes_moved:
        bw = bytes_moved / dt
        rec["mem_gbs"] = round(bw / 1e9, 1)
        util = _util(rec, "mem_util", bw, pk["mem_bytes_s"])
        parts.append(f"{bw / 1e9:7.0f} GB/s ({100 * util:5.1f}% mem)")
    print("  ".join(parts))
    return rec


def flagship_breakdown(N, nz, nproj, os_number, tv_iters, reps=10):
    """Measure FP/BP/TV of the flagship config; returns a dict of stage
    records (ms + achieved rates + roofline fractions)."""
    import jax
    import jax.numpy as jnp

    from tomobar_tpu.geometry import Geometry
    from tomobar_tpu.ops.projector import Projector
    from tomobar_tpu.regularisers import PD_TV
    from tomobar_tpu.bench.harness import time_fn

    pk = peaks(jax.devices()[0].device_kind)

    angles = np.linspace(0, np.pi, nproj, endpoint=False)
    geom = Geometry(
        detectors_x=N, detectors_y=nz, angles=angles, recon_size=N,
        os_number=os_number,
    )
    P = Projector(geom)
    n_sub_ang = len(P.subset_indices[0])

    key = jax.random.PRNGKey(0)
    x = jax.random.uniform(key, (nz, N, N), dtype=jnp.float32)
    sub0 = jax.random.uniform(key, (nz, n_sub_ang, N), dtype=jnp.float32)

    fp0 = jax.jit(lambda v: P.fp_sub(v, 0))
    bp0 = jax.jit(lambda s: P.bp_sub(s, 0))
    tv = jax.jit(lambda v: PD_TV(v, 1e-4, tv_iters, 0, 1, 12.0))

    out = {}
    t_fp = time_fn(fp0, x, reps=reps)
    out["fp_sub"] = stage_report(
        f"FP subset ({n_sub_ang} ang)", t_fp, pk,
        flops=projector_flops(nz, n_sub_ang, N, N),
        bytes_moved=projector_bytes(nz, n_sub_ang, N, N),
    )
    t_bp = time_fn(bp0, sub0, reps=reps)
    out["bp_sub"] = stage_report(
        f"BP subset ({n_sub_ang} ang)", t_bp, pk,
        flops=projector_flops(nz, n_sub_ang, N, N),
        bytes_moved=projector_bytes(nz, n_sub_ang, N, N),
    )
    t_tv = time_fn(tv, x, reps=reps)
    out["pd_tv"] = stage_report(
        f"PD-TV x{tv_iters}", t_tv, pk,
        flops=pd_tv_flops(nz, N, N, tv_iters),
        bytes_moved=pd_tv_bytes(nz, N, N, tv_iters),
    )
    est = os_number * (t_fp + t_bp + t_tv)
    out["outer_estimate_ms"] = round(est * 1e3, 2)
    print(f"{'outer estimate (' + str(os_number) + ' subsets)':26s} "
          f"{est * 1e3:9.2f} ms  -> {1.0 / est:0.3f} iter/s upper bound")
    return out


def main():
    import jax

    from tomobar_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    d = jax.devices()[0]
    pk = peaks(d.device_kind)
    print(f"platform={d.platform} kind={d.device_kind}")
    print(
        f"peaks ({pk['source']}): fp32 {pk['fp32_flops'] / 1e12:.0f} TF/s, "
        f"memory {pk['mem_bytes_s'] / 1e9:.0f} GB/s"
    )

    N = int(os.environ.get("TOMOBAR_BENCH_N", 2560))
    nz = int(os.environ.get("TOMOBAR_BENCH_NZ", 8))
    nproj = int(os.environ.get("TOMOBAR_BENCH_NPROJ", 1801))
    os_number = int(os.environ.get("TOMOBAR_BENCH_OS", 10))
    tv_iters = int(os.environ.get("TOMOBAR_BENCH_TV_ITERS", 20))

    out = flagship_breakdown(N, nz, nproj, os_number, tv_iters)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
