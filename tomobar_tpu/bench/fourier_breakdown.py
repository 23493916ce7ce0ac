"""Per-stage timing of FOURIER_INV (the log-polar path).

The reference sweats this path hardest (``fft_us_kernels.cu:105-527``'s
centre-gather and angle-range pruning exist purely for speed;
``CHANGELOG.md:64`` claims "significantly faster than FBP"), so "fast"
needs per-stage evidence, like ``bench/breakdown.py`` provides for FISTA.

Stages (ops/usfft.py pipeline, bench shape nz x nproj x N):

* ``filter``  — STEP0 oversampled FBP filtering (rfft/irfft at
  ow = 2^ceil(log2(3N)) per (z, angle) row).
* ``fft1d``   — STEP1 pack pairs + length-n FFT + fftshift scale.
* ``grid``    — STEP1+2 ``usfft_grid``: the length-n FFT again plus the
  Gaussian-kernel scatter-add onto (2n, 2n).
* ``ifft2``   — STEP3 checkerboard + half-pixel ramp + ifft2 at 2n.
* ``unpad``   — STEP4 crop + phi multiply + pair unpack (memory-bound,
  reported against the card's memory bandwidth).

The FFT stages run in cuFFT and report time only.

Run:  python -m tomobar_tpu.bench.fourier_breakdown
"""

import json
import os

import numpy as np

from tomobar_tpu.bench.breakdown import peaks, stage_report


def fourier_breakdown(N, nz, nproj, reps=5):
    import jax
    import jax.numpy as jnp

    from tomobar_tpu.bench.harness import time_fn
    from tomobar_tpu.models.direct import RecToolsDIRTPU
    from tomobar_tpu.ops import usfft as U
    from tomobar_tpu.ops.fft_real import fft_pairs

    pk = peaks(jax.devices()[0].device_kind)
    angles = np.linspace(0, np.pi, nproj, endpoint=False).astype(np.float32)
    model = RecToolsDIRTPU(N, 0, nz, 0.0, angles, N)
    rng = np.random.default_rng(0)
    data = jnp.asarray(rng.standard_normal((nz, nproj, N)).astype(np.float32))

    n = N  # no padding in the bench config
    import math

    ow = 2 ** math.ceil(math.log2(n * 3))
    eps = 1e-4
    mu = -np.log(eps) / (2 * n * n)
    theta = -np.asarray(model.geom.angles, dtype=np.float64)

    out = {"shape": f"{nproj}x{nz}x{N}", "oversampled_width": ow}

    # --- stage callables (jitted separately) -------------------------------
    filt = jax.jit(
        lambda d: U._fbp_filter_stage(d, n, n, "shepp", 1.0, 0.5)
    )
    filtered = filt(data)

    def fft1d_fn(f):
        dre, dim = U._pack_pairs(f)
        sre, sim = fft_pairs(dre, dim)
        sign = jnp.where(jnp.arange(n) % 2 == 1, 1.0, -1.0).astype(jnp.float32)
        return sre * (sign * (4.0 / n)), sim * (sign * (4.0 / n))

    fft1d = jax.jit(fft1d_fn)
    dre, dim = jax.jit(lambda f: U._pack_pairs(f))(filtered)
    grid = jax.jit(
        lambda r, i: U.usfft_grid(r, i, n, theta, eps)
    )
    fre, fim = grid(dre, dim)
    ifft2 = jax.jit(lambda r, i: U._ifft2_centered(r, i, n))
    gre, gim = ifft2(fre, fim)
    unpad = jax.jit(
        lambda r, i: U._unpad_mul_phi(r, i, n, nproj, nz, False, False, N, mu)
    )

    full = jax.jit(lambda d: U.fourier_inv(model, d))

    pairs = nz // 2
    unpad_bytes = pairs * 2 * (2 * n) * (2 * n) * 4 + nz * N * N * 4

    # --- measure ------------------------------------------------------------
    res = {}
    t = time_fn(filt, data, reps=reps)
    res["filter"] = stage_report(f"filter (ow={ow})", t, pk)
    t = time_fn(fft1d, filtered, reps=reps)
    res["fft1d"] = stage_report("pack + fft1d", t, pk)
    t = time_fn(grid, dre, dim, reps=reps)
    res["grid"] = stage_report("fft1d + usfft gridding", t, pk)
    t = time_fn(ifft2, fre, fim, reps=reps)
    res["ifft2"] = stage_report(f"ifft2 ({2*n}^2)", t, pk)
    t = time_fn(unpad, gre, gim, reps=reps)
    res["unpad"] = stage_report("unpad * phi", t, pk, bytes_moved=unpad_bytes)
    t = time_fn(full, data, reps=reps)
    res["total_ms"] = round(t * 1e3, 2)
    # fft1d is contained in grid, so it stays out of the stage sum
    ssum = sum(
        v["ms"] for k, v in res.items() if isinstance(v, dict) and k != "fft1d"
    )
    res["stage_sum_ms"] = round(ssum, 2)
    print(f"{'total':26s} {res['total_ms']:9.2f} ms   (stage sum {ssum:.2f})")
    out["stages"] = res
    return out


def main():
    from tomobar_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    N = int(os.environ.get("TOMOBAR_BENCH_N", 2560))
    nz = int(os.environ.get("TOMOBAR_BENCH_NZ", 8))
    nproj = int(os.environ.get("TOMOBAR_BENCH_NPROJ", 1801))
    print(json.dumps(fourier_breakdown(N, nz, nproj)))


if __name__ == "__main__":
    main()
