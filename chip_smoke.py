#!/usr/bin/env python3
"""Smoke run of the reconstruction path on NVIDIA GPUs.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --chips 4   # four cards: the sharded path only

One card, through the public classes at the flagship width (1801 angles x
8 slices x 2560 detector columns, a Shepp-Logan-like phantom built on the
device):

1. the card's name and power limit, the JAX version and ``XLA_FLAGS``;
2. the Joseph projector kernels against the XLA reference on the card,
   and their adjointness (float64 inner products on the host);
3. PD-TV x20 on the card against the same call on the host CPU backend;
4. FISTA-OS10-PWLS-TV20 (2 outer iterations, power-method Lipschitz
   constant) and warm-started (FBP) ADMM-OS24, each against the same solve
   through a ``Projector(impl="xla")``; the RMSE against the phantom must
   fall;
5. FBP (3D and 2D) against FBP on the reference backprojector, FOURIER_INV
   2D against the host CPU, and 3D FOURIER_INV against a Ram-Lak FBP;
6. the card-only tests (``pytest -m gpu``) in this process;
7. timings, each beside the card's name and power limit.

Four cards: FISTA-OS10-PWLS-TV20 at 1801 x 20 x 2560 on a ("z", "angles")
= (2, 2) mesh, FBP on a (4, 1) mesh (5 slices per card) and FOURIER_INV on
a (4, 1) mesh (6 slices per card: its slice-pair packing needs whole pairs
per card), each against the single-card result on device 0.

Every comparison runs under ``jax.default_matmul_precision("highest")``
and prints its tolerance and measured error.  Without a GPU the script
exits with code 2 before printing anything; a failed phase makes it exit
with code 1.  The last line of standard output is the JSON result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

N, NZ, NPROJ = 2560, 8, 1801
NZ_MESH = 20  # slices of the four-card FISTA phase
NZ_MESH_FI = 24  # slices of the four-card FOURIER_INV phase
TV = {"method": "PD_TV", "regul_param": 2e-4, "iterations": 20}

FAILURES: list = []
CARD = "?"
COMPILE_S = [0.0]


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check(name: str, err: float, tol: float, above: bool = False) -> None:
    """Record one comparison; ``above`` means the value must exceed tol."""
    ok = bool(np.isfinite(err) and (err > tol if above else err <= tol))
    rel = ">" if above else "<="
    log(f"check {name}: {err:.3e} (needs {rel} {tol:g}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        FAILURES.append(name)


def timing(name: str, ms: float) -> None:
    log(f"time [{CARD}] {name}: {ms:.3f} ms")


def timed(f, *args, reps: int = 3):
    """(result, steady ms, compile s): the first call compiles."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(f(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    steady = float(np.median(ts))
    COMPILE_S[0] += max(first - steady, 0.0)
    return out, steady * 1e3


def run_phase(fn, *args) -> None:
    log(f"== {fn.__name__}")
    try:
        fn(*args)
    except Exception:  # a failed phase fails the run, the others still run
        traceback.print_exc()
        FAILURES.append(fn.__name__)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return "; ".join(line.strip() for line in out.splitlines()) or "?"


def rmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def vdot64(a, b) -> float:
    return float(np.vdot(np.asarray(a, np.float64), np.asarray(b, np.float64)))


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------


class Problem:
    """The flagship geometry, phantom and its sinogram (kernel FP)."""

    def __init__(self, nz: int = NZ):
        import jax

        from tomobar_tpu.bench.northstar import ellipsoid_phantom_jax
        from tomobar_tpu.geometry import Geometry
        from tomobar_tpu.ops.projector import Projector

        self.nz = nz
        self.angles = np.linspace(0, np.pi, NPROJ, endpoint=False)
        self.geom = Geometry(
            detectors_x=N, detectors_y=nz, angles=self.angles, recon_size=N,
            os_number=10,
        )
        self.phantom = ellipsoid_phantom_jax(N, nz)
        self.P = Projector(self.geom)
        self.P_ref = Projector(self.geom, impl="xla")
        self.sino = jax.block_until_ready(jax.jit(self.P.fp)(self.phantom))


def phase_projector(pb: Problem) -> None:
    import jax

    P, R = pb.P, pb.P_ref
    fp_k, _ = timed(jax.jit(P.fp), pb.phantom, reps=1)
    fp_x, _ = timed(jax.jit(R.fp), pb.phantom, reps=1)
    check(f"FP kernel vs XLA reference ({NPROJ}x{pb.nz}x{N}), rel L2",
          rel_l2(fp_k, fp_x), 1e-5)
    bp_k, _ = timed(jax.jit(P.bp), pb.sino, reps=1)
    bp_x, _ = timed(jax.jit(R.bp), pb.sino, reps=1)
    check(f"BP kernel vs XLA reference ({NPROJ}x{pb.nz}x{N}), rel L2",
          rel_l2(bp_k, bp_x), 1e-5)
    y = jax.random.uniform(jax.random.PRNGKey(1), pb.sino.shape)
    lhs = vdot64(fp_k, y)
    rhs = vdot64(pb.phantom, jax.jit(P.bp)(y))
    check("adjointness |<Ax,y> - <x,A^T y>| / |<Ax,y>|",
          abs(lhs - rhs) / abs(lhs), 1e-5)
    # one OS10 subset, as the solvers call it
    sub = P.sino_subset(pb.sino, 0)
    for name, op in (("kernel", P), ("XLA", R)):
        _, ms = timed(jax.jit(lambda v, op=op: op.fp_sub(v, 0)), pb.phantom)
        timing(f"FP subset ({sub.shape[1]} angles x {pb.nz} x {N}) {name}", ms)
        _, ms = timed(jax.jit(lambda s, op=op: op.bp_sub(s, 0)), sub)
        timing(f"BP subset ({sub.shape[1]} angles x {pb.nz} x {N}) {name}", ms)


def phase_pd_tv(pb: Problem) -> None:
    import jax

    from tomobar_tpu.regularisers import PD_TV

    def tv(v):
        return PD_TV(v, 0.02, 20, 0, 1, 8.0)

    noise = jax.random.normal(jax.random.PRNGKey(2), (1, N, N))
    x = pb.phantom[pb.nz // 2 : pb.nz // 2 + 1] + 0.05 * noise
    gpu, ms = timed(jax.jit(tv), x)
    timing(f"PD-TV x20 (1 x {N}^2)", ms)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        host = jax.jit(tv)(jax.device_put(x, cpu))
    check(f"PD-TV x20 card vs host CPU (1 x {N}^2), rel L2",
          rel_l2(gpu, host), 1e-5)
    reg = TV
    _, ms = timed(
        jax.jit(lambda v: PD_TV(v, reg["regul_param"], 20, 0, 1, 12.0)),
        pb.phantom,
    )
    timing(f"PD-TV x20 ({pb.nz} x {N}^2, the FISTA prox)", ms)


def _iterative(pb: Problem, os_number: int, xla: bool):
    from tomobar_tpu import RecToolsIRCuPy
    from tomobar_tpu.ops.projector import Projector

    rt = RecToolsIRCuPy(N, 0, pb.nz, 0.0, pb.angles, N, OS_number=os_number)
    if xla:
        rt.Atools = Projector(rt._geometry, impl="xla")
    return rt


def _timed_solve(solve, *dicts):
    """Run ``solve`` on copies of its dicts; returns (result, seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(solve(*[dict(d) for d in dicts]))
    return out, time.perf_counter() - t0


def phase_solvers(pb: Problem) -> None:
    import jax.numpy as jnp

    from tomobar_tpu import RecToolsDIRCuPy

    data = {"projection_data": pb.sino, "data_fidelity": "PWLS"}
    alg = {"iterations": 2, "nonnegativity": True}
    rec, its = {}, {}
    for name, xla in (("kernel", False), ("XLA", True)):
        rt = _iterative(pb, 10, xla)
        rec[name], t = _timed_solve(rt.FISTA, data, alg, TV)
        log(f"FISTA {name}: first call (power method, compile, 2 outer "
            f"iterations) {t:.2f} s")
        # outer-iteration rate: the verbose loop reuses its compiled step
        # across calls, so the second call runs 3 compiled sweeps
        va = {"iterations": 3, "nonnegativity": True, "verbose": True}
        _timed_solve(rt.FISTA, data, va, TV)
        _, t = _timed_solve(rt.FISTA, data, va, TV)
        its[name] = 3.0 / t
        log(f"time [{CARD}] FISTA-OS10-PWLS-TV20 outer iterations/s "
            f"({NPROJ}x{pb.nz}x{N}) {name}: {its[name]:.4f}")
    check("FISTA kernel vs XLA-reference solve, rel L2",
          rel_l2(rec["kernel"], rec["XLA"]), 1e-4)
    r0 = rmse(0.0 * pb.phantom, pb.phantom)
    r2 = rmse(rec["kernel"], pb.phantom)
    log(f"FISTA RMSE vs phantom: {r0:.5f} at x0 = 0 -> {r2:.5f}")
    check("FISTA RMSE falls (rmse / rmse at x0 = 0)", r2 / r0, 0.999)

    fbp = RecToolsDIRCuPy(N, 0, pb.nz, 0.0, pb.angles, N).FBP(
        jnp.swapaxes(pb.sino, 0, 1)
    )
    data = {"projection_data": pb.sino}
    alg = {"iterations": 2, "nonnegativity": True, "initialise": fbp}
    admm = {}
    for name, xla in (("kernel", False), ("XLA", True)):
        rt = _iterative(pb, 24, xla)
        admm[name], t = _timed_solve(rt.ADMM, data, alg, TV)
        log(f"ADMM-OS24 {name}: 2 outer iterations incl. power method and "
            f"compile {t:.2f} s")
    check("ADMM (warm start: FBP) kernel vs XLA-reference solve, rel L2",
          rel_l2(admm["kernel"], admm["XLA"]), 1e-4)
    rf, ra = rmse(fbp, pb.phantom), rmse(admm["kernel"], pb.phantom)
    log(f"ADMM RMSE vs phantom: {rf:.5f} at the FBP warm start -> {ra:.5f}")
    check("ADMM RMSE falls (rmse / rmse of the FBP warm start)", ra / rf,
          0.999)


def phase_direct(pb: Problem) -> None:
    import jax
    import jax.numpy as jnp

    from tomobar_tpu import RecToolsDIRCuPy
    from tomobar_tpu.ops.projector import Projector

    def direct(nz, xla=False):
        rd = RecToolsDIRCuPy(N, 0, nz, 0.0, pb.angles, N)
        if xla:
            rd.Atools = Projector(rd.geom, impl="xla")
        return rd

    rd, rd_x = direct(pb.nz), direct(pb.nz, xla=True)
    rd2, rd2_x = direct(None), direct(None, xla=True)
    s3 = jnp.swapaxes(pb.sino, 0, 1)  # FBP 3D takes [angles, detY, detX]
    s2 = pb.sino[pb.nz // 2]
    fbp3, ms = timed(jax.jit(rd.FBP), s3)
    timing(f"FBP 3D ({NPROJ}x{pb.nz}x{N}) kernel", ms)
    fbp3_x, ms = timed(jax.jit(rd_x.FBP), s3, reps=1)
    timing(f"FBP 3D ({NPROJ}x{pb.nz}x{N}) XLA", ms)
    check("FBP 3D kernel vs XLA-reference BP, rel L2", rel_l2(fbp3, fbp3_x),
          1e-5)
    fbp2, ms = timed(jax.jit(rd2.FBP), s2)
    timing(f"FBP 2D ({NPROJ}x{N}) kernel", ms)
    check("FBP 2D kernel vs XLA-reference BP, rel L2",
          rel_l2(fbp2, jax.jit(rd2_x.FBP)(s2)), 1e-5)

    fi2, ms = timed(jax.jit(rd2.FOURIER_INV), s2)
    timing(f"FOURIER_INV 2D ({NPROJ}x{N})", ms)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        fi2_host = jax.jit(rd2.FOURIER_INV)(jax.device_put(s2, cpu))
    check("FOURIER_INV 2D card vs host CPU, rel L2", rel_l2(fi2, fi2_host),
          1e-4)
    fi3, ms = timed(jax.jit(rd.FOURIER_INV), pb.sino)
    timing(f"FOURIER_INV 3D ({NPROJ}x{pb.nz}x{N})", ms)
    ramlak = jax.jit(lambda s: rd.FBP(s, filter_type="ram-lak"))(s3)
    yy, xx = np.mgrid[0:N, 0:N]
    disk = np.hypot(yy - (N - 1) / 2, xx - (N - 1) / 2) < N / 2 - 2
    corr = np.corrcoef(
        np.asarray(fi3)[:, disk].ravel(), np.asarray(ramlak)[:, disk].ravel()
    )[0, 1]
    check("FOURIER_INV 3D vs Ram-Lak FBP, correlation in the inscribed "
          "circle", float(corr), 0.99, above=True)
    _fourier_stages(pb)


def _fourier_stages(pb: Problem) -> None:
    """Card time of the FOURIER_INV stages that run in plain XLA: the
    filter (rfft/irfft), the 1-D FFT, the gridding scatter-add and the
    2-D inverse FFT."""
    import math

    import jax

    from tomobar_tpu.ops import usfft as U
    from tomobar_tpu.ops.fft_real import fft_pairs

    n, eps = N, 1e-4
    theta = -np.asarray(pb.angles, np.float64)
    ow = 2 ** math.ceil(math.log2(3 * n))
    filt, ms = timed(jax.jit(lambda d: U._fbp_filter_stage(
        d, n, n, "shepp", 1.0, 0.5)), pb.sino)
    timing(f"FOURIER_INV stage filter (rfft/irfft at {ow})", ms)
    dre, dim = jax.jit(U._pack_pairs)(filt)
    _, ms = timed(jax.jit(fft_pairs), dre, dim)
    timing(f"FOURIER_INV stage fft1d ({dre.shape[0]}x{NPROJ}x{n})", ms)
    (fre, fim), ms = timed(
        jax.jit(lambda r, i: U.usfft_grid(r, i, n, theta, eps)), dre, dim
    )
    timing("FOURIER_INV stage fft1d + gridding scatter-add", ms)
    _, ms = timed(jax.jit(lambda r, i: U._ifft2_centered(r, i, n)), fre, fim)
    timing(f"FOURIER_INV stage ifft2 ({2 * n}^2 x {dre.shape[0]})", ms)


def phase_card_tests() -> None:
    import pytest

    rc = pytest.main([
        "-q", "-m", "gpu", "--on-card", "-p", "no:cacheprovider",
        os.path.join(ROOT, "tests"),
    ])
    check("card-only tests (pytest -m gpu), exit code", float(rc), 0.0)


def one_card() -> None:
    pb = Problem()
    run_phase(phase_projector, pb)
    run_phase(phase_pd_tv, pb)
    run_phase(phase_solvers, pb)
    run_phase(phase_direct, pb)
    run_phase(phase_card_tests)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def phase_mesh_fista() -> None:
    import jax

    from tomobar_tpu.parallel.sharding import ShardedProjector, make_mesh

    pb = Problem(NZ_MESH)
    mesh = make_mesh(2, 2)
    rt = _iterative(pb, 10, False)
    rt_mesh = _iterative(pb, 10, False)
    sp = ShardedProjector(rt_mesh._geometry, mesh)
    rt_mesh.Atools = sp
    data = {"projection_data": pb.sino, "data_fidelity": "PWLS"}
    alg = {"iterations": 2, "nonnegativity": True}
    one, t1 = _timed_solve(rt.FISTA, data, alg, TV)
    log(f"FISTA one card: {t1:.2f} s (power method, compile, 2 outer "
        "iterations)")
    mdata = dict(data, projection_data=sp.device_put_sino(pb.sino))
    four, t4 = _timed_solve(rt_mesh.FISTA, mdata, alg, TV)
    log(f"FISTA (z, angles) = (2, 2) mesh: {t4:.2f} s (same work)")
    check(f"FISTA-OS10-PWLS-TV20 ({NPROJ}x{NZ_MESH}x{N}) (2, 2) mesh vs "
          "device 0, rel L2", rel_l2(four, one), 1e-4)
    jax.block_until_ready(four)


def phase_mesh_direct() -> None:
    import jax
    import jax.numpy as jnp

    from tomobar_tpu import RecToolsDIRCuPy
    from tomobar_tpu.parallel import ShardedDirect
    from tomobar_tpu.parallel.sharding import make_mesh

    mesh = make_mesh(4, 1)
    for nz, method in ((NZ_MESH, "fbp"), (NZ_MESH_FI, "fourier_inv")):
        pb = Problem(nz)
        rd = RecToolsDIRCuPy(N, 0, nz, 0.0, pb.angles, N)
        sd = ShardedDirect(rd, mesh)
        if method == "fbp":
            single = jax.jit(lambda s: rd.FBP(jnp.swapaxes(s, 0, 1)))
        else:
            single = jax.jit(rd.FOURIER_INV)
        one, ms1 = timed(single, pb.sino)
        four, ms4 = timed(jax.jit(getattr(sd, method)),
                          sd.device_put_sino(pb.sino))
        timing(f"{method} ({NPROJ}x{nz}x{N}) device 0", ms1)
        timing(f"{method} ({NPROJ}x{nz}x{N}) (4, 1) mesh", ms4)
        check(f"{method} ({nz // 4} slices per card) (4, 1) mesh vs device "
              "0, rel L2", rel_l2(four, one), 1e-5)


def four_cards() -> None:
    run_phase(phase_mesh_fista)
    run_phase(phase_mesh_direct)


# ---------------------------------------------------------------------------


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="1: every single-card phase; 4: the sharded path")
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < args.chips:
        print(f"chip_smoke.py needs {args.chips} NVIDIA GPU(s); JAX found "
              f"{len(devs)} x {devs[0].platform}", file=sys.stderr)
        return 2
    from tomobar_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    CARD = card_line()
    log(f"card: {CARD}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
        f"; {len(devs)} x {devs[0].device_kind}; compile cache {cache}")
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        if args.chips == 1:
            one_card()
        else:
            four_cards()
    peak = max(d.memory_stats().get("peak_bytes_in_use", 0) for d in devs)
    log(f"[{CARD}] wall {time.perf_counter() - t0:.1f} s, compile about "
        f"{COMPILE_S[0]:.1f} s in the timed calls, peak_bytes_in_use {peak}")
    if FAILURES:
        log(f"FAILED: {FAILURES}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
