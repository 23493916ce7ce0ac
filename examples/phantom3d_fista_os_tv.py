#!/usr/bin/env python3
"""3D phantom -> noisy projections -> FBP vs FISTA-OS-TV, with RMSE.

Worked example mirroring the reference workflow in
``Demos/tomophantom_3D_recon1.py`` (phantom -> ModelSino -> noise -> FBP ->
FISTA-OS with regularisation -> QualityTools RMSE).  TomoPhantom is not a
dependency here: the phantom is a built-in ellipsoid stack and the
projection data comes from the framework's own forward projector, with
Poisson counting noise applied in intensity space.

Run (any backend; uses the GPU automatically when present):

    python examples/phantom3d_fista_os_tv.py
"""

import os
import sys
import timeit

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tomobar_tpu import RecToolsDIRCuPy, RecToolsIRCuPy
from tomobar_tpu.bench.harness import rel_rmse


def ellipsoid_phantom(n: int, nz: int) -> np.ndarray:
    """A Shepp-Logan-like stack of ellipsoids, values in [0, 1]."""
    z, y, x = np.meshgrid(
        np.linspace(-1, 1, nz),
        np.linspace(-1, 1, n),
        np.linspace(-1, 1, n),
        indexing="ij",
    )
    vol = np.zeros((nz, n, n), np.float32)
    # (cx, cy, cz, ax, ay, az, value)
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
        vol += v * (
            ((x - cx) / ax) ** 2 + ((y - cy) / ay) ** 2 + ((z - cz) / az) ** 2
            <= 1.0
        )
    return np.clip(vol, 0.0, None)


def main():
    N_size = int(os.environ.get("TOMOBAR_EXAMPLE_N", 256))
    nz = int(os.environ.get("TOMOBAR_EXAMPLE_NZ", 8))
    angles_num = int(0.5 * np.pi * N_size)
    angles = np.linspace(0.0, np.pi, angles_num, endpoint=False).astype(
        np.float32
    )

    print(f"Building {nz}x{N_size}^2 phantom, {angles_num} angles")
    phantom = ellipsoid_phantom(N_size, nz)

    # forward project + Poisson counting noise in intensity space
    rec_dir = RecToolsDIRCuPy(N_size, 0, nz, 0.0, angles, N_size)
    sino_clean = np.asarray(
        rec_dir.FORWPROJ(phantom, data_axes_labels_order=["detY", "angles", "detX"])
    )
    rng = np.random.default_rng(0)
    I0 = 8000.0
    counts = rng.poisson(I0 * np.exp(-sino_clean / N_size * 4.0))
    sino = (-np.log(np.maximum(counts, 1) / I0) * N_size / 4.0).astype(
        np.float32
    )

    # direct baselines.  cutoff 1.1 is the amplitude-true sinc setting
    # (reference host default); FOURIER_INV keeps the reference's
    # log-polar output scale (~2.5x FBP — visible in the reference's own
    # goldens, test_RecToolsDIRCuPy.py:247-248 vs :562-563), so its RMSE
    # is reported after a least-squares scalar fit.
    t0 = timeit.default_timer()
    fbp = np.asarray(rec_dir.FBP(np.swapaxes(sino, 0, 1), cutoff_freq=1.1))
    t_fbp = timeit.default_timer() - t0
    t0 = timeit.default_timer()
    lprec = np.asarray(rec_dir.FOURIER_INV(sino, filter_type="shepp"))
    t_fi = timeit.default_timer() - t0
    scale = float((lprec * phantom).sum() / np.maximum((lprec**2).sum(), 1e-30))
    print(f"FBP          rel-RMSE {rel_rmse(fbp, phantom):.4f}  ({t_fbp:.2f} s)")
    print(
        f"FOURIER_INV  rel-RMSE {rel_rmse(scale * lprec, phantom):.4f}"
        f"  (scalar-fitted x{scale:.3f}, {t_fi:.2f} s)"
    )

    # FISTA-OS-TV (the flagship iterative config)
    rec_it = RecToolsIRCuPy(N_size, 0, nz, 0.0, angles, N_size, OS_number=8)
    _data_ = {"projection_data": sino, "data_fidelity": "LS"}
    _algorithm_ = {"iterations": 12, "nonnegativity": True}
    _regularisation_ = {
        "method": "PD_TV",
        "regul_param": 2e-4,
        "iterations": 30,
    }
    t0 = timeit.default_timer()
    rec = np.asarray(rec_it.FISTA(_data_, _algorithm_, _regularisation_))
    t_fista = timeit.default_timer() - t0
    print(
        f"FISTA-OS8-TV rel-RMSE {rel_rmse(rec, phantom):.4f}  ({t_fista:.2f} s)"
    )


if __name__ == "__main__":
    main()
