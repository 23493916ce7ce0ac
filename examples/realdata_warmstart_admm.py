#!/usr/bin/env python3
"""Production pattern: normalise raw counts -> FBP warm start -> ADMM-OS24.

Worked example of the reference's real-data recipe
(``Demos/RealData.py:228-235``, CHANGELOG v2026.2.0.0): flat/dark-field
normalisation with -log transform, a padded FBP used as the ADMM
initialiser, then 2 outer ADMM iterations with 24 ordered subsets, PWLS
fidelity, over-relaxation 1.7 and PD-TV regularisation — the configuration
that converges in ~2-3 outer iterations on beamline data.

Raw data here is synthesised (counts through a phantom with flats/darks)
so the script runs self-contained:

    python examples/realdata_warmstart_admm.py
"""

import os
import sys
import timeit

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tomobar_tpu import RecToolsDIRCuPy, RecToolsIRCuPy
from tomobar_tpu.bench.harness import rel_rmse
from tomobar_tpu.utils.tools import normaliser

from phantom3d_fista_os_tv import ellipsoid_phantom


def synth_raw_counts(phantom, angles, I0=6000.0, n_flats=20, n_darks=10):
    """Raw projections/flats/darks (angles, detY, detX) like a beamline."""
    from tomobar_tpu import RecToolsDIR

    nz, N, _ = phantom.shape
    rt = RecToolsDIR(N, 0, nz, 0.0, angles, N)
    sino = np.asarray(
        rt.FORWPROJ(phantom, data_axes_labels_order=["detY", "angles", "detX"])
    )
    rng = np.random.default_rng(1)
    flat_field = I0 * (1.0 + 0.05 * rng.standard_normal((nz, N)))
    dark_field = 40.0 * np.ones((nz, N))
    intensity = (
        flat_field[:, None, :] * np.exp(-sino / N * 4.0)
        + dark_field[:, None, :]
    )
    proj = rng.poisson(np.swapaxes(intensity, 0, 1)).astype(np.float32)
    flats = rng.poisson(
        flat_field[None] + dark_field[None], (n_flats, nz, N)
    ).astype(np.float32)
    darks = rng.poisson(dark_field[None] * np.ones((n_darks, nz, N))).astype(
        np.float32
    )
    return proj, flats, darks


def main():
    N_size = int(os.environ.get("TOMOBAR_EXAMPLE_N", 256))
    nz = int(os.environ.get("TOMOBAR_EXAMPLE_NZ", 8))
    angles = np.linspace(0, np.pi, 360, endpoint=False).astype(np.float32)
    phantom = ellipsoid_phantom(N_size, nz)
    proj, flats, darks = synth_raw_counts(phantom, angles)

    # flat/dark normalisation + -log (suppTools.normaliser equivalent);
    # axis=0 reduces the flats/darks stacks
    data_norm = normaliser(proj, flats, darks, log=True, method="mean")
    data_norm = np.ascontiguousarray(
        np.swapaxes(data_norm, 0, 1) * N_size / 4.0
    )  # -> (detY, angles, detX), undo the attenuation scaling

    # padded FBP warm start (the reference feeds the *padded-grid* FBP)
    pad = 24
    rec_dir = RecToolsDIRCuPy(
        N_size, pad, nz, 0.0, angles, N_size + 2 * pad
    )
    t0 = timeit.default_timer()
    fbp_warm = np.asarray(
        rec_dir.FBP(np.swapaxes(data_norm, 0, 1), cutoff_freq=1.1)
    )
    t_fbp = timeit.default_timer() - t0
    print(f"warm-start FBP done ({t_fbp:.2f} s), grid {fbp_warm.shape}")

    # ADMM-OS24, 2 outer iterations, warm-started (RealData.py:228-235)
    rec_it = RecToolsIRCuPy(
        N_size, pad, nz, 0.0, angles, N_size, OS_number=24
    )
    _data_ = {
        "projection_data": data_norm,
        "data_fidelity": "PWLS",
    }
    _algorithm_ = {
        "initialise": fbp_warm,  # padded-grid volume
        "iterations": 2,
        "ADMM_rho_const": 0.9,
        "ADMM_relax_par": 1.7,
        "recon_mask_radius": 2.0,  # radius > 1: no cropping (suppTools.py:387)
    }
    _regularisation_ = {
        "method": "PD_TV",
        "regul_param": 3e-4,
        "iterations": 40,
    }
    t0 = timeit.default_timer()
    rec = np.asarray(rec_it.ADMM(_data_, _algorithm_, _regularisation_))
    t_admm = timeit.default_timer() - t0

    print(f"FBP warm start rel-RMSE {rel_rmse(fbp_warm[:, pad:-pad, pad:-pad] if pad else fbp_warm, phantom):.4f}")
    print(f"ADMM-OS24 x2   rel-RMSE {rel_rmse(rec, phantom):.4f}  ({t_admm:.2f} s)")


if __name__ == "__main__":
    main()
