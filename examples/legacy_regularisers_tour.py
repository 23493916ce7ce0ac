#!/usr/bin/env python3
"""Tour of the legacy regulariser family on a noisy phantom slice.

Mirrors the retired ``RecToolsIR`` surface exercised by the reference's
legacy demos (``Demos/methods_IR_legacy/DemoFISTA_artifacts3D.py:204-298``,
``DemoFISTA_NLTV_2D.py``): FGP-TV, SB-TV, LLT-ROF, TGV, NDF, Diff4th,
NLTV and Haar wavelet shrinkage — here as device-resident denoisers, plus one
FISTA reconstruction with a combined ``PD_TV_WAVELETS`` prox.

Run:  python examples/legacy_regularisers_tour.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tomobar_tpu import RecToolsIRCuPy
from tomobar_tpu.bench.harness import rel_rmse
from tomobar_tpu.ops.projector import Projector
from tomobar_tpu.geometry import Geometry
from tomobar_tpu.regularisers_legacy import (
    FGP_TV, SB_TV, LLT_ROF, TGV, NDF, Diff4th, NLTV, patch_select,
    WAVELET_SHRINK,
)


def shepp_like(n: int) -> np.ndarray:
    y, x = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                       indexing="ij")
    img = np.zeros((n, n), np.float32)
    for cx, cy, ax, ay, v in [
        (0.0, 0.0, 0.69, 0.90, 1.0),
        (0.0, -0.02, 0.62, 0.85, -0.6),
        (0.22, 0.0, 0.11, 0.31, -0.2),
        (-0.22, 0.0, 0.16, 0.41, -0.2),
        (0.0, 0.35, 0.21, 0.25, 0.3),
    ]:
        img += v * (((x - cx) / ax) ** 2 + ((y - cy) / ay) ** 2 <= 1.0)
    return np.clip(img, 0.0, None)


def main():
    n = int(os.environ.get("TOMOBAR_EXAMPLE_N", 160))
    rng = np.random.default_rng(0)
    clean = shepp_like(n)
    noisy = (clean + 0.12 * rng.standard_normal(clean.shape)).astype(
        np.float32
    )
    print(f"{n}x{n} phantom, noisy rel-RMSE {rel_rmse(noisy, clean):.4f}\n")

    # --- denoiser tour (prox operators applied directly) -----------------
    runs = [
        ("FGP_TV", lambda u: FGP_TV(u, 0.08, 150)),
        ("SB_TV", lambda u: SB_TV(u, 0.08, 80)),
        ("LLT_ROF", lambda u: LLT_ROF(u, 0.03, 0.015, 400)),
        ("TGV", lambda u: TGV(u, 0.08, 1.0, 2.0, 400)),
        ("NDF (Huber)", lambda u: NDF(u, 0.06, 0.05, 300, penalty_type=1)),
        ("Diff4th", lambda u: Diff4th(u, 0.5, 0.06, 500)),
        ("WAVELETS", lambda u: WAVELET_SHRINK(u, 0.05, levels=3)),
    ]
    for name, fn in runs:
        out = np.asarray(fn(noisy))
        print(f"{name:12s} rel-RMSE {rel_rmse(out, clean):.4f}")

    hi, hj, w = patch_select(noisy, search_window=5, similarity_window=1,
                             neighbours=9, edge_parameter=0.25)
    out = np.asarray(NLTV(noisy, hi, hj, w, 0.08, 8))
    print(f"{'NLTV':12s} rel-RMSE {rel_rmse(out, clean):.4f}\n")

    # --- FISTA with a combined legacy prox -------------------------------
    angles = np.linspace(0, np.pi, int(1.5 * n), endpoint=False).astype(
        np.float32
    )
    geom = Geometry(detectors_x=n, detectors_y=1, angles=angles,
                    recon_size=n)
    sino = np.asarray(Projector(geom).fp(clean[None]))[0]
    sino = (sino + 0.8 * rng.standard_normal(sino.shape)).astype(np.float32)

    rt = RecToolsIRCuPy(n, 0, None, 0.0, angles, n, OS_number=5)
    rec = rt.FISTA(
        {"projection_data": sino},
        {"iterations": 12, "nonnegativity": True},
        {"method": "PD_TV_WAVELETS", "regul_param": 5e-4,
         "regul_param2": 2e-3, "iterations": 40},
    )
    print(
        f"FISTA-OS5 + PD_TV_WAVELETS rel-RMSE "
        f"{rel_rmse(np.asarray(rec)[0], clean):.4f}"
    )


if __name__ == "__main__":
    main()
