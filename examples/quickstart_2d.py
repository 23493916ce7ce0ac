#!/usr/bin/env python3
"""2D quick-start: phantom -> sinogram -> FBP -> FISTA-TV in ~30 lines.

The smallest end-to-end tour of the framework, mirroring the reference's
2D entry demo (``Demos/tomophantom_2D_recon1.py``: build phantom, forward
project, FBP with the sinc filter, iterative recon with TV).  Everything
runs on whatever backend JAX finds (the GPU when present, CPU otherwise).

Run:

    python examples/quickstart_2d.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tomobar_tpu import RecToolsDIR, RecToolsIRCuPy


def shepp_logan(n: int) -> np.ndarray:
    """Classic ellipse phantom (value, a, b, x0, y0, phi_deg)."""
    ellipses = [
        (1.0, 0.69, 0.92, 0.0, 0.0, 0.0),
        (-0.8, 0.6624, 0.874, 0.0, -0.0184, 0.0),
        (-0.2, 0.11, 0.31, 0.22, 0.0, -18.0),
        (-0.2, 0.16, 0.41, -0.22, 0.0, 18.0),
        (0.1, 0.21, 0.25, 0.0, 0.35, 0.0),
        (0.1, 0.046, 0.046, 0.0, 0.1, 0.0),
    ]
    y, x = np.mgrid[-1 : 1 : n * 1j, -1 : 1 : n * 1j]
    img = np.zeros((n, n), dtype=np.float32)
    for v, a, b, x0, y0, phi in ellipses:
        p = np.deg2rad(phi)
        xr = (x - x0) * np.cos(p) + (y - y0) * np.sin(p)
        yr = -(x - x0) * np.sin(p) + (y - y0) * np.cos(p)
        img[(xr / a) ** 2 + (yr / b) ** 2 <= 1.0] += v
    return np.clip(img, 0.0, None)


def main():
    N = int(os.environ.get("TOMOBAR_EXAMPLE_N", 256))
    angles = np.linspace(0, np.pi, int(1.5 * N), endpoint=False)
    phantom = shepp_logan(N)

    # --- direct reconstruction (RecToolsDIR surface) ----------------------
    rt_dir = RecToolsDIR(
        DetectorsDimH=N,
        DetectorsDimH_pad=0,
        DetectorsDimV=None,  # 2D
        CenterRotOffset=0.0,
        AnglesVec=angles,
        ObjSize=N,
    )
    sino = np.array(rt_dir.FORWPROJ(phantom))
    sino += np.random.default_rng(0).normal(0, 0.5, sino.shape).astype(
        np.float32
    )
    fbp = np.asarray(rt_dir.FBP(sino, filter_type="shepp-logan"))

    # --- iterative reconstruction (three-dict API) ------------------------
    rt_it = RecToolsIRCuPy(
        DetectorsDimH=N,
        DetectorsDimH_pad=0,
        DetectorsDimV=None,  # 2D
        CenterRotOffset=0.0,
        AnglesVec=angles,
        ObjSize=N,
        OS_number=8,
    )
    rec = np.asarray(
        rt_it.FISTA(
            {"projection_data": sino},
            {"iterations": 15, "nonnegativity": True},
            {"method": "PD_TV", "regul_param": 3e-4, "iterations": 40},
        )
    )

    def rel_rmse(a, b):
        return float(
            np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2))
        )

    print(f"FBP (shepp-logan filter) rel-RMSE: {rel_rmse(fbp, phantom):.4f}")
    print(f"FISTA-OS8-TV             rel-RMSE: {rel_rmse(rec, phantom):.4f}")
    assert rel_rmse(rec, phantom) < rel_rmse(fbp, phantom), (
        "iterative recon should beat FBP on noisy data"
    )
    print("quick-start OK")


if __name__ == "__main__":
    main()
