"""Iterative reconstruction class with the three-dictionary API.

API-compatible equivalent of the reference's ``RecToolsIRCuPy``
(``tomobar/methodsIR_CuPy.py:36``): device-resident Landweber / SIRT /
CGLS / power method / FISTA / ADMM / OSEM with LS / PWLS / KL fidelities,
ordered subsets, warm start, detector padding (with recon-grid enlargement
and final crop) and circular masking.  Solver bodies live in
:mod:`tomobar_tpu.solvers.core`.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Union

import numpy as np
import jax.numpy as jnp

from tomobar_tpu.geometry import Geometry
from tomobar_tpu.ops.projector import Projector
from tomobar_tpu.regularisers import prox_regul
from tomobar_tpu.solvers import core as solvers
from tomobar_tpu.utils.dicts import dicts_check
from tomobar_tpu.utils.tools import (
    apply_horiz_detector_padding,
    check_kwargs,
    perform_recon_crop,
)

__all__ = ["RecToolsIRTPU"]

# Sentinel for values _step_key cannot safely hash (see _step_key docstring).
_UNHASHABLE = object()


class RecToolsIRTPU:
    """Iterative reconstruction tools (device-resident, jit-compiled).

    Args mirror the reference constructor (``methodsIR_CuPy.py:53-95``):
        DetectorsDimH: horizontal detector dimension.
        DetectorsDimH_pad: symmetric horizontal detector padding; when > 0,
            the reconstruction grid is enlarged to DetectorsDimH + 2*pad and
            the result cropped back to ObjSize.
        DetectorsDimV: vertical detector dimension ('None'/0 for 2D).
        CenterRotOffset: CoR offset scalar or per-angle vector.
        AnglesVec: projection angles in radians.
        ObjSize: reconstructed slice size.
        device_projector: accepted for API compatibility (ignored).
        OS_number: number of ordered subsets (None for non-OS).
    """

    def __init__(
        self,
        DetectorsDimH: int,
        DetectorsDimH_pad: int,
        DetectorsDimV: Union[int, None],
        CenterRotOffset: Union[float, np.ndarray],
        AnglesVec: np.ndarray,
        ObjSize: int,
        device_projector: int = 0,
        OS_number: Optional[int] = None,
    ):
        del device_projector
        self.OS_number = OS_number if OS_number is not None else 1

        if DetectorsDimH_pad == 0:
            self.objsize_user_given = None
        else:
            self.objsize_user_given = ObjSize
        if DetectorsDimH_pad > 0:
            ObjSize = DetectorsDimH + 2 * DetectorsDimH_pad
        if DetectorsDimV == 0 or DetectorsDimV is None:
            DetectorsDimV = 1
        if CenterRotOffset is None:
            CenterRotOffset = 0.0

        self.geom = "3D"
        self._geometry = Geometry(
            detectors_x=int(DetectorsDimH),
            detectors_y=int(DetectorsDimV),
            angles=np.asarray(AnglesVec),
            center_rot_offset=CenterRotOffset,
            recon_size=int(ObjSize),
            detectors_x_pad=int(DetectorsDimH_pad),
            os_number=self.OS_number,
        )
        self.Atools = Projector(self._geometry)
        self.data_fidelity = "LS"
        self.nonneg_regul = 0
        # compiled verbose-mode outer steps, keyed by every non-array value
        # the step closes over (see solvers.core._host_outer_loop) — repeat
        # verbose FISTA/ADMM calls on the same instance reuse the compile
        self._verbose_step_cache: dict = {}
        # Lipschitz constant cache: L = ||A^T A|| depends only on the
        # operator (geometry + OS; the power method's PWLS weights are ones
        # in the reference too, methodsIR_CuPy.py:331-332, so L is
        # fidelity-independent).  The reference recomputes the 15-iteration
        # power method on EVERY solver call without a user-supplied
        # lipschitz_const (methodsIR_CuPy.py:371-372), which costs 15 FP+BP
        # pairs per call; caching per instance saves that for parameter
        # sweeps and the warm-start production pattern.
        self._lipschitz_cache: Optional[float] = None

    # ------------------------------------------------------------------ API

    @property
    def vol_shape(self):
        g = self._geometry
        return (g.detectors_y, g.recon_size, g.recon_size)

    def _Ax(self, x, sub_ind: int = 1, os: bool = False):
        return self.Atools.fp_sub(x, sub_ind) if os else self.Atools.fp(x)

    def _Atb(self, b, sub_ind: int = 1, os: bool = False):
        return self.Atools.bp_sub(b, sub_ind) if os else self.Atools.bp(b)

    # -------------------------------------------------------------- helpers

    def _prep_data(self, _data_, _algorithm_, _regularisation_, method_run):
        d, a, r = dicts_check(self, _data_, _algorithm_, _regularisation_, method_run)
        d["projection_data"] = apply_horiz_detector_padding(
            jnp.asarray(d["projection_data"], dtype=jnp.float32),
            self._geometry.detectors_x_pad,
        )
        return d, a, r

    def _finalise(self, x, _algorithm_):
        if self.objsize_user_given is not None:
            return perform_recon_crop(x, self.objsize_user_given)
        return check_kwargs(
            x, recon_mask_radius=_algorithm_["recon_mask_radius"], cupyrun=True
        )

    def _common_init(self, _data_, _algorithm_, _regularisation_, method_run):
        """Shared init: dicts check, padding, Lipschitz constant, warm start,
        PWLS weights (``methodsIR_CuPy.py:356-399``)."""
        d, a, r = self._prep_data(_data_, _algorithm_, _regularisation_, method_run)
        if a.get("lipschitz_const") is None:
            if self._lipschitz_cache is None:
                self._lipschitz_cache = self.powermethod(d)
            a["lipschitz_const"] = self._lipschitz_cache
        rec_dim = self.vol_shape
        if a["initialise"] is not None:
            if tuple(a["initialise"].shape) == rec_dim:
                x0 = jnp.asarray(a["initialise"], dtype=jnp.float32)
            else:
                print(
                    f"Provided initialisation (array) has incorrect dimensions, "
                    f"the correct dims are {rec_dim}. Zero initialisation is used."
                )
                x0 = jnp.zeros(rec_dim, dtype=jnp.float32)
        elif method_run == "OSEM":
            x0 = jnp.ones(rec_dim, dtype=jnp.float32)
        else:
            x0 = jnp.zeros(rec_dim, dtype=jnp.float32)
        return d, a, r, x0

    @staticmethod
    def _fid_kwargs(d: dict) -> dict:
        """Robust-fidelity parameters from the data dict (legacy RecToolsIR
        surface: beta_SWLS, huber_threshold, studentst_threshold)."""
        return {
            k: d[k]
            for k in ("beta_SWLS", "huber_threshold", "studentst_threshold")
            if d.get(k) is not None
        }

    def _regul_fn(self, _regularisation_):
        if _regularisation_.get("method") is None:
            return None
        return lambda x: prox_regul(self, x, _regularisation_)

    def _step_key(self, method: str, d: dict, a: dict, r):
        """Hashable fingerprint of everything a verbose-mode outer step
        closes over besides the sinogram/weights: solver scalars, fidelity
        parameters and the regularisation dict (nonneg_regul rides in via
        a).

        Every closed-over value must contribute to the key: numpy scalars
        are coerced through float()/int(), array-valued regularisation
        entries (e.g. NLTV's H_i/H_j/Weights, baked into the jitted step as
        closure constants) contribute a content digest, and any value of an
        unrecognised type makes the whole key ``None`` — which disables
        caching (per-call jit) rather than risking a stale compiled step.
        """

        def coerce(v):
            if v is None or isinstance(v, (bool, int, float, str)):
                return v
            if isinstance(v, np.bool_):
                return bool(v)
            if isinstance(v, np.integer):
                return int(v)
            if isinstance(v, np.floating):
                return float(v)
            if isinstance(v, (np.ndarray, jnp.ndarray)):
                arr = np.asarray(v)
                return ("ndarray", arr.shape, str(arr.dtype),
                        hash(arr.tobytes()))
            if isinstance(v, (tuple, list)):
                inner = tuple(coerce(x) for x in v)
                if any(x is _UNHASHABLE for x in inner):
                    return _UNHASHABLE
                return inner
            return _UNHASHABLE

        def items(dd):
            if not dd:
                return ()
            out = []
            for k, v in sorted(dd.items()):
                cv = coerce(v)
                if cv is _UNHASHABLE:
                    return _UNHASHABLE
                out.append((k, cv))
            return tuple(out)

        parts = (
            items({k: d.get(k) for k in (
                "beta_SWLS", "huber_threshold", "studentst_threshold")}),
            items({k: a.get(k) for k in (
                "lipschitz_const", "nonnegativity", "ADMM_rho_const",
                "ADMM_relax_par")}),
            items(r),
        )
        if any(p is _UNHASHABLE for p in parts):
            return None
        return (method, d.get("data_fidelity")) + parts

    # -------------------------------------------------------------- solvers

    def powermethod(self, _data_: dict) -> float:
        """Lipschitz constant via power iterations
        (``methodsIR_CuPy.py:311-354``).  A direct call always recomputes
        (reference parity) and refreshes the per-instance cache consumed by
        the solvers (see ``_lipschitz_cache`` in ``__init__``)."""
        if _data_.get("data_fidelity") is None:
            _data_["data_fidelity"] = "LS"
        val = solvers.power_method(
            self.Atools,
            self.vol_shape,
            iterations=15,
            use_pwls=_data_["data_fidelity"] == "PWLS",
        )
        self._lipschitz_cache = val
        return val

    def Landweber(self, _data_: dict, _algorithm_: Union[dict, None] = None):
        d, a, _ = self._prep_data(_data_, _algorithm_, None, "Landweber")
        x = solvers.landweber(
            self.Atools,
            d["projection_data"],
            iterations=a["iterations"],
            tau_step=a["tau_step_lanweber"],
            nonnegativity=a["nonnegativity"],
        )
        return self._finalise(x, a)

    def SIRT(self, _data_: dict, _algorithm_: Union[dict, None] = None):
        d, a, _ = self._prep_data(_data_, _algorithm_, None, "SIRT")
        x = solvers.sirt(
            self.Atools,
            d["projection_data"],
            iterations=a["iterations"],
            nonnegativity=a["nonnegativity"],
        )
        return self._finalise(x, a)

    def CGLS(self, _data_: dict, _algorithm_: Union[dict, None] = None):
        d, a, _ = self._prep_data(_data_, _algorithm_, None, "CGLS")
        x = solvers.cgls(
            self.Atools,
            d["projection_data"],
            iterations=a["iterations"],
            nonnegativity=a["nonnegativity"],
        )
        return self._finalise(x, a)

    def FISTA(
        self,
        _data_: dict,
        _algorithm_: Union[dict, None] = None,
        _regularisation_: Union[dict, None] = None,
    ):
        d, a, r, x0 = self._common_init(_data_, _algorithm_, _regularisation_, "FISTA")
        x = solvers.fista(
            self.Atools,
            d["projection_data"],
            iterations=a["iterations"],
            lipschitz_const=a["lipschitz_const"],
            nonnegativity=a["nonnegativity"],
            fidelity=d["data_fidelity"],
            regul_fn=self._regul_fn(r),
            x0=x0,
            fid_kwargs=self._fid_kwargs(d),
            tolerance=a.get("tolerance", 0.0),
            verbose=bool(a.get("verbose", False)),
            step_cache=self._verbose_step_cache,
            step_key=self._step_key("FISTA", d, a, r),
        )
        return self._finalise(x, a)

    def ADMM(
        self,
        _data_: dict,
        _algorithm_: Union[dict, None] = None,
        _regularisation_: Union[dict, None] = None,
    ):
        d, a, r, x0 = self._common_init(_data_, _algorithm_, _regularisation_, "ADMM")
        # regul_param scaled by 1/rho (methodsIR_CuPy.py:526-528)
        r = dict(r)
        if r.get("regul_param") is not None:
            r["regul_param"] = r["regul_param"] / a["ADMM_rho_const"]
        x = solvers.admm(
            self.Atools,
            d["projection_data"],
            iterations=a["iterations"],
            lipschitz_const=a["lipschitz_const"],
            rho_const=a["ADMM_rho_const"],
            relax_par=a["ADMM_relax_par"],
            nonnegativity=a["nonnegativity"],
            fidelity=d["data_fidelity"],
            regul_fn=self._regul_fn(r),
            x0=x0,
            fid_kwargs=self._fid_kwargs(d),
            tolerance=a.get("tolerance", 0.0),
            verbose=bool(a.get("verbose", False)),
            step_cache=self._verbose_step_cache,
            step_key=self._step_key("ADMM", d, a, r),
        )
        return self._finalise(x, a)

    def OSEM(
        self,
        _data_: dict,
        _algorithm_: Union[dict, None] = None,
        _regularisation_: Union[dict, None] = None,
    ):
        d, a, r, x0 = self._common_init(_data_, _algorithm_, _regularisation_, "OSEM")
        x = solvers.osem(
            self.Atools,
            d["projection_data"],
            iterations=a["iterations"],
            regul_fn=self._regul_fn(r),
            x0=x0,
            normalisation_mode=a.get("osem_normalisation", "reference"),
        )
        return self._finalise(x, a)
