"""Direct reconstruction classes (FBP, Fourier methods).

API-compatible equivalents of the reference's ``RecToolsDIR``
(``tomobar/methodsDIR.py:18``) and ``RecToolsDIRCuPy``
(``tomobar/methodsDIR_CuPy.py:26``).  On an accelerator there is no host/device class
split: both classes run the same jitted XLA pipelines; ``RecToolsDIR``
returns numpy arrays (host semantics) while ``RecToolsDIRCuPy`` returns
device arrays (device semantics), so reference user code ports unchanged.
"""

from __future__ import annotations

from typing import Literal, Union

import numpy as np
import jax
import jax.numpy as jnp

from tomobar_tpu.geometry import Geometry
from tomobar_tpu.ops.projector import Projector
from tomobar_tpu.ops.filters import (
    filter_sino_classic,
    filter_sino_sinc,
    sinc_filter_half,
)
from tomobar_tpu.utils.tools import (
    apply_horiz_detector_padding,
    check_kwargs,
    data_dims_swapper,
)

__all__ = ["RecToolsDIR", "RecToolsDIRTPU"]


class RecToolsDIR:
    """Direct reconstruction: forward/back projection, FBP, Fourier recon.

    Args mirror the reference constructor (``methodsDIR.py:32-69``):
        DetectorsDimH: horizontal detector dimension.
        DetectorsDimH_pad: symmetric horizontal detector padding.
        DetectorsDimV: vertical detector dimension (0/None for 2D).
        CenterRotOffset: CoR offset scalar or per-angle vector.
        AnglesVec: projection angles in radians.
        ObjSize: reconstructed slice size.
        device_projector: accepted for API compatibility (ignored: XLA
            places computation on the available accelerator).
    """

    #: whether public methods return numpy (host) or jax (device) arrays
    _return_numpy = True

    def __init__(
        self,
        DetectorsDimH,
        DetectorsDimH_pad,
        DetectorsDimV,
        CenterRotOffset,
        AnglesVec,
        ObjSize,
        projector: Literal["fourier", "astra"] = "astra",
        device_projector="gpu",
    ):
        del projector, device_projector
        if CenterRotOffset is None:
            CenterRotOffset = 0.0
        self.geom = Geometry(
            detectors_x=int(DetectorsDimH),
            detectors_y=None if not DetectorsDimV else int(DetectorsDimV),
            angles=np.asarray(AnglesVec),
            center_rot_offset=CenterRotOffset,
            recon_size=int(ObjSize),
            detectors_x_pad=int(DetectorsDimH_pad),
        )
        self.geom_detY = (
            self.geom.is_2d is False
        )  # 3D when vertical detector present
        self.detectors_x_pad = self.geom.detectors_x_pad
        self.angles_vec = self.geom.angles
        self.centre_of_rotation = CenterRotOffset
        self.recon_size = self.geom.recon_size
        # when padding is requested the recon grid is enlarged; the public
        # recon size stays ObjSize (reference methodsIR_CuPy.py:72-79 applies
        # this in the IR class; DIR keeps the grid at ObjSize)
        self.Atools = Projector(self.geom)
        self.geom_label = "2D" if self.geom.is_2d else "3D"

    # -- helpers -------------------------------------------------------------

    def _maybe_np(self, arr):
        if self._return_numpy:
            return np.asarray(arr)
        return arr

    def _fp_input(self, data):
        return jnp.asarray(data, dtype=jnp.float32)

    # -- public API ----------------------------------------------------------

    def FORWPROJ(self, data, **kwargs):
        """Forward projection of a 2D/3D object.

        Output canonical order: ["angles", "detX"] (2D) or
        ["detY", "angles", "detX"] (3D); reorderable via
        ``data_axes_labels_order``.
        """
        projected = self.Atools.fp(self._fp_input(data))
        order = kwargs.get("data_axes_labels_order")
        if order is not None:
            labels = ["angles", "detX"] if projected.ndim == 2 else [
                "detY",
                "angles",
                "detX",
            ]
            projected = data_dims_swapper(projected, order, labels)
        return self._maybe_np(projected)

    def BACKPROJ(self, data, **kwargs):
        """Back-projection of 2D/3D projection data."""
        data = self._fp_input(data)
        order = kwargs.get("data_axes_labels_order")
        if order is not None:
            labels = ["angles", "detX"] if data.ndim == 2 else [
                "detY",
                "angles",
                "detX",
            ]
            data = data_dims_swapper(data, order, labels)
        data = apply_horiz_detector_padding(data, self.detectors_x_pad)
        return self._maybe_np(self.Atools.bp(data))

    def FBP(self, data, **kwargs):
        """Filtered back-projection with the custom sinc filter or a classic
        filter bank.

        2D input: ["angles", "detX"].  3D input canonical order follows the
        reference device class: ["angles", "detY", "detX"]
        (``methodsDIR_CuPy.py:123``) for this method only.

        ``filter_type`` selects a classic FBP filter (ram-lak, shepp-logan,
        cosine, hamming, hann, tukey, gaussian, blackman, kaiser, ...) with
        optional ``filter_parameter`` / ``filter_d`` — the equivalent of the
        ASTRA-native filter configuration the reference exposes on its host
        2D FBP path (``astra_base.py:351-356``).  When omitted, the custom
        sinc filter is used (reference default).
        """
        data = self._fp_input(data)
        cutoff = kwargs.get("cutoff_freq", None)
        filter_type = kwargs.get("filter_type", None)
        filter_parameter = kwargs.get("filter_parameter", None)
        filter_d = kwargs.get("filter_d", 1.0)
        order = kwargs.get("data_axes_labels_order")

        def _filter(sino):
            if filter_type is not None:
                return filter_sino_classic(
                    sino, filter_type, filter_parameter, filter_d
                )
            return filter_sino_sinc(sino, _cutoff)

        if data.ndim == 2:
            if order is not None:
                data = data_dims_swapper(data, order, ["angles", "detX"])
            # host 2D path fixed a=1.1 (methodsDIR.py:297)
            _cutoff = 1.1 if cutoff is None else cutoff
            data = apply_horiz_detector_padding(data, self.detectors_x_pad)
            rec = self.Atools.bp(_filter(data))
        else:
            if order is not None:
                data = data_dims_swapper(data, order, ["angles", "detY", "detX"])
            # device default (methodsDIR_CuPy.py:133)
            _cutoff = 0.35 if cutoff is None else cutoff
            # to canonical (detY, angles, detX)
            data = jnp.swapaxes(data, 0, 1)
            if data.shape[1] != self.geom.n_angles:
                raise ValueError(
                    f"FBP expects 3D data as [angles, detY, detX] (got "
                    f"{tuple(jnp.swapaxes(data, 0, 1).shape)} for "
                    f"{self.geom.n_angles} angles; pass "
                    f"data_axes_labels_order to reorder)"
                )
            data = apply_horiz_detector_padding(data, self.detectors_x_pad)
            rec = self.Atools.bp(_filter(data))
        rec = check_kwargs(
            rec, recon_mask_radius=kwargs.get("recon_mask_radius"), cupyrun=False
        )
        return self._maybe_np(rec)

    def FOURIER(self, data, **kwargs):
        """2D Fourier-slice-theorem reconstruction on the device.

        The reference implements this with host scipy ``griddata``
        interpolation of the polar Fourier samples (``methodsDIR.py:177-254``,
        even-detX and integer-CoR only).  Here it is the same device USFFT
        pipeline as :meth:`FOURIER_INV` run *without* a filter: 1-D FFT per
        projection -> exact Gaussian-kernel gridding onto the Cartesian
        frequency plane -> 2-D inverse FFT.  Lifts the reference's detX
        parity and integer-CoR restrictions; ``method`` (the scipy
        interpolant name) is accepted for API compatibility and ignored.
        Like the reference's, the result is the *unfiltered* Fourier-slice
        image (low-frequency weighted); use FBP/FOURIER_INV for a
        quantitative reconstruction.
        """
        from tomobar_tpu.ops.usfft import fourier_inv

        if np.ndim(data) == 3:
            raise ValueError(
                "Fourier method is currently for 2D data only, use FBP if 3D "
                "reconstruction needed"
            )
        method = kwargs.pop("method", "linear")
        if method not in ["linear", "nearest", "cubic"]:
            raise ValueError(
                "For griddata interpolation module choose nearest, linear or cubic"
            )
        order = kwargs.pop("data_axes_labels_order", None)
        data = jnp.asarray(data, dtype=jnp.float32)
        if order is not None:
            data = data_dims_swapper(data, order, ["angles", "detX"])

        kwargs["filter_type"] = "none"
        rec = fourier_inv(self, data[None], **kwargs)
        return self._maybe_np(rec[0])


class RecToolsDIRTPU(RecToolsDIR):
    """Device-resident direct reconstruction (returns JAX arrays).

    Equivalent of the reference's ``RecToolsDIRCuPy``
    (``methodsDIR_CuPy.py:26``); adds ``FOURIER_INV``.
    """

    _return_numpy = False

    def __init__(
        self,
        DetectorsDimH,
        DetectorsDimH_pad,
        DetectorsDimV,
        CenterRotOffset,
        AnglesVec,
        ObjSize,
        projector: Literal["fourier", "astra"] = "astra",
        device_projector=0,
    ):
        super().__init__(
            DetectorsDimH,
            DetectorsDimH_pad,
            DetectorsDimV,
            CenterRotOffset,
            AnglesVec,
            ObjSize,
            projector,
            device_projector,
        )

    def FOURIER_INV(self, data, **kwargs):
        """Fourier direct inversion on unequally-spaced grids (USFFT /
        log-polar family).  See :mod:`tomobar_tpu.ops.usfft`.

        Shape-mode dry run: inside a ``with DeviceMemStack():`` block,
        ``data`` may be a shape tuple instead of an array — the pipeline is
        compiled (never executed), XLA's memory analysis is recorded on the
        stack's high-water mark, and the output shape is returned, matching
        the reference's estimator-only mode (``methodsDIR_CuPy.py:253-258``,
        return at ``:437-441``) used by HTTomo for slab planning.
        """
        from tomobar_tpu.ops.usfft import fourier_inv
        from tomobar_tpu.utils.memest import (
            DeviceMemStack,
            estimate_fourier_inv_memory,
        )

        mem_stack = DeviceMemStack.instance()
        if mem_stack is not None and isinstance(data, (tuple, list)):
            shape = tuple(int(s) for s in data)
            est = estimate_fourier_inv_memory(self, shape, **kwargs)
            mem_stack.malloc(est["total"])
            mem_stack.free(est["total"])
            return est["output_shape"]
        return fourier_inv(self, data, **kwargs)
