"""Pre/post-processing support tools.

Device-resident equivalents of ``tomobar/supp/suppTools.py`` and the axis-label
machinery of ``tomobar/supp/funcs.py:84-206``.  Functions accept numpy or
JAX arrays and return the same family (numpy in -> numpy out) so they can be
used both host-side (data prep) and device-side (inside pipelines).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import jax.numpy as jnp

__all__ = [
    "normaliser",
    "autocropper",
    "apply_circular_mask",
    "perform_recon_crop",
    "apply_horiz_detector_padding",
    "check_kwargs",
    "swap_data_axes_to_accepted",
    "data_dims_swapper",
]


def _xp(data):
    return np if isinstance(data, np.ndarray) else jnp


# ---------------------------------------------------------------------------
# axis-label ordering (reference: supp/funcs.py:84-171)
# ---------------------------------------------------------------------------


def _get_swap_tuple(data_axis_labels, labels_order):
    for in_l1, str_1 in enumerate(labels_order):
        for in_l2, str_2 in enumerate(data_axis_labels):
            if str_1 == str_2 and in_l1 != in_l2:
                return (in_l1, in_l2)
    return None


def swap_data_axes_to_accepted(
    data_axes_labels: Sequence[str], required_labels_order: Sequence[str]
) -> List[Optional[Tuple[int, int]]]:
    """Compute the (up to two) axis swaps needed to reach the required order."""
    if len(data_axes_labels) != len(required_labels_order):
        raise ValueError(
            "The mismatch in length between provided labels and data dimensions."
        )
    for lbl in data_axes_labels:
        if lbl not in required_labels_order:
            raise ValueError(
                f'Axis title "{lbl}" is not valid, please use one of these: '
                '"angles", "detX", or "detY"'
            )
    labels = list(data_axes_labels)
    swap1 = _get_swap_tuple(labels, required_labels_order)
    swap2 = None
    if swap1 is not None:
        labels[swap1[0]], labels[swap1[1]] = labels[swap1[1]], labels[swap1[0]]
        swap2 = _get_swap_tuple(labels, required_labels_order)
    return [swap1, swap2]


def data_dims_swapper(data, data_axes_labels_order, required_labels_order):
    """Swap array axes (or a shape tuple) into the required label order."""
    swaps = swap_data_axes_to_accepted(data_axes_labels_order, required_labels_order)
    for swap in swaps:
        if swap is None:
            continue
        if isinstance(data, tuple):
            items = list(data)
            items[swap[0]], items[swap[1]] = items[swap[1]], items[swap[0]]
            data = tuple(items)
        else:
            data = _xp(data).swapaxes(data, swap[0], swap[1])
    return data


# ---------------------------------------------------------------------------
# normalisation (reference: suppTools.py:187-264)
# ---------------------------------------------------------------------------


_FIELD_REDUCERS = {"mean": np.mean, "median": np.median}


def normaliser(
    data: np.ndarray,
    flats: np.ndarray,
    darks: Optional[np.ndarray],
    log: bool = True,
    method: str = "mean",
    axis: int = 0,
    **kwargs,
) -> np.ndarray:
    """Flat/dark-field normalisation with optional -log transform.

    Computes ``(data - dark) / (flat - dark)`` after reducing the flat/dark
    stacks along ``axis`` ("mean" or "median"); the "dynamic" PCA-based
    eigen-flat-field method lives in :mod:`tomobar_tpu.utils.dffc`.  Guard
    semantics match the reference (``suppTools.py:187-264``) so golden
    values carry over: non-positive denominators and negative numerators
    are both replaced by 1.0 before the division, and the -log transform
    only touches strictly positive ratios (negatives are zeroed).
    """
    if np.ndim(data) != 3:
        raise NameError("Normalisation is implemented for 3d data input")
    if darks is None:
        darks = np.zeros(np.shape(flats), dtype="float32")

    if method == "dynamic":
        from tomobar_tpu.utils.dffc import (
            dynamic_flatfield_correction,
            wavelet_denoise,
        )

        # dyn_denoiser: None/'gaussian' (default blur), 'wavelet' (Haar
        # soft-threshold, edge-preserving — the built-in stand-in for the
        # reference's optional BM3D), or any callable img -> img
        denoiser = kwargs.get("dyn_denoiser")
        if denoiser == "wavelet":
            denoiser = wavelet_denoise
        elif denoiser in (None, "gaussian"):
            denoiser = None
        elif not callable(denoiser):
            raise NameError(
                "dyn_denoiser should be 'gaussian', 'wavelet' or a callable"
            )
        ratio = dynamic_flatfield_correction(
            data,
            flats,
            darks,
            downsample=kwargs.get("dyn_downsample", 2),
            n_pa_repetitions=kwargs.get("dyn_iterations", 10),
            denoise_fn=denoiser,
        )[0]
    else:
        reduce = _FIELD_REDUCERS.get("mean" if method is None else method)
        if reduce is None:
            raise NameError(
                "Please choose the normalisation method out of: mean, "
                "median or dynamic"
            )
        flat_field = reduce(flats, axis)
        dark_field = reduce(darks, axis)

        if axis == 0 and np.shape(data)[-np.ndim(flat_field):] == np.shape(
            flat_field
        ):
            # fused multicore C++ path (one pass, no temporaries); falls
            # back to numpy when the native library is unavailable
            from tomobar_tpu import native

            fused = native.normalise_native(data, flat_field, dark_field, log)
            if fused is not None:
                return fused

        if axis == 1:
            flat_field = flat_field[:, None, :]
            dark_field = dark_field[:, None, :]
        denom = flat_field - dark_field
        denom[denom <= 0.0] = 1.0
        numer = data - dark_field
        numer[numer < 0.0] = 1.0
        ratio = numer / denom

    if log:
        positive = ratio > 0.0
        ratio[positive] = -np.log(ratio[positive])
        ratio[ratio < 0.0] = 0.0
    return ratio


# ---------------------------------------------------------------------------
# auto-cropping (reference: suppTools.py:267-361)
# ---------------------------------------------------------------------------


def _first_last_above(profiles: np.ndarray, thr: np.ndarray):
    """Per row of ``profiles`` (n, m): first and last index where the
    profile exceeds its threshold; (0, m) when nothing does."""
    above = profiles > thr[:, None]
    any_above = above.any(axis=1)
    m = profiles.shape[1]
    first = np.where(any_above, above.argmax(axis=1), 0)
    last = np.where(any_above, m - above[:, ::-1].argmax(axis=1), m)
    return first, last


def autocropper(data: np.ndarray, addbox: int, backgr_pix1: int) -> np.ndarray:
    """Crop 3D projection data [Projections, detY, detX] to the union
    bounding box of the imaged object.

    Same contract as the reference (``suppTools.py:267-361``): the
    background level is estimated from two object-free strips of width
    ``backgr_pix1`` at the left/right detector edges around the vertical
    midline, and the crop box is padded by ``addbox`` pixels.  The bound
    search itself is our own vectorised design: per projection the
    row/column mean profiles are thresholded at the combined strip mean and
    the first/last crossings taken (the reference instead walks outward
    from the profile peak, which can cut off secondary objects)."""
    data = np.asarray(data)
    n_proj, det_v, det_h = data.shape
    strip_v = int(2.5 * backgr_pix1)
    mid = det_v // 2
    lo, hi = max(mid - strip_v, 0), min(mid + strip_v, det_v)

    bg = (
        data[:, lo:hi, :backgr_pix1].mean(axis=(1, 2))
        + data[:, lo:hi, det_h - 1 - backgr_pix1 : det_h - 1].mean(axis=(1, 2))
    )
    row_prof = data.mean(axis=2)  # (n_proj, det_v)
    col_prof = data.mean(axis=1)  # (n_proj, det_h)

    top, bottom = _first_last_above(row_prof, bg)
    left, right = _first_last_above(col_prof, bg)

    up = max(int(top.min()) - addbox, 0)
    down = min(int(bottom.max()) + addbox, det_v)
    lft = max(int(left.min()) - addbox, 0)
    rgt = min(int(right.max()) + addbox, det_h)
    return data[:, up:down, lft:rgt]


# ---------------------------------------------------------------------------
# masking / cropping / padding (reference: suppTools.py:364-459)
# ---------------------------------------------------------------------------


def apply_circular_mask(data, recon_mask_radius: float, cupyrun: bool = False):
    """Zero values outside a circular mask.

    Radius semantics mirror the reference (``suppTools.py:387-394``):
    values <= 1 shrink the mask, values > 1 grow it (so e.g. 2.0 is a
    de-facto no-op used by demos to disable cropping).
    """
    del cupyrun  # kept for API compatibility; array family is auto-detected
    xp = _xp(data)
    axis = 2 if data.ndim == 3 else 1
    recon_size = data.shape[axis]
    half = recon_size // 2
    Y, X = np.ogrid[:recon_size, :recon_size]
    dist = np.sqrt((X - half) ** 2 + (Y - half) ** 2)
    if recon_mask_radius <= 1.0:
        mask = dist <= half - abs(half - half / recon_mask_radius)
    else:
        mask = dist <= half + abs(half - half / recon_mask_radius)
    mask = xp.asarray(mask, dtype=data.dtype)
    return data * mask


def perform_recon_crop(data, cropped_size: int):
    """Centre-crop a (padded) reconstruction back to ``cropped_size``."""
    axis = 2 if data.ndim == 3 else 0
    original = data.shape[axis]
    start = (original - cropped_size) // 2
    stop = cropped_size + start
    if data.ndim == 3:
        return data[:, start:stop, start:stop]
    return data[start:stop, start:stop]


def apply_horiz_detector_padding(data, detector_width_pad: int, cupyrun: bool = False):
    """Edge-pad detX symmetrically; 3D data is [detY, angles, detX], 2D is
    [angles, detX] (reference ``suppTools.py:425-459``)."""
    del cupyrun
    if detector_width_pad <= 0:
        return data
    xp = _xp(data)
    if data.ndim == 2:
        pads = ((0, 0), (detector_width_pad, detector_width_pad))
    else:
        pads = ((0, 0), (0, 0), (detector_width_pad, detector_width_pad))
    return xp.pad(data, pads, mode="edge")


def check_kwargs(reconstruction, **kwargs):
    """Post-hoc application of optional kwargs (mask)."""
    for key, value in kwargs.items():
        if key == "recon_mask_radius" and value is not None:
            reconstruction = apply_circular_mask(
                reconstruction, value, kwargs.get("cupyrun", False)
            )
    return reconstruction
