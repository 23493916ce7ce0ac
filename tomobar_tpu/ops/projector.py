"""Parallel-beam Radon transform pair (FP / BP).

This module replaces the external ASTRA toolbox used by the reference
(``tomobar/astra_wrappers/astra_base.py``: ``parallel_vec``/``parallel3d_vec``
geometries executed through ``direct_FP3D``/``direct_BP3D``).  It is a
from-scratch JAX design, not a port:

* **Joseph's method, gather-only.**  The forward projector integrates each
  ray with one linear interpolation per crossed row (x-driven) or column
  (y-driven).  The backprojector is the *exact numerical adjoint* (same hat
  weights, gathered from the sinogram side), so ``<A x, y> == <x, A^T y>``
  holds to float precision — unlike ASTRA's only-approximately-adjoint
  ray-driven FP / voxel-driven BP pair (see SURVEY.md "hard parts").
  Exact adjointness is what the iterative solvers (power method, CGLS,
  FISTA) actually rely on.

* **Static-geometry specialisation.**  Angles and CoR are host numpy values;
  the angle set is partitioned into x-driven (|cos| >= |sin|) and y-driven
  groups at trace time, so there is no data-dependent control flow inside
  jit.

* **Two implementations of one operator, chosen by platform.**  The XLA
  gather-and-scan path below (``_fp_driven``/``_bp_driven``) is the
  reference and runs on CPUs; on NVIDIA GPUs the fused Pallas kernels of
  :mod:`tomobar_tpu.ops.projector_triton` run instead.  The choice is
  made by :func:`jax.lax.platform_dependent` when the program is lowered,
  so a function jitted onto either kind of device gets its own path;
  lowering for any other platform fails.  ``impl="xla"`` forces the
  reference on any platform (cross-checks on the GPU); ``impl="interpret"``
  runs the kernels in Pallas interpret mode (tests on the CPU).

* **Memory-bounded scans.**  The reference's row-sum (FP) and angle-sum
  (BP) are ``lax.scan`` loops over fixed-size blocks so peak memory is
  controlled independently of problem size.

Coordinate conventions are defined in :mod:`tomobar_tpu.geometry`.
A detector cell ``t`` at angle ``theta`` sees the line
``x cos(theta) + y sin(theta) = t - (det_x-1)/2 + cor``.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tomobar_tpu.geometry import Geometry
from tomobar_tpu.ops.projector_triton import joseph_bp, joseph_fp

__all__ = [
    "radon_fp",
    "radon_bp",
    "forward_project",
    "back_project",
    "fp_driven",
    "bp_driven",
    "Projector",
]


def _dispatch(impl: str, xla_fn, kernel_fn, *args):
    """The projector's one dispatch rule.  ``impl="auto"``: the kernel on
    NVIDIA GPUs, the XLA reference on CPUs, and lowering for any other
    platform raises.  ``"xla"``: the reference everywhere.
    ``"interpret"``: the kernel in interpret mode."""
    if impl == "auto":
        return jax.lax.platform_dependent(
            *args, cpu=xla_fn, cuda=partial(kernel_fn, interpret=False)
        )
    if impl == "xla":
        return xla_fn(*args)
    if impl == "interpret":
        return kernel_fn(*args, interpret=True)
    raise ValueError(
        f"impl must be 'auto', 'xla' or 'interpret', got {impl!r}"
    )


# Target size (elements) for gather intermediates inside the scan loops.
_BLOCK_BUDGET_ELEMS = 16 * 1024 * 1024


def _pick_block(total: int, other_elems: int) -> int:
    """Choose a block length so other_elems * block stays under budget."""
    if total <= 0:
        return 1
    blk = max(1, _BLOCK_BUDGET_ELEMS // max(1, other_elems))
    return int(min(total, blk))


def _pad_to_multiple(x: jnp.ndarray, axis: int, multiple: int) -> jnp.ndarray:
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, rem)
    return jnp.pad(x, pads)


# ---------------------------------------------------------------------------
# driven-axis kernels (x-driven shown; y-driven reuses them with axes swapped)
# ---------------------------------------------------------------------------


def _fp_driven(
    vol: jnp.ndarray,
    cos_v: np.ndarray,
    sin_v: np.ndarray,
    cor_v: np.ndarray,
    det_x: int,
    y_block: Optional[int] = None,
) -> jnp.ndarray:
    """Joseph x-driven FP for angles with |cos| >= |sin|.

    vol: (nz, ny, nx) float32. Returns (nz, n_ang, det_x).
    """
    nz, ny, nx = vol.shape
    n_ang = int(np.size(cos_v))
    dtype = vol.dtype

    cos_j = jnp.asarray(cos_v, dtype=dtype)
    sin_j = jnp.asarray(sin_v, dtype=dtype)
    cor_j = jnp.asarray(cor_v, dtype=dtype)
    inv_c = 1.0 / cos_j  # signed; |inv_c| >= 1 in this branch is false: |inv_c| <= sqrt(2)

    t = jnp.arange(det_x, dtype=dtype)
    # detector coordinate s_t = t - (det_x-1)/2 + cor  -> shape (A, T)
    s_t = t[None, :] - (det_x - 1) / 2.0 + cor_j[:, None]
    cx = (nx - 1) / 2.0

    if y_block is None:
        y_block = _pick_block(ny, nz * n_ang * det_x)
    volp = jnp.pad(vol, ((0, 0), (0, 0), (1, 1)))
    volp = _pad_to_multiple(volp, 1, y_block)
    ny_pad = volp.shape[1]
    n_blocks = ny_pad // y_block

    y_base = jnp.arange(y_block, dtype=dtype)

    def body(acc, yb):
        rows = jax.lax.dynamic_slice(
            volp, (0, yb * y_block, 0), (nz, y_block, nx + 2)
        )  # (nz, B, nx+2)
        yv = (yb * y_block + y_base) - (ny - 1) / 2.0  # (B,)
        # sample position along x for each (angle, row, det cell)
        pos = (
            s_t[:, None, :] - yv[None, :, None] * sin_j[:, None, None]
        ) * inv_c[:, None, None] + cx  # (A, B, T)
        i0 = jnp.floor(pos)
        frac = (pos - i0).astype(dtype)
        i0 = i0.astype(jnp.int32)
        idx0 = jnp.clip(i0 + 1, 0, nx + 1)
        idx1 = jnp.clip(i0 + 2, 0, nx + 1)
        g0 = jnp.take_along_axis(rows[:, None, :, :], idx0[None, :, :, :], axis=3)
        g1 = jnp.take_along_axis(rows[:, None, :, :], idx1[None, :, :, :], axis=3)
        contrib = (1.0 - frac)[None] * g0 + frac[None] * g1  # (nz, A, B, T)
        return acc + jnp.sum(contrib, axis=2), None

    acc0 = jnp.zeros((nz, n_ang, det_x), dtype=dtype)
    acc, _ = jax.lax.scan(body, acc0, jnp.arange(n_blocks))
    return acc * jnp.abs(inv_c)[None, :, None]


def _bp_driven(
    sino: jnp.ndarray,
    cos_v: np.ndarray,
    sin_v: np.ndarray,
    cor_v: np.ndarray,
    ny: int,
    nx: int,
    ang_block: Optional[int] = None,
) -> jnp.ndarray:
    """Exact adjoint of :func:`_fp_driven`.

    sino: (nz, A, det_x) float32. Returns (nz, ny, nx).
    """
    nz, n_ang, det_x = sino.shape
    dtype = sino.dtype

    cos_j = jnp.asarray(cos_v, dtype=dtype)
    sin_j = jnp.asarray(sin_v, dtype=dtype)
    cor_j = jnp.asarray(cor_v, dtype=dtype)
    abs_a = jnp.abs(1.0 / cos_j)  # |alpha| = 1/|cos|, in [1, sqrt(2)]

    if ang_block is None:
        ang_block = _pick_block(n_ang, nz * ny * nx)

    sinop = jnp.pad(sino, ((0, 0), (0, 0), (2, 2)))
    sinop = _pad_to_multiple(sinop, 1, ang_block)
    cosp = _pad_to_multiple(cos_j, 0, ang_block)
    # pad cos with 1.0 so 1/cos of padded angles is finite
    if cosp.shape[0] != n_ang:
        cosp = cosp.at[n_ang:].set(1.0)
    sinp = _pad_to_multiple(sin_j, 0, ang_block)
    corp = _pad_to_multiple(cor_j, 0, ang_block)
    n_blocks = sinop.shape[1] // ang_block

    xs = jnp.arange(nx, dtype=dtype) - (nx - 1) / 2.0
    ys = jnp.arange(ny, dtype=dtype) - (ny - 1) / 2.0

    def body(acc, ab):
        rows = jax.lax.dynamic_slice(
            sinop, (0, ab * ang_block, 0), (nz, ang_block, det_x + 4)
        )
        c = jax.lax.dynamic_slice(cosp, (ab * ang_block,), (ang_block,))
        s = jax.lax.dynamic_slice(sinp, (ab * ang_block,), (ang_block,))
        r = jax.lax.dynamic_slice(corp, (ab * ang_block,), (ang_block,))
        a_abs = jnp.abs(1.0 / c)
        # detector coordinate of each voxel centre: (Ab, ny, nx)
        t_c = (
            xs[None, None, :] * c[:, None, None]
            + ys[None, :, None] * s[:, None, None]
            + (det_x - 1) / 2.0
            - r[:, None, None]
        )
        tf = jnp.floor(t_c)
        part = jnp.zeros((nz, ny, nx), dtype=dtype)
        for d in (-1, 0, 1):
            tau = tf + d
            w = jnp.maximum(0.0, 1.0 - a_abs[:, None, None] * jnp.abs(tau - t_c))
            w = w * a_abs[:, None, None]
            idx = jnp.clip(tau.astype(jnp.int32) + 2, 0, det_x + 3)
            idx_flat = idx.reshape(ang_block, ny * nx)
            g = jnp.take_along_axis(rows, idx_flat[None, :, :], axis=2)
            g = g.reshape(nz, ang_block, ny, nx)
            part = part + jnp.sum(w[None] * g, axis=1)
        return acc + part, None

    acc0 = jnp.zeros((nz, ny, nx), dtype=dtype)
    acc, _ = jax.lax.scan(body, acc0, jnp.arange(n_blocks))
    return acc


# ---------------------------------------------------------------------------
# full-angle-set FP / BP with x/y-driven partition
# ---------------------------------------------------------------------------


def _angle_partition(angles: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    cos_v = np.cos(angles)
    sin_v = np.sin(angles)
    xdrive = np.abs(cos_v) >= np.abs(sin_v)
    return np.where(xdrive)[0], np.where(~xdrive)[0]



# ---------------------------------------------------------------------------
# vertical per-angle CoR: detector-centre z shift (reference vector geometry
# supp/funcs.py:45-65, d0 = [cor_h, 0, cor_v] -> detector row v sees volume
# height v + cor_v).  Applied as a per-angle linear-interp shift along detY
# around either projector backend; zero-fill outside keeps the FP/BP pair an
# exact adjoint (shift by +dz transposes to shift by -dz).
# ---------------------------------------------------------------------------


def _vshift_sino(sino: jnp.ndarray, dz: np.ndarray) -> jnp.ndarray:
    """out[v, a, t] = lin-interp of sino at (v + dz[a], a, t), zero outside."""
    nz = sino.shape[0]
    dzj = jnp.asarray(dz, dtype=sino.dtype)
    kf = jnp.floor(dzj)
    f = (dzj - kf)[None, :, None]
    i0 = jnp.arange(nz)[:, None] + kf.astype(jnp.int32)[None, :]  # (nz, A)
    valid0 = ((i0 >= 0) & (i0 < nz))[:, :, None]
    valid1 = ((i0 + 1 >= 0) & (i0 + 1 < nz))[:, :, None]
    g0 = jnp.take_along_axis(sino, jnp.clip(i0, 0, nz - 1)[:, :, None], axis=0)
    g1 = jnp.take_along_axis(
        sino, jnp.clip(i0 + 1, 0, nz - 1)[:, :, None], axis=0
    )
    return (1.0 - f) * jnp.where(valid0, g0, 0.0) + f * jnp.where(
        valid1, g1, 0.0
    )


def radon_fp(
    vol: jnp.ndarray, geom: Geometry, impl: str = "auto"
) -> jnp.ndarray:
    """Forward-project a volume.  vol (nz, n, n) or (n, n) -> sino
    (nz, n_angles, det_x_total) or (n_angles, det_x_total).  ``impl``: see
    :func:`_dispatch`."""
    squeeze = vol.ndim == 2
    vol = (vol[None] if squeeze else vol).astype(jnp.float32)
    sino = _dispatch(
        impl, partial(_fp_xla, geom=geom), partial(_fp_kernel, geom=geom), vol
    )
    dzv = geom.cor_vertical
    if dzv is not None and not squeeze and np.any(dzv):
        sino = _vshift_sino(sino, dzv)
    return sino[0] if squeeze else sino


def _fp_xla(vol: jnp.ndarray, geom: Geometry) -> jnp.ndarray:
    angles = geom.angles
    cor = geom.cor_horizontal
    det_x = geom.detectors_x_total
    cos_v, sin_v = np.cos(angles), np.sin(angles)
    idx_x, idx_y = _angle_partition(angles)

    nz = vol.shape[0]
    out = jnp.zeros((nz, angles.size, det_x), dtype=jnp.float32)
    if idx_x.size:
        px = _fp_driven(vol, cos_v[idx_x], sin_v[idx_x], cor[idx_x], det_x)
        out = out.at[:, idx_x, :].set(px)
    if idx_y.size:
        # y-driven: swap roles of x and y; line y*sin + x*cos = s
        py = _fp_driven(
            vol.swapaxes(1, 2), sin_v[idx_y], cos_v[idx_y], cor[idx_y], det_x
        )
        out = out.at[:, idx_y, :].set(py)
    return out


def _driven_tables(angles: np.ndarray):
    """float32 (cos, sin) of every angle and its driven-frame (cos_d, sin_d):
    the pair itself for x-driven angles, swapped for y-driven ones — the
    values the XLA reference computes with."""
    cos_v = np.cos(angles).astype(np.float32)
    sin_v = np.sin(angles).astype(np.float32)
    ydrive = np.abs(np.cos(angles)) < np.abs(np.sin(angles))
    cos_d = np.where(ydrive, sin_v, cos_v)
    sin_d = np.where(ydrive, cos_v, sin_v)
    return cos_v, sin_v, cos_d, sin_d, ydrive


def _fp_kernel(vol: jnp.ndarray, geom: Geometry, interpret: bool):
    _, _, cos_d, sin_d, ydrive = _driven_tables(geom.angles)
    vol_t = jnp.swapaxes(vol, 1, 2) if ydrive.any() else vol
    return joseph_fp(
        vol, vol_t, jnp.asarray(sin_d), jnp.asarray(np.float32(1.0) / cos_d),
        jnp.asarray(geom.cor_horizontal), ydrive,
        geom.detectors_x_total, interpret=interpret,
    )


def radon_bp(
    sino: jnp.ndarray, geom: Geometry, impl: str = "auto"
) -> jnp.ndarray:
    """Back-project a sinogram (exact adjoint of :func:`radon_fp`).

    sino (nz, n_angles, det_x_total) or 2D -> vol (nz, n, n) or (n, n).
    The output slice size is ``geom.recon_size``.  ``impl``: see
    :func:`_dispatch`.
    """
    squeeze = sino.ndim == 2
    sino = (sino[None] if squeeze else sino).astype(jnp.float32)
    dzv = geom.cor_vertical
    if dzv is not None and not squeeze and np.any(dzv):
        sino = _vshift_sino(sino, -np.asarray(dzv))
    vol = _dispatch(
        impl, partial(_bp_xla, geom=geom), partial(_bp_kernel, geom=geom), sino
    )
    return vol[0] if squeeze else vol


def _bp_xla(sino: jnp.ndarray, geom: Geometry) -> jnp.ndarray:
    angles = geom.angles
    cor = geom.cor_horizontal
    n = geom.recon_size
    cos_v, sin_v = np.cos(angles), np.sin(angles)
    idx_x, idx_y = _angle_partition(angles)

    nz = sino.shape[0]
    vol = jnp.zeros((nz, n, n), dtype=jnp.float32)
    if idx_x.size:
        vol = vol + _bp_driven(
            sino[:, idx_x, :], cos_v[idx_x], sin_v[idx_x], cor[idx_x], n, n
        )
    if idx_y.size:
        voly = _bp_driven(
            sino[:, idx_y, :], sin_v[idx_y], cos_v[idx_y], cor[idx_y], n, n
        )
        vol = vol + voly.swapaxes(1, 2)
    return vol


def _bp_kernel(sino: jnp.ndarray, geom: Geometry, interpret: bool):
    cos_v, sin_v, cos_d, _, _ = _driven_tables(geom.angles)
    n = geom.recon_size
    return joseph_bp(
        sino, jnp.asarray(cos_v), jnp.asarray(sin_v),
        jnp.asarray(np.abs(np.float32(1.0) / cos_d)),
        jnp.asarray(geom.cor_horizontal), n, n, interpret=interpret,
    )


# ---------------------------------------------------------------------------
# one driven group with its angle tables as data (one shard's work in
# tomobar_tpu.parallel.sharding): same platform rule as radon_fp/radon_bp
# ---------------------------------------------------------------------------


def fp_driven(vol, cos_d, sin_d, cor, det_x: int, impl: str = "auto"):
    """FP of an angle group that is x-driven in the (cos_d, sin_d) frame
    (callers pass a y-driven group with the volume transposed and the pair
    swapped).  Tables are (A,) float32 arrays; returns (nz, A, det_x)."""

    def kernel(v, c, s, r, interpret):
        return joseph_fp(
            v, v, s, 1.0 / c, r, np.zeros(c.shape, bool), det_x,
            interpret=interpret,
        )

    return _dispatch(
        impl, partial(_fp_driven, det_x=det_x), kernel, vol, cos_d, sin_d,
        cor,
    )


def bp_driven(sino, cos_d, sin_d, cor, ny: int, nx: int, impl: str = "auto"):
    """Adjoint of :func:`fp_driven`: (nz, A, det_x) -> (nz, ny, nx) in the
    group's driven frame."""

    def kernel(g, c, s, r, interpret):
        return joseph_bp(
            g, c, s, jnp.abs(1.0 / c), r, ny, nx, interpret=interpret
        )

    return _dispatch(
        impl, partial(_bp_driven, ny=ny, nx=nx), kernel, sino, cos_d, sin_d,
        cor,
    )


# ---------------------------------------------------------------------------
# differentiable wrappers: FP and BP are each other's VJP
# ---------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def forward_project(vol, geom: Geometry, impl: str = "auto"):
    return radon_fp(vol, geom, impl)


def _fp_fwd(vol, geom, impl):
    return radon_fp(vol, geom, impl), None


def _fp_bwd(geom, impl, _, ct):
    return (radon_bp(ct, geom, impl),)


forward_project.defvjp(_fp_fwd, _fp_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def back_project(sino, geom: Geometry, impl: str = "auto"):
    return radon_bp(sino, geom, impl)


def _bp_fwd(sino, geom, impl):
    return radon_bp(sino, geom, impl), None


def _bp_bwd(geom, impl, _, ct):
    return (radon_fp(ct, geom, impl),)


back_project.defvjp(_bp_fwd, _bp_bwd)


# ---------------------------------------------------------------------------
# Projector: cached per-geometry operator pair with OS subset support
# ---------------------------------------------------------------------------


class Projector:
    """Operator pair A / A^T for a fixed geometry, with OS subsets.

    The replacement for the reference's ``AstraTools2D/3D`` classes
    (``astra_tools2d.py:8``, ``astra_tools3d.py:19``): it owns the
    per-subset geometries and exposes ``fp``/``bp`` plus ``fp_sub``/
    ``bp_sub`` for ordered subsets.  ``impl`` selects the implementation
    (:func:`_dispatch`): ``"xla"`` runs the reference on every platform,
    for cross-checks on a GPU.
    """

    def __init__(self, geom: Geometry, impl: str = "auto"):
        self.geom = geom
        self.impl = impl
        self.subset_indices = geom.os_indices()
        self._sub_geoms = [geom.subset(ind) for ind in self.subset_indices]

    # full operators ---------------------------------------------------------
    def fp(self, vol: jnp.ndarray) -> jnp.ndarray:
        return radon_fp(vol, self.geom, self.impl)

    def bp(self, sino: jnp.ndarray) -> jnp.ndarray:
        return radon_bp(sino, self.geom, self.impl)

    # OS subset operators ----------------------------------------------------
    def fp_sub(self, vol: jnp.ndarray, sub: int) -> jnp.ndarray:
        return radon_fp(vol, self._sub_geoms[sub], self.impl)

    def bp_sub(self, sino: jnp.ndarray, sub: int) -> jnp.ndarray:
        return radon_bp(sino, self._sub_geoms[sub], self.impl)

    def sino_subset(self, sino: jnp.ndarray, sub: int) -> jnp.ndarray:
        ind = self.subset_indices[sub]
        if sino.ndim == 2:
            return sino[ind, :]
        return sino[:, ind, :]
