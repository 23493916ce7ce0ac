"""Joseph projector pair as Pallas kernels for NVIDIA GPUs (Triton route).

The same discrete operator as the XLA reference in
:mod:`tomobar_tpu.ops.projector` (``_fp_driven`` / ``_bp_driven``), written
as gather-only kernels that keep their partial sums in registers:

* **FP, ray-driven.**  One program owns ``_FP_AB`` angles, a block of
  ``_FP_TB`` detector cells and up to ``_ZC`` slices.  It walks the driven
  image rows and gathers the two interpolation taps per crossed row from
  the volume; the neighbouring cells and angles of the block hit the same
  volume lines in L1.  y-driven angles read a transposed copy of the
  volume, so every gather runs along a contiguous row.
* **BP, voxel-driven exact adjoint.**  One program owns a
  ``_BP_TY x _BP_TX`` voxel tile and up to ``_ZC`` slices, and walks the
  angles, gathering the hat-weighted taps from the sinogram rows.  The
  reference's third tap (``floor(t) - 1``) always has weight
  ``max(0, 1 - |alpha| (1 + frac)) = 0`` because ``|alpha| >= 1``, so the
  kernel gathers the two taps that can be non-zero.  The weight formula
  makes x- and y-driven angles differ only in ``|alpha| =
  1 / max(|cos|, |sin|)``, so one launch covers every angle with no
  transposes.

Angle tables (sin, ``1/cos``, CoR) are kernel inputs, not constants,
so one compiled kernel serves every OS subset of the same size.  No
atomics: each output element is written by exactly one program.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

__all__ = ["joseph_fp", "joseph_bp"]

_FP_TB = 256  # detector cells per FP program
_FP_AB = 4  # angles per FP program (they share the volume rows in L1)
_BP_TY, _BP_TX = 16, 32  # voxel tile per BP program
_ZC = 8  # slices per program (unrolled; each has its own accumulator)
_NUM_WARPS = 4


def _compiler_params():
    return plt.CompilerParams(num_warps=_NUM_WARPS, num_stages=1)


def _fp_kernel(
    s_ref, inv_ref, cor_ref, yd_ref, vol_ref, volt_ref, out_ref,
    *, nz, nrow, ncol, det_x, zc, tb, ab,
):
    a0 = pl.program_id(0) * ab
    t0 = pl.program_id(1) * tb
    z0 = pl.program_id(2) * zc
    t = t0 + jnp.arange(tb, dtype=jnp.int32)
    t_ok = t < det_x
    tf = t.astype(jnp.float32) - (det_x - 1) / 2.0
    cx = (ncol - 1) / 2.0
    cy = (nrow - 1) / 2.0
    sins = [s_ref[a0 + j] for j in range(ab)]
    invs = [inv_ref[a0 + j] for j in range(ab)]
    s_ts = [tf + cor_ref[a0 + j] for j in range(ab)]
    zs = [jnp.minimum(z0 + k, nz - 1) for k in range(zc)]

    def run(src_ref):
        def body(y, accs):
            yv = y.astype(jnp.float32) - cy
            out = list(accs)
            for j in range(ab):
                pos = (s_ts[j] - yv * sins[j]) * invs[j] + cx
                i0f = jnp.floor(pos)
                frac = pos - i0f
                i0 = i0f.astype(jnp.int32)
                i1 = i0 + 1
                m0 = t_ok & (i0 >= 0) & (i0 < ncol)
                m1 = t_ok & (i1 >= 0) & (i1 < ncol)
                j0 = jnp.clip(i0, 0, ncol - 1)
                j1 = jnp.clip(i1, 0, ncol - 1)
                for k in range(zc):
                    row = (zs[k], y)
                    g0 = plt.load(src_ref.at[(*row, j0)], mask=m0, other=0.0)
                    g1 = plt.load(src_ref.at[(*row, j1)], mask=m1, other=0.0)
                    out[j * zc + k] += (1.0 - frac) * g0 + frac * g1
            return tuple(out)

        init = tuple(jnp.zeros((tb,), jnp.float32) for _ in range(ab * zc))
        accs = jax.lax.fori_loop(0, nrow, body, init)
        for j in range(ab):
            scale = jnp.abs(invs[j])
            for k in range(zc):
                plt.store(
                    out_ref.at[zs[k], a0 + j, pl.ds(t0, tb)],
                    accs[j * zc + k] * scale,
                    mask=t_ok & (z0 + k < nz),
                )

    # the caller groups the angles so that a program's block is all
    # x-driven or all y-driven
    ydrive = yd_ref[a0]

    @pl.when(ydrive == 0)
    def _():
        run(vol_ref)

    @pl.when(ydrive != 0)
    def _():
        run(volt_ref)


def _fp_slots(ydrive: np.ndarray, ab: int):
    """Static angle -> program-slot plan: x-driven angles first, then
    y-driven ones, each group padded to a multiple of ``ab`` so that every
    program's angle block is homogeneous.  Returns (src, keep): slot i
    takes angle ``src[i]`` (pads repeat a real angle of the group), and
    ``keep[a]`` is the slot holding angle ``a``."""
    src, keep = [], np.empty(ydrive.size, np.int64)
    for grp in (np.where(~ydrive)[0], np.where(ydrive)[0]):
        if grp.size == 0:
            continue
        keep[grp] = len(src) + np.arange(grp.size)
        pad = (-grp.size) % ab
        src.extend(grp.tolist() + [int(grp[-1])] * pad)
    return np.asarray(src, np.int64), keep


def joseph_fp(vol, vol_t, sin_d, inv_cos_d, cor, ydrive, det_x,
              *, interpret=False):
    """Ray-driven Joseph FP of ``vol`` (nz, n, n) -> (nz, A, det_x).

    Per angle ``a`` the tables give the driven-frame ``sin_d`` and
    ``inv_cos_d = 1 / cos_d``, where ``(cos_d, sin_d)`` is ``(cos, sin)``
    for x-driven angles and ``(sin, cos)`` for y-driven ones, and the CoR.
    ``ydrive`` (a static numpy bool array) marks the angles that sample
    ``vol_t`` (``vol`` with its last two axes swapped) instead of ``vol``.
    ``interpret`` runs the kernel on the CPU (tests only)."""
    nz, nrow, ncol = vol.shape
    ydrive = np.asarray(ydrive, bool)
    src, keep = _fp_slots(ydrive, _FP_AB)
    n_slots = src.size
    zc = min(nz, _ZC)
    kernel = partial(
        _fp_kernel, nz=nz, nrow=nrow, ncol=ncol, det_x=det_x, zc=zc,
        tb=_FP_TB, ab=_FP_AB,
    )
    f32 = jnp.float32
    tables = [jnp.asarray(x, f32)[src] for x in (sin_d, inv_cos_d, cor)]
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((nz, n_slots, det_x), f32),
        grid=(n_slots // _FP_AB, pl.cdiv(det_x, _FP_TB), pl.cdiv(nz, zc)),
        backend="triton",
        compiler_params=_compiler_params(),
        interpret=interpret,
        name="joseph_fp",
    )(
        *tables, jnp.asarray(ydrive[src], jnp.int32),
        vol.astype(f32), vol_t.astype(f32),
    )
    if n_slots == ydrive.size and np.array_equal(keep, np.arange(n_slots)):
        return out
    return out[:, keep, :]


def _bp_kernel(
    c_ref, s_ref, aa_ref, cor_ref, sino_ref, out_ref,
    *, nz, n_ang, det_x, ny, nx, zc, ty, tx,
):
    y = pl.program_id(0) * ty + jnp.arange(ty, dtype=jnp.int32)[:, None]
    x = pl.program_id(1) * tx + jnp.arange(tx, dtype=jnp.int32)[None, :]
    z0 = pl.program_id(2) * zc
    xs = x.astype(jnp.float32) - (nx - 1) / 2.0
    ys = y.astype(jnp.float32) - (ny - 1) / 2.0
    zs = [jnp.minimum(z0 + k, nz - 1) for k in range(zc)]
    t_mid = (det_x - 1) / 2.0

    def body(a, accs):
        a_abs = aa_ref[a]
        t_c = xs * c_ref[a] + ys * s_ref[a] + t_mid - cor_ref[a]
        tf = jnp.floor(t_c)
        w0 = jnp.maximum(0.0, 1.0 - a_abs * jnp.abs(tf - t_c)) * a_abs
        w1 = jnp.maximum(0.0, 1.0 - a_abs * jnp.abs(tf + 1.0 - t_c)) * a_abs
        i0 = tf.astype(jnp.int32)
        i1 = i0 + 1
        m0 = (i0 >= 0) & (i0 < det_x)
        m1 = (i1 >= 0) & (i1 < det_x)
        j0 = jnp.clip(i0, 0, det_x - 1)
        j1 = jnp.clip(i1, 0, det_x - 1)
        out = []
        for k in range(zc):
            g0 = plt.load(sino_ref.at[zs[k], a, j0], mask=m0, other=0.0)
            g1 = plt.load(sino_ref.at[zs[k], a, j1], mask=m1, other=0.0)
            out.append(accs[k] + (w0 * g0 + w1 * g1))
        return tuple(out)

    init = tuple(jnp.zeros((ty, tx), jnp.float32) for _ in range(zc))
    accs = jax.lax.fori_loop(0, n_ang, body, init)
    ok = (y < ny) & (x < nx)
    y0 = pl.program_id(0) * ty
    x0 = pl.program_id(1) * tx
    for k in range(zc):
        plt.store(
            out_ref.at[zs[k], pl.ds(y0, ty), pl.ds(x0, tx)],
            accs[k],
            mask=ok & (z0 + k < nz),
        )


def joseph_bp(sino, cos_v, sin_v, a_abs, cor, ny, nx, *, interpret=False):
    """Voxel-driven exact adjoint of :func:`joseph_fp`: ``sino``
    (nz, A, det_x) -> (nz, ny, nx).

    ``cos_v``/``sin_v`` are the angles' own cosines and sines (no driven
    swap), ``a_abs = 1 / max(|cos|, |sin|)``.  ``interpret`` runs the kernel
    on the CPU (tests only)."""
    nz, n_ang, det_x = sino.shape
    zc = min(nz, _ZC)
    kernel = partial(
        _bp_kernel, nz=nz, n_ang=n_ang, det_x=det_x, ny=ny, nx=nx, zc=zc,
        ty=_BP_TY, tx=_BP_TX,
    )
    f32 = jnp.float32
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((nz, ny, nx), f32),
        grid=(pl.cdiv(ny, _BP_TY), pl.cdiv(nx, _BP_TX), pl.cdiv(nz, zc)),
        backend="triton",
        compiler_params=_compiler_params(),
        interpret=interpret,
        name="joseph_bp",
    )(
        cos_v.astype(f32), sin_v.astype(f32), a_abs.astype(f32),
        cor.astype(f32), sino.astype(f32),
    )
