"""Multi-chip / multi-host sharding: detY slabs x angle subsets on a mesh.

The reference is a single-GPU library (SURVEY.md §2.3: "ToMoBAR in itself
doesn't offer any parallelisation"); scaling happens outside it via MPI
one-process-per-GPU.  Here distribution is a first-class framework layer:

* mesh axes ``("z", "angles")`` — detY slabs are embarrassingly parallel
  for parallel-beam geometry (the invariant the reference proves in its
  blockwise-consistency tests); the angle axis shards the projection/
  backprojection work per slab, with a ``psum`` over the angle axis
  reducing partial backprojections.
* collectives are XLA's native collectives inserted by ``shard_map``
  (NCCL on GPUs) — no MPI analogue needed.
* **multi-host**: :func:`distributed_init` + :func:`make_mesh` lay the z
  axis process-major, so slabs split across hosts (no inter-host
  collectives in the solver loop) and the angle psum stays within each
  host.
* **uniform SPMD**: shard_map requires one program for every device, so
  instead of switching between per-shard geometries (compiles every
  branch into every device's program), angles are globally partitioned
  into the projector's x-driven / y-driven groups, each group is dealt
  round-robin over the angle shards (OS-style interleave — keeps each
  shard's angular coverage uniform), and every shard runs the *same*
  driven kernel on its own (cos, sin, cor) slice passed as data.

Use :func:`make_mesh` + :class:`ShardedProjector` in place of
:class:`tomobar_tpu.ops.projector.Projector` to run solvers unchanged on a
mesh (the solver cores only call fp/bp/fp_sub/bp_sub).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from tomobar_tpu.geometry import Geometry
from tomobar_tpu.ops.projector import (
    _angle_partition,
    _vshift_sino,
    bp_driven,
    fp_driven,
)

__all__ = [
    "distributed_init",
    "make_mesh",
    "ShardedProjector",
]


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> None:
    """Initialise multi-host JAX if not already initialised.

    Pass the coordinator address, process count and process id
    explicitly; nothing in a plain GPU cluster tells JAX of them.  Safe to
    call twice.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except RuntimeError as e:  # already initialised
        if "already" not in str(e).lower():
            raise


def make_mesh(
    n_z: Optional[int] = None,
    n_angles: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Create a ("z", "angles") mesh over the available (global) devices.

    By default all devices go to the z (slab) axis — the cheapest axis in
    communication terms (no collectives at all).  Give ``n_angles > 1`` to
    also shard the angle axis (adds a volume-sized psum per BP).

    Multi-host: ``jax.devices()`` is process-major, so with
    ``n_z % process_count == 0`` (enforced) the z axis splits across hosts
    and the angle axis stays within a host, which is the
    communication-optimal layout for this workload.
    """
    devices = list(devices if devices is not None else jax.devices())
    n_dev = len(devices)
    if n_z is None and n_angles is None:
        n_z, n_angles = n_dev, 1
    elif n_z is None:
        n_z = n_dev // n_angles
    elif n_angles is None:
        n_angles = n_dev // n_z
    if n_z * n_angles != n_dev:
        raise ValueError(
            f"mesh {n_z}x{n_angles} does not match {n_dev} devices"
        )
    n_proc = len({getattr(d, "process_index", 0) for d in devices})
    if n_proc > 1 and n_z % n_proc != 0:
        raise ValueError(
            f"multi-host mesh needs the z axis ({n_z}) divisible by the "
            f"process count ({n_proc}) so slabs split across hosts; got "
            f"{n_z} % {n_proc} != 0"
        )
    dev_array = np.asarray(devices).reshape(n_z, n_angles)
    return Mesh(dev_array, ("z", "angles"))


class _GroupPlan:
    """Host-side plan for one driven group sharded over S angle shards.

    ``cos/sin/cor`` are the padded, shard-contiguous parameter vectors
    (shard s owns positions [s*B, (s+1)*B)); ``ang_idx`` maps each kept
    padded position back to its canonical angle index and ``keep_pos`` are
    the padded positions that carry real angles.  Pad entries use the
    x-driven-safe (cos=1, sin=0) line so the kernels stay finite; their
    outputs are dropped (FP) or fed zeros (BP).
    """

    def __init__(self, idx, cos_g, sin_g, cor_g, S):
        n = idx.size
        self.B = -(-n // S) if n else 0  # ceil
        total = S * self.B
        cos_p = np.ones(total, np.float64)
        sin_p = np.zeros(total, np.float64)
        cor_p = np.zeros(total, np.float64)
        keep = np.zeros(total, bool)
        ang_idx = []
        for s in range(S):
            blk = idx[np.arange(s, n, S)]  # round-robin deal (canonical ids)
            p0 = s * self.B
            cos_p[p0 : p0 + blk.size] = cos_g[blk]
            sin_p[p0 : p0 + blk.size] = sin_g[blk]
            cor_p[p0 : p0 + blk.size] = cor_g[blk]
            keep[p0 : p0 + blk.size] = True
            ang_idx.extend(blk)
        self.cos = cos_p
        self.sin = sin_p
        self.cor = cor_p
        self.keep_pos = np.where(keep)[0]
        self.ang_idx = np.asarray(ang_idx, dtype=np.int64)
        # BP gather: canonical angle index per padded position; pads point
        # at a zero column appended to the sinogram
        self.gather_idx = np.full(total, -1, dtype=np.int64)
        self.gather_idx[self.keep_pos] = self.ang_idx


class _ShardPlan:
    """Both driven groups of one angle set, planned for S angle shards."""

    def __init__(self, geom: Geometry, S: int):
        angles = geom.angles
        cor = geom.cor_horizontal
        cos_v, sin_v = np.cos(angles), np.sin(angles)
        idx_x, idx_y = _angle_partition(angles)
        # y-driven group: kernels run with (sin, cos) swapped + transposed
        self.gx = _GroupPlan(idx_x, cos_v, sin_v, cor, S)
        self.gy = _GroupPlan(idx_y, sin_v, cos_v, cor, S)
        self.n_angles = geom.n_angles
        self.det_x = geom.detectors_x_total
        self.recon_size = geom.recon_size
        # [n, 2] CoR: per-angle vertical detector shift applied along the
        # (sharded) z axis outside shard_map — XLA's SPMD partitioner
        # inserts the halo exchange (reference semantics supp/funcs.py:45-65)
        dzv = geom.cor_vertical
        self.cor_vertical = (
            np.asarray(dzv) if dzv is not None and np.any(dzv) else None
        )


class ShardedProjector:
    """Projector pair over a ("z", "angles") mesh via shard_map.

    Drop-in for :class:`~tomobar_tpu.ops.projector.Projector` inside the
    solver cores: volumes are sharded (z-slabs, replicated over angles);
    sinograms are sharded over (z, angles); ``bp`` psums partial
    backprojections over the angle axis.  Every device runs the same
    program — per-shard angle parameters are data, not geometry branches.
    ``impl`` picks the per-shard implementation as for
    :class:`~tomobar_tpu.ops.projector.Projector`.
    """

    def __init__(self, geom: Geometry, mesh: Mesh, impl: str = "auto"):
        self.geom = geom
        self.mesh = mesh
        self.impl = impl
        self.n_ang_shards = mesh.shape["angles"]
        self.subset_indices = geom.os_indices()
        self._plan = _ShardPlan(geom, self.n_ang_shards)
        self._sub_plans = [
            _ShardPlan(geom.subset(ind), self.n_ang_shards)
            for ind in self.subset_indices
        ]

        self.vol_spec = P("z", None, None)
        self.sino_spec = P("z", "angles", None)

    # -- core sharded ops -----------------------------------------------------

    def _fp_group(self, vol, grp: _GroupPlan, det_x: int, transpose: bool):
        """vol (nz, n, n) -> padded group sinogram (nz, S*B, det_x)."""

        def local(v, c, s, r):
            vv = jnp.swapaxes(v, 1, 2) if transpose else v
            return fp_driven(vv, c, s, r, det_x, self.impl)

        # pallas_call outputs carry no varying-axes metadata, so the
        # per-shard kernels run with the check off
        return shard_map(
            local,
            mesh=self.mesh,
            in_specs=(self.vol_spec, P("angles"), P("angles"), P("angles")),
            out_specs=self.sino_spec,
            check_vma=False,
        )(
            vol,
            jnp.asarray(grp.cos, jnp.float32),
            jnp.asarray(grp.sin, jnp.float32),
            jnp.asarray(grp.cor, jnp.float32),
        )

    def _bp_group(self, sino_g, grp: _GroupPlan, n: int, transpose: bool):
        """padded group sinogram (nz, S*B, det_x) -> vol (nz, n, n)."""

        def local(s_, c, s2, r):
            part = bp_driven(s_, c, s2, r, n, n, self.impl)
            if transpose:
                part = jnp.swapaxes(part, 1, 2)
            return jax.lax.psum(part, "angles")

        return shard_map(
            local,
            mesh=self.mesh,
            in_specs=(self.sino_spec, P("angles"), P("angles"), P("angles")),
            out_specs=self.vol_spec,
            check_vma=False,
        )(
            sino_g,
            jnp.asarray(grp.cos, jnp.float32),
            jnp.asarray(grp.sin, jnp.float32),
            jnp.asarray(grp.cor, jnp.float32),
        )

    def _fp_plan(self, vol, plan: _ShardPlan):
        nz = vol.shape[0]
        out = jnp.zeros((nz, plan.n_angles, plan.det_x), dtype=jnp.float32)
        for grp, transpose in ((plan.gx, False), (plan.gy, True)):
            if grp.B == 0:
                continue
            pg = self._fp_group(vol, grp, plan.det_x, transpose)
            out = out.at[:, grp.ang_idx, :].set(pg[:, grp.keep_pos, :])
        return out

    def _bp_plan(self, sino, plan: _ShardPlan):
        nz = sino.shape[0]
        n = plan.recon_size
        # zero column appended: pad positions gather zeros
        sino_z = jnp.pad(sino, ((0, 0), (0, 1), (0, 0)))
        vol = jnp.zeros((nz, n, n), dtype=jnp.float32)
        for grp, transpose in ((plan.gx, False), (plan.gy, True)):
            if grp.B == 0:
                continue
            sino_g = sino_z[:, grp.gather_idx, :]
            vol = vol + self._bp_group(sino_g, grp, n, transpose)
        return vol

    # -- Projector interface --------------------------------------------------

    def fp(self, vol):
        return self._post_fp(self._fp_plan(vol, self._plan), self._plan)

    def bp(self, sino):
        return self._bp_plan(self._pre_bp(sino, self._plan), self._plan)

    def fp_sub(self, vol, sub: int):
        plan = self._sub_plans[sub]
        return self._post_fp(self._fp_plan(vol, plan), plan)

    def bp_sub(self, sino, sub: int):
        plan = self._sub_plans[sub]
        return self._bp_plan(self._pre_bp(sino, plan), plan)

    def _post_fp(self, sino, plan: _ShardPlan):
        if plan.cor_vertical is None:
            return sino
        return _vshift_sino(sino, plan.cor_vertical)

    def _pre_bp(self, sino, plan: _ShardPlan):
        if plan.cor_vertical is None:
            return sino
        return _vshift_sino(sino, -plan.cor_vertical)

    def sino_subset(self, sino, sub: int):
        ind = self.subset_indices[sub]
        if sino.ndim == 2:
            return sino[ind, :]
        return sino[:, ind, :]

    # -- placement helpers ----------------------------------------------------

    def device_put_vol(self, vol):
        return jax.device_put(vol, NamedSharding(self.mesh, self.vol_spec))

    def device_put_sino(self, sino):
        # canonical sinograms are placed z-sharded only: the angle axis is
        # consumed in driven-group order (a reshard/all-to-all inside the
        # jitted step regardless), and its length need not divide the
        # angle-shard count
        return jax.device_put(
            sino, NamedSharding(self.mesh, P("z", None, None))
        )
