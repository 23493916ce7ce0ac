"""z-slab sharded direct reconstruction (FBP / FOURIER_INV) on a mesh.

The reference bounds memory by looping FOURIER_INV over detY chunks on one
GPU (``methodsDIR_CuPy.py:493-541,870-896``); the same blockwise-
consistency invariant (its tests ``test_RecToolsDIRCuPy.py:253-338``) makes
detY the natural *mesh* axis here: every z slab reconstructs independently,
so the whole pipeline runs under ``shard_map`` with zero collectives on the
z axis.

* ``fbp``: the sinc/classic filter is z-elementwise (rfft along detX), so
  it runs as plain sharded ops; the backprojection reuses
  :class:`~tomobar_tpu.parallel.sharding.ShardedProjector` (angle-axis
  psum when the mesh shards angles).
* ``fourier_inv``: each z shard runs the full USFFT pipeline
  (filter -> pack pairs -> FFT -> gridding -> ifft2 -> phi-unpad) on its
  local slab.  The angle mesh axis, if present, replicates this work — use
  z-only meshes for direct methods.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tomobar_tpu.parallel.sharding import ShardedProjector
from tomobar_tpu.ops.filters import filter_sino_classic, filter_sino_sinc
from tomobar_tpu.utils.tools import (
    apply_horiz_detector_padding,
    check_kwargs,
)

__all__ = ["ShardedDirect"]


class ShardedDirect:
    """Sharded counterparts of ``RecToolsDIRTPU.FBP`` / ``FOURIER_INV``.

    Data is canonical ``(detY, angles, detX)`` with detY sharded over the
    mesh's ``"z"`` axis (use :meth:`device_put_sino` to place it).
    """

    def __init__(self, model, mesh: Mesh):
        self.model = model
        self.mesh = mesh
        self.sp = ShardedProjector(model.geom, mesh)

    @staticmethod
    def _require_canonical_axes(kwargs):
        """Sharded entry points take canonical (detY, angles, detX) only.

        The single-device methods honour ``data_axes_labels_order`` via
        ``data_dims_swapper``; here the detY axis is already mesh-sharded,
        so silently accepting another order would slab-shard the wrong
        axis and return a wrong reconstruction.  Reorder on the host
        (``data_dims_swapper``) before ``device_put_sino``.
        """
        order = kwargs.pop("data_axes_labels_order", None)
        if order is not None and list(order) != ["detY", "angles", "detX"]:
            raise ValueError(
                f"ShardedDirect requires canonical axes ['detY', 'angles', "
                f"'detX'] (got {list(order)}): the detY axis is mesh-sharded, "
                "so reorder with tomobar_tpu.utils.tools.data_dims_swapper "
                "before device_put_sino"
            )

    # -- placement ------------------------------------------------------------

    def device_put_sino(self, sino):
        return jax.device_put(
            sino, NamedSharding(self.mesh, P("z", None, None))
        )

    # -- FBP ------------------------------------------------------------------

    def fbp(self, data, **kwargs):
        """Sharded 3D FBP.  data (detY, angles, detX), detY z-sharded.

        Same filter semantics as ``RecToolsDIRTPU.FBP`` (sinc by default,
        classic bank via ``filter_type``); the filter is per-z elementwise
        so XLA keeps it on the local slab, and the backprojection runs
        through the sharded projector.
        """
        self._require_canonical_axes(kwargs)
        cutoff = kwargs.get("cutoff_freq", 0.35)
        filter_type = kwargs.get("filter_type")
        data = jnp.asarray(data, jnp.float32)
        data = apply_horiz_detector_padding(data, self.model.detectors_x_pad)
        if filter_type is not None:
            filtered = filter_sino_classic(
                data, filter_type, kwargs.get("filter_parameter"),
                kwargs.get("filter_d", 1.0),
            )
        else:
            filtered = filter_sino_sinc(data, cutoff)
        rec = self.sp.bp(filtered)
        return check_kwargs(
            rec, recon_mask_radius=kwargs.get("recon_mask_radius"),
            cupyrun=False,
        )

    # -- FOURIER_INV ----------------------------------------------------------

    def fourier_inv(self, data, **kwargs):
        """Sharded log-polar/USFFT inversion.  data (detY, angles, detX),
        detY z-sharded; detY must split into even-sized slabs (the
        two-real-slices-per-complex FFT packing needs pairs per shard).
        """
        from tomobar_tpu.ops.usfft import fourier_inv

        self._require_canonical_axes(kwargs)
        data = jnp.asarray(data, jnp.float32)
        nz = data.shape[0]
        n_z_shards = self.mesh.shape["z"]
        if nz % (2 * n_z_shards):
            raise ValueError(
                f"sharded FOURIER_INV needs detY ({nz}) divisible by "
                f"2 * z-shards ({n_z_shards}) so every shard packs whole "
                f"slice pairs; pad detY or change the mesh"
            )
        model = self.model
        local_kwargs = dict(kwargs)

        def local(block):
            return fourier_inv(model, block, **local_kwargs)

        return shard_map(
            local,
            mesh=self.mesh,
            in_specs=P("z", None, None),
            out_specs=P("z", None, None),
            check_vma=False,  # the gridding scan's zero carry is not marked varying
        )(data)
