#!/usr/bin/env python3
"""Multi-chip reconstruction on a device mesh: sharded FISTA + direct.

The reference is single-GPU ("ToMoBAR in itself doesn't offer any
parallelisation"); here distribution is a framework layer: a
``("z", "angles")`` mesh shards detY slabs (embarrassingly parallel) and
angle subsets (psum-reduced backprojections), and the same solver code
runs unchanged on 1 chip or a pod.

On a multi-GPU host this uses the real devices; anywhere else it demonstrates
the identical program on virtual CPU devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/multichip_sharded_recon.py
"""

import os
import sys
import timeit

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# pin the platform before jax initialises if we're demonstrating on CPU
if os.environ.get("JAX_PLATFORMS") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax
import jax.numpy as jnp

from tomobar_tpu.geometry import Geometry
from tomobar_tpu.models.direct import RecToolsDIRTPU
from tomobar_tpu.parallel import ShardedDirect, ShardedProjector, make_mesh
from tomobar_tpu.regularisers import PD_TV
from tomobar_tpu.bench.harness import rel_rmse

from phantom3d_fista_os_tv import ellipsoid_phantom


def main():
    n_dev = len(jax.devices())
    n_ang_shards = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    mesh = make_mesh(n_dev // n_ang_shards, n_ang_shards)
    print(f"mesh: {dict(mesh.shape)} over {n_dev} x {jax.devices()[0].platform}")

    N = int(os.environ.get("TOMOBAR_EXAMPLE_N", 128))
    nz = 2 * n_dev  # even slab per z shard (FOURIER_INV packs slice pairs)
    angles = np.linspace(0, np.pi, 180, endpoint=False).astype(np.float32)
    phantom = ellipsoid_phantom(N, nz)

    geom = Geometry(
        detectors_x=N, detectors_y=nz, angles=angles, recon_size=N,
        os_number=4,
    )
    SP = ShardedProjector(geom, mesh)
    sino = SP.device_put_sino(SP.fp(jnp.asarray(phantom)))

    # sharded direct reconstruction (z-slab FOURIER_INV / FBP)
    rt = RecToolsDIRTPU(N, 0, nz, 0.0, angles, N)
    SD = ShardedDirect(rt, mesh)
    fbp = jax.jit(lambda d: SD.fbp(d, cutoff_freq=1.1))(sino)
    print(f"sharded FBP     rel-RMSE {rel_rmse(np.asarray(fbp), phantom):.4f}")

    # sharded FISTA-OS-TV: identical step code as single-device solvers
    n_sub = len(SP.subset_indices)
    L_inv = jnp.float32(1.0 / (2.0 * N * len(angles) / n_sub))

    def fista_step(x, x_t, t, b):
        for s in range(n_sub):
            x_old, t_old = x, t
            grad = SP.bp_sub(SP.fp_sub(x_t, s) - SP.sino_subset(b, s), s)
            x = jnp.maximum(x_t - L_inv * grad, 0.0)
            x = PD_TV(x, 1e-4, 20, 0, 1, 12.0)
            t = (1.0 + jnp.sqrt(1.0 + 4.0 * t * t)) * 0.5
            x_t = x + ((t_old - 1.0) / t) * (x - x_old)
        return x, x_t, t

    step = jax.jit(fista_step)
    x = x_t = SP.device_put_vol(jnp.zeros((nz, N, N), jnp.float32))
    t = jnp.float32(1.0)
    t0 = timeit.default_timer()
    for _ in range(10):
        x, x_t, t = step(x, x_t, t, sino)
    jax.block_until_ready(x)
    dt = timeit.default_timer() - t0
    print(
        f"sharded FISTA   rel-RMSE {rel_rmse(np.asarray(x), phantom):.4f} "
        f"(10 outer iters, {dt:.2f} s, sharding={x.sharding.spec})"
    )


if __name__ == "__main__":
    main()
