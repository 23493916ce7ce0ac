"""Multi-device scaling-efficiency benchmark (BASELINE north-star:
>= 80% scaling efficiency to 2 hosts at RMSE parity).

Weak scaling over the z (slab) axis: per-device work is held constant
(``nz_per_device`` slabs each) while the mesh grows, so ideal scaling is a
flat time-per-iteration and efficiency = t(1 device) / t(N devices).
Parallel-beam slabs are independent (the reference's blockwise-consistency
invariant), so the z axis carries no solver collectives and the measured
loss is pure runtime/dispatch overhead; across hosts the script runs
unchanged under ``jax.distributed`` (see
``parallel.sharding.distributed_init``).

Run:  python -m tomobar_tpu.bench.scaling
CPU smoke: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
           TOMOBAR_BENCH_N=256 python -m tomobar_tpu.bench.scaling
"""

import json
import os

import numpy as np

def count_psums_in_step(n_a_devices, N, nz, nproj, os_number, tv_iters=2):
    """Compile the angle-sharded outer step and audit its all-reduces.

    Validates that the compiled HLO moves the collective payload the
    design implies (2 full volumes per subset: one psum per driven group
    per BP, ``ShardedProjector._bp_group``).  XLA's all-reduce combiner
    merges adjacent psums into tuple all-reduces, so the op COUNT is not
    meaningful; the audited quantities are the number of full-volume
    operands and the total reduced bytes (the model payload plus small
    gather-index side tensors XLA folds into the same collectives)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from tomobar_tpu.geometry import Geometry
    from tomobar_tpu.parallel.sharding import ShardedProjector, make_mesh
    from tomobar_tpu.regularisers import PD_TV

    angles = np.linspace(0, np.pi, nproj, endpoint=False)
    geom = Geometry(
        detectors_x=N, detectors_y=nz, angles=angles, recon_size=N,
        os_number=os_number,
    )
    mesh = make_mesh(1, n_a_devices, devices=jax.devices()[:n_a_devices])
    sp = ShardedProjector(geom, mesh)
    key = jax.random.PRNGKey(0)
    sino = jax.device_put(
        jax.random.uniform(key, (nz, nproj, N), dtype=jnp.float32),
        NamedSharding(mesh, sp.sino_spec),
    )
    x = jax.device_put(
        jnp.zeros((nz, N, N), dtype=jnp.float32),
        NamedSharding(mesh, sp.vol_spec),
    )
    L_inv = jnp.float32(1e-4)

    def outer_iter(x, sino):
        for s in range(len(sp.subset_indices)):
            res = sp.fp_sub(x, s) - sp.sino_subset(sino, s)
            x = jnp.maximum(x - L_inv * sp.bp_sub(res, s), 0.0)
            x = PD_TV(x, 1e-4, tv_iters, 0, 1, 12.0)
        return x

    hlo = jax.jit(outer_iter).lower(x, sino).compile().as_text()
    import re

    vol_shape = f"f32[{nz},{N},{N}]"
    n_vol_reduces = 0
    reduced_bytes = 0
    for line in hlo.splitlines():
        ms = re.match(r"\s*%?\S+ = (.*?) all-reduce(?:-start)?\(", line)
        if not ms:
            continue
        shapes = re.findall(r"f32\[([\d,]*)\]", ms.group(1))
        for dims in shapes:
            elems = 1
            for d in dims.split(","):
                if d:
                    elems *= int(d)
            reduced_bytes += 4 * elems
        n_vol_reduces += ms.group(1).count(vol_shape)
    model_bytes = 2 * os_number * nz * N * N * 4
    return {
        "model_volume_psums": 2 * os_number,
        "hlo_volume_psums": n_vol_reduces,
        "model_bytes": model_bytes,
        "hlo_reduced_bytes": reduced_bytes,
        "hlo_over_model": round(reduced_bytes / model_bytes, 4),
    }


def run(N=None, nz_per_device=None, nproj=None, os_number=None, tv_iters=None):
    import jax
    import jax.numpy as jnp

    from tomobar_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from jax.sharding import NamedSharding
    from tomobar_tpu.bench.harness import time_fn
    from tomobar_tpu.geometry import Geometry
    from tomobar_tpu.parallel.sharding import ShardedProjector, make_mesh
    from tomobar_tpu.regularisers import PD_TV

    N = N or int(os.environ.get("TOMOBAR_BENCH_N", 2560))
    nz_per_device = nz_per_device or int(os.environ.get("TOMOBAR_BENCH_NZ", 8))
    nproj = nproj or int(os.environ.get("TOMOBAR_BENCH_NPROJ", 1801))
    os_number = os_number or int(os.environ.get("TOMOBAR_BENCH_OS", 10))
    tv_iters = tv_iters or int(os.environ.get("TOMOBAR_BENCH_TV_ITERS", 20))

    n_dev = len(jax.devices())
    angles = np.linspace(0, np.pi, nproj, endpoint=False)

    def iter_rate(n_z_devices: int) -> float:
        nz = nz_per_device * n_z_devices
        geom = Geometry(
            detectors_x=N, detectors_y=nz, angles=angles, recon_size=N,
            os_number=os_number,
        )
        mesh = make_mesh(n_z_devices, 1, devices=jax.devices()[:n_z_devices])
        sp = ShardedProjector(geom, mesh)
        key = jax.random.PRNGKey(0)
        sino = jax.device_put(
            jax.random.uniform(key, (nz, nproj, N), dtype=jnp.float32),
            NamedSharding(mesh, sp.vol_spec),
        )
        x = jax.device_put(
            jnp.zeros((nz, N, N), dtype=jnp.float32),
            NamedSharding(mesh, sp.vol_spec),
        )
        L_inv = jnp.float32(1.0 / 5000.0)

        def outer_iter(x, sino):
            for s in range(len(sp.subset_indices)):
                res = sp.fp_sub(x, s) - sp.sino_subset(sino, s)
                x = jnp.maximum(x - L_inv * sp.bp_sub(res, s), 0.0)
                x = PD_TV(x, 1e-4, tv_iters, 0, 1, 12.0)
            return x

        step = jax.jit(outer_iter)  # no donation: time_fn re-feeds x
        dt = time_fn(step, x, sino, warmup=1, reps=3)
        return 1.0 / dt

    def iter_rate_angles(n_a_devices: int) -> float:
        """Strong scaling over the angle (psum) axis: the global problem is
        fixed at nz_per_device slabs; each device projects its angle shard
        of every subset and gradients reduce with psum."""
        nz = nz_per_device
        geom = Geometry(
            detectors_x=N, detectors_y=nz, angles=angles, recon_size=N,
            os_number=os_number,
        )
        mesh = make_mesh(1, n_a_devices, devices=jax.devices()[:n_a_devices])
        sp = ShardedProjector(geom, mesh)
        key = jax.random.PRNGKey(0)
        sino = jax.device_put(
            jax.random.uniform(key, (nz, nproj, N), dtype=jnp.float32),
            NamedSharding(mesh, sp.sino_spec),
        )
        x = jax.device_put(
            jnp.zeros((nz, N, N), dtype=jnp.float32),
            NamedSharding(mesh, sp.vol_spec),
        )
        L_inv = jnp.float32(1.0 / 5000.0)

        def outer_iter(x, sino):
            for s in range(len(sp.subset_indices)):
                res = sp.fp_sub(x, s) - sp.sino_subset(sino, s)
                x = jnp.maximum(x - L_inv * sp.bp_sub(res, s), 0.0)
                x = PD_TV(x, 1e-4, tv_iters, 0, 1, 12.0)
            return x

        step = jax.jit(outer_iter)
        dt = time_fn(step, x, sino, warmup=1, reps=3)
        return 1.0 / dt

    r1 = iter_rate(1)
    rN = iter_rate(n_dev)
    eff = rN / r1  # weak scaling: per-device work constant -> ideal 1.0
    ra1 = iter_rate_angles(1)
    raN = iter_rate_angles(n_dev)
    eff_a = raN / (ra1 * n_dev)  # strong scaling: ideal speedup = n_dev
    # On virtual CPU meshes N "devices" share the host's physical cores,
    # so raw weak-scaling efficiency conflates sharding overhead with
    # core oversubscription (ideal is cores/N, not 1).  The throughput
    # ratio — total slab-iterations/s at N devices vs 1 device on the
    # SAME hardware — isolates the sharding/runtime overhead and is the
    # honest CPU-proxy number; on real GPUs (1 device = 1 card) the raw
    # efficiency is the metric.
    import multiprocessing

    cores = multiprocessing.cpu_count()
    tput_eff = (rN * n_dev) / r1  # total-work throughput ratio (ideal 1.0
    #                               when devices share saturated cores)
    out = {
        "metric": f"scaling efficiency to {n_dev} devices "
        f"({nproj}x{nz_per_device}/dev x{N}, FISTA-OS{os_number}-TV)",
        "value": round(eff, 4),
        "unit": "efficiency",
        "platform": jax.devices()[0].platform,
        "physical_cores": cores,
        "oversubscribed": n_dev > cores and jax.devices()[0].platform == "cpu",
        "z_axis": {
            "mode": "weak (nz_per_device fixed; no collectives)",
            "iter_s_1dev": round(r1, 4),
            f"iter_s_{n_dev}dev": round(rN, 4),
            "efficiency_raw": round(eff, 4),
            "throughput_ratio": round(tput_eff, 4),
        },
        "angles_axis": {
            "mode": "strong (global problem fixed; psum-reduced gradients)",
            "iter_s_1dev": round(ra1, 4),
            f"iter_s_{n_dev}dev": round(raN, 4),
            "speedup": round(raN / ra1, 4),
            "efficiency": round(eff_a, 4),
        },
        "vs_baseline": round(eff / 0.8, 4),
    }
    out["psum_count_check"] = count_psums_in_step(
        min(n_dev, 8), N, nz_per_device, nproj, os_number
    )
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    run()
