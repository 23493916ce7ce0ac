"""Shard-equivalence tests: sharded result == single-device result.

The multi-device checks run in a fresh interpreter with 8 virtual CPU
devices (the device count is fixed when JAX first opens a backend, so the
test process's own backend cannot be reshaped).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_in_cpu_mesh_subprocess(code: str, timeout=900) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        env=env,
        capture_output=True,
        text=True,
        timeout=timeout,
    )
    assert out.returncode == 0, f"subprocess failed:\n{out.stdout}\n{out.stderr}"
    return out.stdout


def test_sharded_projector_equivalence():
    out = run_in_cpu_mesh_subprocess(
        """
        import numpy as np, jax, jax.numpy as jnp
        from tomobar_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        from tomobar_tpu.geometry import Geometry
        from tomobar_tpu.ops.projector import Projector
        from tomobar_tpu.parallel.sharding import make_mesh, ShardedProjector

        N, nz, A = 32, 8, 40
        rng = np.random.default_rng(0)
        angles = np.linspace(0, np.pi, A, endpoint=False)
        geom = Geometry(detectors_x=N, detectors_y=nz, angles=angles, recon_size=N)
        vol = rng.standard_normal((nz, N, N)).astype(np.float32)
        sino = rng.standard_normal((nz, A, N)).astype(np.float32)
        ref = Projector(geom)
        fp_ref = np.asarray(ref.fp(jnp.asarray(vol)))
        bp_ref = np.asarray(ref.bp(jnp.asarray(sino)))
        for (zm, am) in [(8, 1), (4, 2), (2, 4)]:
            mesh = make_mesh(zm, am)
            sp = ShardedProjector(geom, mesh)
            v = sp.device_put_vol(jnp.asarray(vol))
            s = sp.device_put_sino(jnp.asarray(sino))
            fp_s = np.asarray(jax.jit(sp.fp)(v))
            bp_s = np.asarray(jax.jit(sp.bp)(s))
            assert np.abs(fp_s - fp_ref).max() < 1e-4, (zm, am)
            assert np.abs(bp_s - bp_ref).max() < 1e-4, (zm, am)
        print("EQUIV_OK")
        """
    )
    assert "EQUIV_OK" in out


def test_dryrun_multichip():
    out = run_in_cpu_mesh_subprocess(
        """
        import jax
        from tomobar_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        import __graft_entry__ as g
        g.dryrun_multichip(8)
        """
    )
    assert "dryrun_multichip ok" in out


def test_sharded_os_subsets_and_per_angle_cor():
    """fp_sub/bp_sub over OS subsets and per-angle CoR match the
    single-device Projector on every mesh split."""
    out = run_in_cpu_mesh_subprocess(
        """
        import numpy as np, jax, jax.numpy as jnp
        from tomobar_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        from tomobar_tpu.geometry import Geometry
        from tomobar_tpu.ops.projector import Projector
        from tomobar_tpu.parallel.sharding import make_mesh, ShardedProjector

        N, nz, A = 32, 8, 40
        rng = np.random.default_rng(1)
        angles = np.linspace(0, np.pi, A, endpoint=False)
        cor = np.linspace(-1.5, 1.5, A)
        geom = Geometry(detectors_x=N, detectors_y=nz, angles=angles,
                        center_rot_offset=cor, recon_size=N, os_number=4)
        vol = rng.standard_normal((nz, N, N)).astype(np.float32)
        ref = Projector(geom)
        mesh = make_mesh(2, 4)
        sp = ShardedProjector(geom, mesh)
        v = sp.device_put_vol(jnp.asarray(vol))
        for s in range(len(ref.subset_indices)):
            fp_ref = np.asarray(ref.fp_sub(jnp.asarray(vol), s))
            fp_s = np.asarray(jax.jit(lambda x, s=s: sp.fp_sub(x, s))(v))
            assert np.abs(fp_s - fp_ref).max() < 1e-4, s
            sub = rng.standard_normal(fp_ref.shape).astype(np.float32)
            bp_ref = np.asarray(ref.bp_sub(jnp.asarray(sub), s))
            bp_s = np.asarray(jax.jit(lambda x, s=s: sp.bp_sub(x, s))(jnp.asarray(sub)))
            assert np.abs(bp_s - bp_ref).max() < 2e-4, s
        print("OS_COR_OK")
        """
    )
    assert "OS_COR_OK" in out


def test_sharded_vertical_cor():
    """[n, 2] CoR (horizontal + vertical detector shift) matches the
    single-device Projector on a mesh — the vertical shift crosses z-shard
    boundaries, so XLA must insert the halo exchange."""
    out = run_in_cpu_mesh_subprocess(
        """
        import numpy as np, jax, jax.numpy as jnp
        from tomobar_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        from tomobar_tpu.geometry import Geometry
        from tomobar_tpu.ops.projector import Projector
        from tomobar_tpu.parallel.sharding import make_mesh, ShardedProjector

        N, nz, A = 32, 8, 40
        rng = np.random.default_rng(2)
        angles = np.linspace(0, np.pi, A, endpoint=False)
        cor = np.stack([np.linspace(-1.5, 1.5, A),
                        np.linspace(-2.0, 2.0, A)], axis=1)  # [n, 2]
        geom = Geometry(detectors_x=N, detectors_y=nz, angles=angles,
                        center_rot_offset=cor, recon_size=N)
        vol = rng.standard_normal((nz, N, N)).astype(np.float32)
        sino = rng.standard_normal((nz, A, N)).astype(np.float32)
        ref = Projector(geom)
        fp_ref = np.asarray(ref.fp(jnp.asarray(vol)))
        bp_ref = np.asarray(ref.bp(jnp.asarray(sino)))
        assert np.abs(fp_ref).max() > 0
        for (zm, am) in [(4, 2), (2, 4)]:
            mesh = make_mesh(zm, am)
            sp = ShardedProjector(geom, mesh)
            v = sp.device_put_vol(jnp.asarray(vol))
            s = sp.device_put_sino(jnp.asarray(sino))
            fp_s = np.asarray(jax.jit(sp.fp)(v))
            bp_s = np.asarray(jax.jit(sp.bp)(s))
            assert np.abs(fp_s - fp_ref).max() < 1e-4, (zm, am)
            assert np.abs(bp_s - bp_ref).max() < 1e-4, (zm, am)
        print("VCOR_OK")
        """
    )
    assert "VCOR_OK" in out


def test_sharded_kernel_path():
    """The GPU Joseph kernels run per shard under shard_map: interpret
    mode on the 8-device CPU mesh (``impl="interpret"``) against the
    single-device XLA reference."""
    out = run_in_cpu_mesh_subprocess(
        """
        import numpy as np, jax, jax.numpy as jnp
        from tomobar_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        from tomobar_tpu.geometry import Geometry
        from tomobar_tpu.ops.projector import Projector
        from tomobar_tpu.parallel.sharding import make_mesh, ShardedProjector

        N, nz, A = 32, 4, 24
        rng = np.random.default_rng(3)
        angles = np.linspace(0, np.pi, A, endpoint=False)
        geom = Geometry(detectors_x=N, detectors_y=nz, angles=angles,
                        center_rot_offset=1.25, recon_size=N)
        vol = rng.standard_normal((nz, N, N)).astype(np.float32)
        sino = rng.standard_normal((nz, A, N)).astype(np.float32)
        ref = Projector(geom, impl="xla")
        fp_ref = np.asarray(ref.fp(jnp.asarray(vol)))
        bp_ref = np.asarray(ref.bp(jnp.asarray(sino)))

        mesh = make_mesh(2, 4)
        sp = ShardedProjector(geom, mesh, impl="interpret")
        fp_s = np.asarray(jax.jit(sp.fp)(sp.device_put_vol(jnp.asarray(vol))))
        bp_s = np.asarray(jax.jit(sp.bp)(sp.device_put_sino(jnp.asarray(sino))))
        assert np.abs(fp_s - fp_ref).max() < 1e-5 * np.abs(fp_ref).max()
        assert np.abs(bp_s - bp_ref).max() < 1e-5 * np.abs(bp_ref).max()
        print("KERNEL_SHARD_OK")
        """
    )
    assert "KERNEL_SHARD_OK" in out


def test_sharded_direct_pipeline():
    """z-slab sharded FBP and FOURIER_INV equal the single-device results:
    each shard reconstructs its detY slab independently — the reference's
    chunked-loop invariant
    (methodsDIR_CuPy.py:493-541) promoted to a mesh axis."""
    out = run_in_cpu_mesh_subprocess(
        """
        import numpy as np, jax, jax.numpy as jnp
        from tomobar_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        from tomobar_tpu.geometry import Geometry
        from tomobar_tpu.models.direct import RecToolsDIRTPU
        from tomobar_tpu.parallel import make_mesh, ShardedDirect

        N, nz, A = 32, 16, 40
        rng = np.random.default_rng(4)
        angles = np.linspace(0, np.pi, A, endpoint=False).astype(np.float32)
        rt = RecToolsDIRTPU(N, 0, nz, 0.0, angles, N)
        data = rng.standard_normal((nz, A, N)).astype(np.float32)

        fi_ref = np.asarray(rt.FOURIER_INV(jnp.asarray(data)))
        fbp_ref = np.asarray(rt.FBP(jnp.swapaxes(jnp.asarray(data), 0, 1)))

        for (zm, am) in [(8, 1), (4, 2)]:
            mesh = make_mesh(zm, am)
            sd = ShardedDirect(rt, mesh)
            d = sd.device_put_sino(jnp.asarray(data))
            fi_s = np.asarray(jax.jit(sd.fourier_inv)(d))
            fbp_s = np.asarray(jax.jit(sd.fbp)(d))
            assert np.abs(fi_s - fi_ref).max() < 1e-4 * np.abs(fi_ref).max(), (zm, am)
            assert np.abs(fbp_s - fbp_ref).max() < 1e-4 * np.abs(fbp_ref).max(), (zm, am)
        # indivisible detY must be rejected loudly, not silently wrong
        mesh = make_mesh(8, 1)
        sd = ShardedDirect(rt, mesh)
        try:
            sd.fourier_inv(jnp.asarray(data[:10]))
        except ValueError:
            pass
        else:
            raise AssertionError("expected ValueError for indivisible detY")
        # non-canonical axis order must be rejected loudly: detY is
        # mesh-sharded, so honouring another order silently would slab-
        # shard the wrong axis
        for meth in (sd.fbp, sd.fourier_inv):
            try:
                meth(jnp.asarray(data),
                     data_axes_labels_order=["angles", "detY", "detX"])
            except ValueError:
                pass
            else:
                raise AssertionError("expected ValueError for axis order")
        # the canonical order spelled explicitly is fine
        fi_c = np.asarray(jax.jit(lambda d: sd.fourier_inv(
            d, data_axes_labels_order=["detY", "angles", "detX"]))(
                sd.device_put_sino(jnp.asarray(data))))
        assert np.abs(fi_c - fi_ref).max() < 1e-4 * np.abs(fi_ref).max()
        print("DIRECT_SHARD_OK")
        """
    )
    assert "DIRECT_SHARD_OK" in out


_DIST_WORKER = """
import os, sys
import numpy as np
import jax
from tomobar_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
import jax.numpy as jnp

from tomobar_tpu.parallel.sharding import (
    distributed_init, make_mesh, ShardedProjector,
)

coord, pid = sys.argv[1], int(sys.argv[2])
distributed_init(coordinator_address=coord, num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())

from tomobar_tpu.geometry import Geometry
from tomobar_tpu.ops.projector import Projector
from jax.sharding import NamedSharding, PartitionSpec as P

N, nz, A = 32, 8, 20
rng = np.random.default_rng(0)
angles = np.linspace(0, np.pi, A, endpoint=False)
geom = Geometry(detectors_x=N, detectors_y=nz, angles=angles, recon_size=N)
vol = rng.standard_normal((nz, N, N)).astype(np.float32)
fp_ref = np.asarray(Projector(geom).fp(jnp.asarray(vol)))

# "z" across the 2 processes x "angles" within each
mesh = make_mesh(4, 2)
sp = ShardedProjector(geom, mesh)
v = jax.make_array_from_callback(
    vol.shape, NamedSharding(mesh, sp.vol_spec), lambda idx: vol[idx]
)
fp = jax.jit(sp.fp)(v)
for shard in fp.addressable_shards:
    got = np.asarray(shard.data)
    want = fp_ref[shard.index]
    assert np.abs(got - want).max() < 1e-4, shard.index
print(f"DIST_OK {pid}", flush=True)
"""


def test_two_process_distributed_cpu():
    """True multi-process jax.distributed run: 2 processes x 4 CPU devices,
    z axis across processes, local-shard equivalence per process."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _DIST_WORKER, coord, str(pid)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"proc {pid} failed:\n{out}\n{err}"
        assert f"DIST_OK {pid}" in out


class TestCollectivePayload:
    """The compiled sharded step moves exactly the full-volume psums the
    design implies (2 per subset: one per driven group per BP), with only
    small side tensors on top."""

    def test_hlo_psum_payload_matches_design(self):
        # subprocess: needs a multi-device mesh
        out = run_in_cpu_mesh_subprocess(
            """
            import json
            from tomobar_tpu.utils.compile_cache import enable_compile_cache
            enable_compile_cache()
            from tomobar_tpu.bench.scaling import count_psums_in_step
            audit = count_psums_in_step(
                n_a_devices=4, N=64, nz=2, nproj=48, os_number=3
            )
            print("AUDIT", json.dumps(audit))
            """
        )
        import json

        audit = json.loads(out.split("AUDIT", 1)[1].strip().splitlines()[0])
        assert audit["hlo_volume_psums"] == audit["model_volume_psums"]
        # gather-index side tensors folded into the combined collectives
        # stay a small fraction of the volume payload
        assert 1.0 <= audit["hlo_over_model"] < 1.3, audit
