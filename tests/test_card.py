"""Card-only checks of the compiled GPU kernels (never interpreted).

Interpret mode runs the kernels with XLA semantics on the CPU, so what only
the Triton compiler decides (block layouts, masked gathers, FMA
contraction) shows here alone.  Marked ``gpu``: they skip on the CPU lane
and run inside ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tomobar_tpu.geometry import Geometry
from tomobar_tpu.ops.projector import Projector

pytestmark = pytest.mark.gpu


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _geom(nz, cor=0.0, det_x=256, recon=256, pad=0, n_ang=180, os_number=1):
    angles = np.linspace(0.0, np.pi, n_ang, endpoint=False)
    return Geometry(
        detectors_x=det_x, detectors_y=nz, angles=angles,
        center_rot_offset=cor, recon_size=recon, detectors_x_pad=pad,
        os_number=os_number,
    )


def _pair(geom, seed=0):
    rng = np.random.default_rng(seed)
    n = geom.recon_size
    vol = jnp.asarray(rng.random((geom.detectors_y, n, n)), jnp.float32)
    sino = jnp.asarray(
        rng.random((geom.detectors_y, geom.n_angles, geom.detectors_x_total)),
        jnp.float32,
    )
    return vol, sino


@pytest.mark.parametrize(
    "nz,cor,det_x,recon,pad",
    [(1, 0.0, 256, 256, 0), (3, 2.5, 256, 256, 0), (8, -1.5, 300, 256, 0),
     (2, 0.75, 256, 256, 16)],
    ids=["2d", "cor", "det_ne_recon", "pad"],
)
def test_compiled_kernels_match_reference(nz, cor, det_x, recon, pad):
    geom = _geom(nz, cor, det_x, recon, pad)
    vol, sino = _pair(geom)
    P, R = Projector(geom), Projector(geom, impl="xla")
    assert _rel(jax.jit(P.fp)(vol), jax.jit(R.fp)(vol)) < 1e-5
    assert _rel(jax.jit(P.bp)(sino), jax.jit(R.bp)(sino)) < 1e-5


@pytest.mark.parametrize("nz", [1, 8])
def test_compiled_adjointness(nz):
    geom = _geom(nz, cor=2.5)
    vol, sino = _pair(geom, seed=1)
    P = Projector(geom)
    lhs = np.vdot(np.asarray(jax.jit(P.fp)(vol), np.float64),
                  np.asarray(sino, np.float64))
    rhs = np.vdot(np.asarray(vol, np.float64),
                  np.asarray(jax.jit(P.bp)(sino), np.float64))
    assert abs(lhs - rhs) / abs(lhs) < 1e-5


def test_vertical_cor_on_card():
    angles = np.linspace(0.0, np.pi, 90, endpoint=False)
    cor = np.stack([np.linspace(-1, 1, 90), np.linspace(-1.5, 1.5, 90)], 1)
    geom = Geometry(detectors_x=128, detectors_y=6, angles=angles,
                    center_rot_offset=cor, recon_size=128)
    vol, sino = _pair(geom, seed=2)
    P, R = Projector(geom), Projector(geom, impl="xla")
    assert _rel(jax.jit(P.fp)(vol), jax.jit(R.fp)(vol)) < 1e-5
    assert _rel(jax.jit(P.bp)(sino), jax.jit(R.bp)(sino)) < 1e-5


def test_sharded_kernels_on_card_mesh():
    """ShardedProjector runs the compiled kernels per shard under
    shard_map (a one-card mesh: the collectives are trivial, the kernel
    path is the same)."""
    from tomobar_tpu.parallel.sharding import ShardedProjector, make_mesh

    geom = _geom(4, cor=1.25, n_ang=120, os_number=3)
    vol, _ = _pair(geom, seed=3)
    P = Projector(geom)
    sp = ShardedProjector(geom, make_mesh(1, 1, devices=jax.devices()[:1]))
    for s in range(len(P.subset_indices)):
        want = jax.jit(lambda v, s=s: P.fp_sub(v, s))(vol)
        got = jax.jit(lambda v, s=s: sp.fp_sub(v, s))(vol)
        assert _rel(got, want) < 1e-6
        back = jax.jit(lambda y, s=s: sp.bp_sub(y, s))(want)
        assert _rel(back, jax.jit(lambda y, s=s: P.bp_sub(y, s))(want)) < 1e-6


def test_sharded_direct_on_card_mesh():
    from tomobar_tpu.models.direct import RecToolsDIRTPU
    from tomobar_tpu.parallel import ShardedDirect
    from tomobar_tpu.parallel.sharding import make_mesh

    N, nz, A = 128, 4, 64
    angles = np.linspace(0, np.pi, A, endpoint=False)
    rt = RecToolsDIRTPU(N, 0, nz, 0.0, angles, N)
    data = jnp.asarray(np.random.default_rng(4).random((nz, A, N)), jnp.float32)
    sd = ShardedDirect(rt, make_mesh(1, 1, devices=jax.devices()[:1]))
    d = sd.device_put_sino(data)
    fbp = jax.jit(lambda x: rt.FBP(jnp.swapaxes(x, 0, 1)))(data)
    assert _rel(jax.jit(sd.fbp)(d), fbp) < 1e-6
    # the gridding scatter-add runs on atomics: its sum order varies
    assert _rel(jax.jit(sd.fourier_inv)(d), jax.jit(rt.FOURIER_INV)(data)) < 1e-5
