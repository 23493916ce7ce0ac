"""The GPU Joseph kernels (ops/projector_triton.py) in Pallas interpret
mode against the XLA reference, plus the platform dispatch rule.

Both compute the same discrete operator, so the comparisons are float32
summation-order tight.  Sizes stay tiny (N <= 64, <= 32 angles): the
interpreter runs every program of the grid on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tomobar_tpu.geometry import Geometry
from tomobar_tpu.ops.projector import (
    Projector,
    forward_project,
    radon_bp,
    radon_fp,
)

N = 32
ANGLE_SETS = {
    # |cos| >= |sin| everywhere, |sin| > |cos| everywhere, and both groups
    "x_driven": np.linspace(-0.7, 0.7, 12),
    "y_driven": np.linspace(np.pi / 4 + 0.05, 3 * np.pi / 4 - 0.05, 12),
    "full": np.linspace(0.0, np.pi, 24, endpoint=False),
}
RTOL = 2e-6  # relative L2, float32 sums in another order


def _geom(angles, nz, cor=0.0, det_x=N, recon=N, pad=0, os_number=1):
    return Geometry(
        detectors_x=det_x, detectors_y=nz, angles=angles,
        center_rot_offset=cor, recon_size=recon, detectors_x_pad=pad,
        os_number=os_number,
    )


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _vol(nz, n=N, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((nz, n, n)), jnp.float32)


def _sino(geom, seed=1):
    rng = np.random.default_rng(seed)
    shape = (geom.detectors_y, geom.n_angles, geom.detectors_x_total)
    return jnp.asarray(rng.standard_normal(shape), jnp.float32)


@pytest.mark.parametrize("op", ["fp", "bp"])
@pytest.mark.parametrize("angle_set", sorted(ANGLE_SETS))
@pytest.mark.parametrize("nz", [1, 3])
@pytest.mark.parametrize("cor", [0.0, 2.5])
def test_kernel_matches_reference(op, angle_set, nz, cor):
    geom = _geom(ANGLE_SETS[angle_set], nz, cor)
    if op == "fp":
        x, fn = _vol(nz), radon_fp
    else:
        x, fn = _sino(geom), radon_bp
    got = fn(x, geom, impl="interpret")
    want = fn(x, geom, impl="xla")
    assert got.shape == want.shape
    assert _rel(got, want) < RTOL


@pytest.mark.parametrize("nz", [1, 3])
@pytest.mark.parametrize("cor", [0.0, -1.75])
def test_kernel_adjointness(nz, cor):
    geom = _geom(ANGLE_SETS["full"], nz, cor)
    x, y = _vol(nz, seed=2), _sino(geom, seed=3)
    ax = radon_fp(x, geom, impl="interpret")
    aty = radon_bp(y, geom, impl="interpret")
    lhs = np.vdot(np.asarray(ax, np.float64), np.asarray(y, np.float64))
    rhs = np.vdot(np.asarray(x, np.float64), np.asarray(aty, np.float64))
    assert abs(lhs - rhs) / abs(lhs) < 1e-5


def test_kernel_os_subsets_tile_full_fp():
    geom = _geom(ANGLE_SETS["full"], 2, 1.0, os_number=4)
    P = Projector(geom, impl="interpret")
    vol = _vol(2)
    full = np.asarray(P.fp(vol))
    for s, ind in enumerate(P.subset_indices):
        np.testing.assert_allclose(
            np.asarray(P.fp_sub(vol, s)), full[:, ind, :], rtol=1e-6,
            atol=1e-6,
        )


def test_kernel_vertical_cor():
    angles = ANGLE_SETS["full"]
    cor = np.stack(
        [np.linspace(-1.0, 1.0, angles.size),
         np.linspace(-1.5, 1.5, angles.size)], axis=1,
    )
    geom = _geom(angles, 4, cor)
    vol, sino = _vol(4), _sino(geom)
    assert _rel(radon_fp(vol, geom, "interpret"), radon_fp(vol, geom, "xla")) < RTOL
    assert _rel(radon_bp(sino, geom, "interpret"), radon_bp(sino, geom, "xla")) < RTOL


@pytest.mark.parametrize(
    "det_x,recon,pad", [(48, 40, 0), (40, 40, 4)],
    ids=["det_x_ne_recon", "detector_pad"],
)
def test_kernel_detector_shapes(det_x, recon, pad):
    geom = _geom(ANGLE_SETS["full"], 2, 0.5, det_x=det_x, recon=recon, pad=pad)
    vol, sino = _vol(2, n=recon), _sino(geom)
    fp = radon_fp(vol, geom, "interpret")
    assert fp.shape == (2, geom.n_angles, det_x + 2 * pad)
    assert _rel(fp, radon_fp(vol, geom, "xla")) < RTOL
    bp = radon_bp(sino, geom, "interpret")
    assert bp.shape == (2, recon, recon)
    assert _rel(bp, radon_bp(sino, geom, "xla")) < RTOL


def test_forward_project_vjp_is_kernel_bp():
    geom = _geom(ANGLE_SETS["full"], 2, 1.5)
    vol, y = _vol(2), _sino(geom)
    _, vjp = jax.vjp(lambda v: forward_project(v, geom, "interpret"), vol)
    (grad,) = vjp(y)
    np.testing.assert_allclose(
        np.asarray(grad), np.asarray(radon_bp(y, geom, "interpret")),
        rtol=1e-6, atol=1e-6,
    )


class TestDispatch:
    """One rule: the kernel when lowering for NVIDIA GPUs, the XLA reference
    for CPUs, an error for anything else (here: AMD GPUs)."""

    geom = _geom(ANGLE_SETS["full"], 2)

    def _lowered(self, platform):
        vol = _vol(2)
        return jax.jit(lambda v: radon_fp(v, self.geom)).trace(vol).lower(
            lowering_platforms=(platform,)
        )

    def test_cpu_runs_reference(self):
        text = self._lowered("cpu").as_text()
        assert "triton" not in text
        vol = _vol(2)
        np.testing.assert_array_equal(
            np.asarray(radon_fp(vol, self.geom)),
            np.asarray(radon_fp(vol, self.geom, impl="xla")),
        )

    def test_gpu_lowers_kernel(self):
        text = self._lowered("cuda").as_text()
        assert "__gpu$xla.gpu.triton" in text
        assert "joseph_fp" in text

    def test_other_platform_raises(self):
        with pytest.raises(NotImplementedError, match="rocm"):
            self._lowered("rocm")
        with pytest.raises(ValueError, match="impl"):
            radon_fp(_vol(2), self.geom, impl="pallas")
