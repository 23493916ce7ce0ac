"""Projector tests: adjointness, analytic values, CoR shifts, OS consistency,
slab-blockwise consistency (the invariants the reference proves in
tests/test_RecToolsDIRCuPy.py:253-338 plus the adjoint test it lacks)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tomobar_tpu.geometry import Geometry
from tomobar_tpu.ops.projector import (
    Projector,
    back_project,
    forward_project,
    radon_bp,
    radon_fp,
)


def make_geom(N=32, T=40, A=37, nz=3, cor=0.0, os_number=1):
    angles = np.linspace(0, 2 * np.pi, A, endpoint=False) + 0.123
    return Geometry(
        detectors_x=T,
        detectors_y=nz,
        angles=angles,
        center_rot_offset=cor,
        recon_size=N,
        os_number=os_number,
    )


class TestAdjointness:
    @pytest.mark.parametrize("cor", [0.0, 1.7, -2.3])
    def test_fp_bp_adjoint(self, cor):
        rng = np.random.default_rng(0)
        geom = make_geom(cor=cor)
        x = jnp.asarray(rng.standard_normal((3, 32, 32)), dtype=jnp.float32)
        y = jnp.asarray(rng.standard_normal((3, 37, 40)), dtype=jnp.float32)
        lhs = float(jnp.vdot(radon_fp(x, geom), y))
        rhs = float(jnp.vdot(x, radon_bp(y, geom)))
        assert abs(lhs - rhs) / abs(lhs) < 1e-4

    def test_adjoint_per_angle_vector_cor(self):
        rng = np.random.default_rng(1)
        A = 37
        cor_vec = rng.uniform(-3, 3, size=A)
        geom = make_geom(A=A, cor=cor_vec)
        x = jnp.asarray(rng.standard_normal((3, 32, 32)), dtype=jnp.float32)
        y = jnp.asarray(rng.standard_normal((3, A, 40)), dtype=jnp.float32)
        lhs = float(jnp.vdot(radon_fp(x, geom), y))
        rhs = float(jnp.vdot(x, radon_bp(y, geom)))
        assert abs(lhs - rhs) / abs(lhs) < 1e-4

    def test_custom_vjp_pair(self):
        rng = np.random.default_rng(2)
        geom = make_geom()
        x = jnp.asarray(rng.standard_normal((3, 32, 32)), dtype=jnp.float32)
        import jax

        _, vjp = jax.vjp(lambda v: forward_project(v, geom), x)
        y = jnp.asarray(rng.standard_normal((3, 37, 40)), dtype=jnp.float32)
        (grad,) = vjp(y)
        np.testing.assert_allclose(
            np.asarray(grad), np.asarray(radon_bp(y, geom)), rtol=1e-5
        )


class TestAnalytic:
    def test_disk_chords(self):
        """FP of a uniform disk equals the chord length 2*sqrt(r^2-s^2)."""
        N = T = 64
        geom = Geometry(
            detectors_x=T,
            detectors_y=None,
            angles=np.array([0.0, np.pi / 2, np.pi / 4, 1.1]),
            recon_size=N,
        )
        yy, xx = np.mgrid[0:N, 0:N]
        r = 20.0
        disk = (
            ((xx - (N - 1) / 2) ** 2 + (yy - (N - 1) / 2) ** 2) <= r * r
        ).astype(np.float32)
        p = np.asarray(radon_fp(jnp.asarray(disk), geom))
        s = np.arange(T) - (T - 1) / 2
        chord = 2 * np.sqrt(np.maximum(r * r - s * s, 0))
        for i in range(p.shape[0]):
            assert np.max(np.abs(p[i] - chord)) / chord.max() < 0.05

    def test_cor_shift_moves_projection(self):
        """A positive CoR offset shifts the detector, so the projection of a
        centred object moves by -cor detector cells."""
        N = T = 64
        yy, xx = np.mgrid[0:N, 0:N]
        disk = (
            ((xx - (N - 1) / 2) ** 2 + (yy - (N - 1) / 2) ** 2) <= 15**2
        ).astype(np.float32)
        g0 = Geometry(detectors_x=T, detectors_y=None, angles=np.array([0.3]))
        g5 = Geometry(
            detectors_x=T, detectors_y=None, angles=np.array([0.3]),
            center_rot_offset=5.0,
        )
        p0 = np.asarray(radon_fp(jnp.asarray(disk), g0))[0]
        p5 = np.asarray(radon_fp(jnp.asarray(disk), g5))[0]
        c0 = float(np.sum(np.arange(T) * p0) / np.sum(p0))
        c5 = float(np.sum(np.arange(T) * p5) / np.sum(p5))
        assert abs((c0 - c5) - 5.0) < 0.05

    def test_2d_3d_consistency(self):
        """3D FP of stacked identical slices equals repeated 2D FP."""
        rng = np.random.default_rng(3)
        sl = rng.standard_normal((32, 32)).astype(np.float32)
        vol = np.stack([sl] * 4)
        g2 = make_geom(nz=None)
        g3 = make_geom(nz=4)
        p2 = np.asarray(radon_fp(jnp.asarray(sl), g2))
        p3 = np.asarray(radon_fp(jnp.asarray(vol), g3))
        for z in range(4):
            np.testing.assert_allclose(p3[z], p2, rtol=1e-5, atol=1e-5)


class TestBlockwise:
    def test_detY_slab_consistency(self):
        """Reconstruction in detY blocks must equal the full recon (the
        reference's blockwise-consistency invariant, the basis of slab
        sharding)."""
        rng = np.random.default_rng(4)
        nz = 7
        sino = rng.standard_normal((nz, 37, 40)).astype(np.float32)
        geom = make_geom(nz=nz)
        full = np.asarray(radon_bp(jnp.asarray(sino), geom))
        for block in (1, 2, 3):
            parts = []
            for z0 in range(0, nz, block):
                zb = sino[z0 : z0 + block]
                gb = make_geom(nz=zb.shape[0])
                parts.append(np.asarray(radon_bp(jnp.asarray(zb), gb)))
            rec = np.concatenate(parts, axis=0)
            np.testing.assert_allclose(rec, full, rtol=1e-5, atol=1e-6)


class TestOrderedSubsets:
    def test_subset_union_equals_full(self):
        """Sum of per-subset BPs equals the full BP; subset FPs tile the
        full FP."""
        rng = np.random.default_rng(5)
        geom = make_geom(A=37, os_number=5)
        P = Projector(geom)
        vol = jnp.asarray(rng.standard_normal((3, 32, 32)), dtype=jnp.float32)
        sino = jnp.asarray(rng.standard_normal((3, 37, 40)), dtype=jnp.float32)

        full_fp = np.asarray(P.fp(vol))
        full_bp = np.asarray(P.bp(sino))

        acc = np.zeros_like(full_bp)
        for s, ind in enumerate(P.subset_indices):
            fp_s = np.asarray(P.fp_sub(vol, s))
            np.testing.assert_allclose(fp_s, full_fp[:, ind, :], rtol=1e-5, atol=1e-5)
            acc += np.asarray(P.bp_sub(P.sino_subset(sino, s), s))
        np.testing.assert_allclose(acc, full_bp, rtol=1e-4, atol=1e-5)

    def test_subset_interleave_matches_reference(self):
        """OS index interleave: subset s takes s, s+OS, s+2*OS, ..."""
        geom = make_geom(A=13, os_number=4)
        subs = geom.os_indices()
        assert [list(s) for s in subs] == [
            [0, 4, 8, 12],
            [1, 5, 9],
            [2, 6, 10],
            [3, 7, 11],
        ]


class TestVerticalCoR:
    """Per-angle [horizontal, vertical] CoR (reference vector geometry
    supp/funcs.py:45-65: d0 = [cor_h, 0, cor_v]).  The vertical component
    shifts the detector rows along detY per angle."""

    def _geoms(self, N=32, nz=6, n_ang=15):
        import numpy as np
        from tomobar_tpu.geometry import Geometry

        angles = np.linspace(0.0, np.pi, n_ang, endpoint=False)
        cor2 = np.stack(
            [np.linspace(-1.0, 1.0, n_ang), np.linspace(-1.5, 1.5, n_ang)],
            axis=1,
        )
        g2 = Geometry(
            detectors_x=N, detectors_y=nz, angles=angles,
            center_rot_offset=cor2, recon_size=N,
        )
        g1 = Geometry(
            detectors_x=N, detectors_y=nz, angles=angles,
            center_rot_offset=cor2[:, 0], recon_size=N,
        )
        return g1, g2

    def test_integer_vshift_matches_rolled_rows(self):
        import numpy as np
        import jax.numpy as jnp
        from tomobar_tpu.geometry import Geometry
        from tomobar_tpu.ops.projector import radon_fp

        N, nz, n_ang = 32, 6, 8
        angles = np.linspace(0.0, np.pi, n_ang, endpoint=False)
        cor2 = np.zeros((n_ang, 2))
        cor2[:, 1] = 2.0  # integer vertical shift for every angle
        g0 = Geometry(detectors_x=N, detectors_y=nz, angles=angles,
                      recon_size=N)
        gv = Geometry(detectors_x=N, detectors_y=nz, angles=angles,
                      center_rot_offset=cor2, recon_size=N)
        rng = np.random.default_rng(0)
        vol = jnp.asarray(rng.standard_normal((nz, N, N)), dtype=jnp.float32)
        p0 = np.asarray(radon_fp(vol, g0))
        pv = np.asarray(radon_fp(vol, gv))
        # detector row v sees volume height v + cor_v
        np.testing.assert_allclose(pv[: nz - 2], p0[2:], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(pv[nz - 2 :], 0.0, atol=1e-6)

    def test_adjointness_with_vertical_cor(self):
        import numpy as np
        import jax.numpy as jnp
        from tomobar_tpu.ops.projector import radon_bp, radon_fp

        _, g2 = self._geoms()
        rng = np.random.default_rng(4)
        x = jnp.asarray(rng.standard_normal((6, 32, 32)), dtype=jnp.float32)
        y = jnp.asarray(rng.standard_normal((6, 15, 32)), dtype=jnp.float32)
        lhs = float(jnp.vdot(radon_fp(x, g2), y))
        rhs = float(jnp.vdot(x, radon_bp(y, g2)))
        assert lhs == pytest.approx(rhs, rel=1e-5)

    def test_horizontal_unchanged_by_vertical_component(self):
        import numpy as np
        import jax.numpy as jnp
        from tomobar_tpu.ops.projector import radon_fp

        g1, g2 = self._geoms()
        rng = np.random.default_rng(1)
        # z-constant volume: vertical shifts are invisible away from edges
        sl = rng.standard_normal((1, 32, 32)).astype(np.float32)
        vol = jnp.asarray(np.repeat(sl, 6, axis=0))
        p1 = np.asarray(radon_fp(vol, g1))
        p2 = np.asarray(radon_fp(vol, g2))
        np.testing.assert_allclose(p2[2:4], p1[2:4], rtol=1e-4, atol=1e-5)
