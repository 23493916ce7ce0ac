"""Support-tool tests (reference: tests/test_tools.py — normaliser,
padding shapes, axis-swap logic; plus autocropper which the reference
leaves untested)."""

import numpy as np
import pytest

from tomobar_tpu.utils.tools import (
    apply_circular_mask,
    apply_horiz_detector_padding,
    autocropper,
    data_dims_swapper,
    normaliser,
    perform_recon_crop,
)


class TestAutocropper:
    def _stack(self, n_proj=4, det_v=64, det_h=80, box=(20, 44, 30, 58)):
        rng = np.random.default_rng(7)
        data = rng.uniform(0.0, 0.05, (n_proj, det_v, det_h)).astype(np.float32)
        v0, v1, h0, h1 = box
        data[:, v0:v1, h0:h1] += 1.0
        return data, box

    def test_crops_to_object_with_margin(self):
        data, (v0, v1, h0, h1) = self._stack()
        addbox = 3
        out = autocropper(data, addbox=addbox, backgr_pix1=8)
        # crop must contain the object plus the addbox margin
        assert out.shape[0] == data.shape[0]
        assert out.shape[1] <= (v1 - v0) + 2 * addbox + 2
        assert out.shape[2] <= (h1 - h0) + 2 * addbox + 2
        # the object's full mass is preserved
        assert out.sum() >= data[:, v0:v1, h0:h1].sum()

    def test_no_object_returns_full_height(self):
        rng = np.random.default_rng(3)
        data = rng.uniform(0.0, 0.05, (2, 32, 40)).astype(np.float32)
        out = autocropper(data, addbox=0, backgr_pix1=4)
        # pure noise: thresholds sit above most profiles; result is a
        # valid (possibly full) crop, never an empty array
        assert out.size > 0

    def test_keeps_secondary_objects(self):
        """Two separated blobs: both must survive (the reference's
        walk-from-peak can drop the second one)."""
        data, _ = self._stack(box=(10, 20, 10, 20))
        data[:, 40:50, 60:70] += 1.0
        out = autocropper(data, addbox=0, backgr_pix1=8)
        assert out.shape[1] >= 40 and out.shape[2] >= 60


class TestMaskCropPad:
    def test_circular_mask_radius_semantics(self):
        vol = np.ones((2, 32, 32), dtype=np.float32)
        small = np.asarray(apply_circular_mask(vol, 0.5))
        full = np.asarray(apply_circular_mask(vol, 1.0))
        grown = np.asarray(apply_circular_mask(vol, 2.0))
        # radius <= 1 shrinks, > 1 grows (reference suppTools.py:387-394;
        # demos use 2.0 to mean "no cropping")
        assert small.sum() < full.sum() <= grown.sum()
        assert grown.sum() == vol.sum()

    def test_horiz_padding_shapes(self):
        data = np.ones((3, 5, 16), dtype=np.float32)
        out = np.asarray(apply_horiz_detector_padding(data, 4))
        assert out.shape == (3, 5, 24)
        # edge padding repeats the boundary values
        np.testing.assert_allclose(out[..., :4], 1.0)

    def test_recon_crop_centres(self):
        vol = np.zeros((2, 16, 16), dtype=np.float32)
        vol[:, 4:12, 4:12] = 1.0
        out = np.asarray(perform_recon_crop(vol, 8))
        assert out.shape == (2, 8, 8)
        np.testing.assert_allclose(out, 1.0)


class TestAxisSwapper:
    def test_to_canonical_3d(self):
        data = np.arange(2 * 3 * 4).reshape(2, 3, 4)
        out = np.asarray(
            data_dims_swapper(data, ["angles", "detY", "detX"],
                              ["detY", "angles", "detX"])
        )
        assert out.shape == (3, 2, 4)
        np.testing.assert_array_equal(out, np.swapaxes(data, 0, 1))

    def test_identity_when_ordered(self):
        data = np.zeros((2, 3, 4))
        out = np.asarray(
            data_dims_swapper(data, ["detY", "angles", "detX"],
                              ["detY", "angles", "detX"])
        )
        assert out.shape == data.shape


class TestNormaliser:
    def test_mean_flats_log(self):
        rng = np.random.default_rng(5)
        flats = rng.uniform(0.9, 1.1, (4, 6, 8)).astype(np.float32)
        darks = np.zeros((4, 6, 8), dtype=np.float32)
        data = 0.5 * flats[:1] * np.ones((10, 6, 8), dtype=np.float32)
        out = normaliser(data, flats, darks, log=True, method="mean")
        assert out.shape == data.shape
        # -log(0.5) ~ 0.693 up to flat-field noise
        assert abs(out.mean() - 0.693) < 0.1

    def test_dynamic_dffc_runs(self):
        """Dynamic (PCA eigen-flat-field) normalisation end-to-end on a
        synthetic stack with a drifting flat field."""
        rng = np.random.default_rng(11)
        dety, nfr, detx = 16, 12, 24
        base = 1.0 + 0.1 * np.sin(np.linspace(0, 3, detx))[None, :]
        drift = np.linspace(0.9, 1.1, nfr)
        flats = np.stack(
            [base * d + 0.01 * rng.standard_normal((dety, detx))
             for d in drift], axis=1
        ).astype(np.float32)  # (detY, frames, detX)
        data = (0.6 * flats).astype(np.float32)
        darks = np.zeros_like(flats)
        out = normaliser(
            data, flats, darks, log=True, method="dynamic",
            dyn_iterations=3,
        )
        assert out.shape == data.shape and np.isfinite(out).all()
        assert abs(np.median(out) - 0.511) < 0.15  # -log(0.6) ~ 0.511

    def test_dynamic_dffc_wavelet_denoiser(self):
        """dyn_denoiser='wavelet' routes eigen-flat-field denoising
        through the Haar shrinkage (the built-in
        stand-in for the reference's optional BM3D)."""
        rng = np.random.default_rng(12)
        dety, nfr, detx = 16, 10, 24
        flats = (
            1.0 + 0.05 * rng.standard_normal((dety, nfr, detx))
        ).astype(np.float32)
        data = (0.7 * flats).astype(np.float32)
        out = normaliser(
            data, flats, np.zeros_like(flats), log=True, method="dynamic",
            dyn_denoiser="wavelet", dyn_iterations=3,
        )
        assert out.shape == data.shape and np.isfinite(out).all()
        with pytest.raises(NameError):
            normaliser(
                data, flats, np.zeros_like(flats), method="dynamic",
                dyn_denoiser="bm3d",
            )

    def test_wavelet_denoise_reduces_noise(self):
        from tomobar_tpu.utils.dffc import wavelet_denoise

        rng = np.random.default_rng(13)
        y, x = np.mgrid[0:64, 0:64]
        clean = np.sin(x / 9.0) + 0.5 * np.cos(y / 7.0)
        noisy = clean + 0.2 * rng.standard_normal(clean.shape)
        den = wavelet_denoise(noisy)
        assert den.shape == clean.shape
        err_n = np.sqrt(np.mean((noisy - clean) ** 2))
        err_d = np.sqrt(np.mean((den - clean) ** 2))
        assert err_d < 0.7 * err_n, (err_n, err_d)


class TestCenterFinder:
    """Automatic CoR estimation (utils/center.py) — a framework addition
    the reference leaves to manual demo sweeps."""

    def _sino(self, cor, n=128, nang=180):
        import jax.numpy as jnp

        from conftest import shepp_logan_slice
        from tomobar_tpu.geometry import Geometry
        from tomobar_tpu.ops.projector import radon_fp

        angles = np.linspace(0, np.pi, nang, endpoint=False)
        geom = Geometry(
            detectors_x=n, detectors_y=None, angles=angles, recon_size=n,
            center_rot_offset=cor,
        )
        return np.asarray(
            radon_fp(jnp.asarray(shepp_logan_slice(n)), geom)
        ), angles

    @pytest.mark.parametrize("cor", [0.0, 3.25, -5.5, 10.0])
    def test_correlation_recovers_cor(self, cor):
        from tomobar_tpu.utils.center import find_center_correlation

        sino, angles = self._sino(cor)
        est = find_center_correlation(sino, angles)
        assert abs(est - cor) < 0.35, (cor, est)

    def test_noise_robust_and_3d_input(self):
        from tomobar_tpu.utils.center import find_center_correlation

        sino, angles = self._sino(4.5)
        rng = np.random.default_rng(3)
        noisy = sino + rng.normal(0, 0.05 * sino.max(), sino.shape)
        est = find_center_correlation(
            np.stack([noisy, noisy]), angles, search_radius=20.0
        )
        assert abs(est - 4.5) < 0.5, est
