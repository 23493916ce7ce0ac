"""(re, im)-pair FFT helpers (ops/fft_real.py) vs numpy's pocketfft."""

import numpy as np
import pytest

from tomobar_tpu.ops import fft_real as FR

TOL = 1.0
RT_ATOL = 3e-5


@pytest.mark.parametrize(
    "n", [8, 128, 160, 320, 512, 1024, 1408, 2816, 4096, 97]
)
def test_fft_matches_numpy(n):
    rng = np.random.RandomState(42)
    x = (rng.rand(3, 5, n) + 1j * rng.rand(3, 5, n)).astype(np.complex64)
    re, im = FR.fft_pairs(x.real, x.imag)
    ref = np.fft.fft(x, axis=-1)
    got = np.asarray(re) + 1j * np.asarray(im)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=TOL * 2e-4 * scale, rtol=0)


@pytest.mark.parametrize("n", [128, 320, 1408, 97])
def test_ifft_roundtrip(n):
    rng = np.random.RandomState(0)
    x = (rng.rand(2, n) + 1j * rng.rand(2, n)).astype(np.complex64)
    re, im = FR.fft_pairs(x.real, x.imag)
    yre, yim = FR.ifft_pairs(re, im)
    got = np.asarray(yre) + 1j * np.asarray(yim)
    np.testing.assert_allclose(got, x, atol=RT_ATOL)


def test_real_input_fft():
    rng = np.random.RandomState(1)
    x = rng.rand(4, 640).astype(np.float32)
    re, im = FR.fft_pairs(x)
    ref = np.fft.fft(x, axis=-1)
    got = np.asarray(re) + 1j * np.asarray(im)
    np.testing.assert_allclose(got, ref, atol=TOL * 2e-4 * np.abs(ref).max())


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 160, 128)])
def test_fft2_matches_numpy(shape):
    rng = np.random.RandomState(3)
    x = (rng.rand(*shape) + 1j * rng.rand(*shape)).astype(np.complex64)
    re, im = FR.fft2_pairs(x.real, x.imag)
    ref = np.fft.fft2(x, axes=(-2, -1))
    got = np.asarray(re) + 1j * np.asarray(im)
    np.testing.assert_allclose(
        got, ref, rtol=0.0, atol=TOL * 3e-4 * np.abs(ref).max()
    )
    yre, yim = FR.ifft2_pairs(re, im)
    back = np.asarray(yre) + 1j * np.asarray(yim)
    np.testing.assert_allclose(back, x, atol=RT_ATOL)


@pytest.mark.parametrize("n", [512, 2560])
def test_fft_relative_l2_error_bound(n):
    """Spectrum-level relative L2 error ||got - ref||_2 / ||ref||_2: a
    float32 FFT stays near 1e-7, so a wrong transform or scale trips it."""
    rng = np.random.RandomState(17)
    x = (rng.rand(4, n) + 1j * rng.rand(4, n)).astype(np.complex64)
    re, im = FR.fft_pairs(x.real, x.imag)
    ref = np.fft.fft(x, axis=-1)
    got = np.asarray(re) + 1j * np.asarray(im)
    rel_l2 = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel_l2 < 2e-6


@pytest.mark.parametrize("R", [6, 7])  # even + odd row counts (pair packing)
def test_apply_freq_filter_real(R):
    rng = np.random.RandomState(7)
    n = 256
    x = rng.rand(2, R, n).astype(np.float32)
    # Hermitian filter: real even ramp x complex shift phase
    ramp = np.abs(np.fft.fftfreq(n)).astype(np.float32)
    shift = np.exp(-2j * np.pi * np.fft.fftfreq(n) * 3.25)
    w = ramp * shift
    # exact Hermitian symmetry (real DC/Nyquist bins), like irfft assumes
    w[0] = w[0].real
    w[n // 2] = w[n // 2].real
    got = np.asarray(
        FR.apply_freq_filter_real(
            x, w.real.astype(np.float32), w.imag.astype(np.float32)
        )
    )
    ref = np.real(np.fft.ifft(np.fft.fft(x, axis=-1) * w, axis=-1))
    np.testing.assert_allclose(got, ref, atol=RT_ATOL)
