"""FFTs on ``(re, im)`` float32 pairs, computed with ``jnp.fft``.

The Fourier pipeline (:mod:`tomobar_tpu.ops.usfft`) carries its spectra as
explicit ``(re, im)`` pairs, so that the gridding scatters stay two real
scatter-adds.  These helpers convert each pair to complex64 around one
``jnp.fft`` call (cuFFT on a GPU, pocketfft on the CPU); XLA fuses the
conversions into the neighbouring elementwise work.  Transforms run along
the LAST axis (2-D ones over the last two).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "fft_pairs",
    "ifft_pairs",
    "fft2_pairs",
    "ifft2_pairs",
    "apply_freq_filter_real",
]


def _complex(re: jnp.ndarray, im=None) -> jnp.ndarray:
    re = re.astype(jnp.float32)
    if im is None:
        return re.astype(jnp.complex64)
    return jax.lax.complex(re, im.astype(jnp.float32))


def _pair(z: jnp.ndarray):
    return jnp.real(z), jnp.imag(z)


def fft_pairs(re: jnp.ndarray, im=None):
    """Forward FFT along the last axis; ``im=None`` treats the input as
    real."""
    return _pair(jnp.fft.fft(_complex(re, im), axis=-1))


def ifft_pairs(re: jnp.ndarray, im: jnp.ndarray):
    """Inverse FFT along the last axis (includes the 1/n scale)."""
    return _pair(jnp.fft.ifft(_complex(re, im), axis=-1))


def fft2_pairs(re: jnp.ndarray, im=None):
    """Forward 2-D FFT over the last two axes."""
    return _pair(jnp.fft.fft2(_complex(re, im), axes=(-2, -1)))


def ifft2_pairs(re: jnp.ndarray, im: jnp.ndarray):
    """Inverse 2-D FFT over the last two axes (includes 1/(n1*n2))."""
    return _pair(jnp.fft.ifft2(_complex(re, im), axes=(-2, -1)))


def apply_freq_filter_real(
    x: jnp.ndarray, w_re: jnp.ndarray, w_im=None
) -> jnp.ndarray:
    """Filter real rows in the frequency domain: ``ifft(fft(x) * w).real``.

    ``x`` is (..., n) real; ``w_re``/``w_im`` is the FULL-length (n,)
    spectrum of a Hermitian-symmetric filter, so the result is real.  The
    DC and Nyquist bins must be real (what ``irfft`` assumes); only the
    rfft half of ``w`` is used.
    """
    n = x.shape[-1]
    half = n // 2 + 1
    w = _complex(w_re[:half], None if w_im is None else w_im[:half])
    spec = jnp.fft.rfft(x.astype(jnp.float32), axis=-1) * w
    return jnp.fft.irfft(spec, n, axis=-1).astype(x.dtype)
