"""Third-party-independent numerical cross-check of projector conventions.

scikit-image is not available in this environment, so the neutral
reference is stronger than another library's discretisation: the
CLOSED-FORM continuous Radon transform of ellipses (the same analytic
family TomoPhantom itself is built on).  An ellipse with value ``v``,
semi-axes ``(a, b)``, centre ``(x0, y0)`` and tilt ``phi`` projects at
angle ``theta`` onto detector coordinate ``s`` as

    p(s) = 2 v a b / w^2 * sqrt(w^2 - (s - s0)^2),
    w^2  = a^2 cos^2(theta-phi) + b^2 sin^2(theta-phi),
    s0   = x0 cos(theta) + y0 sin(theta),

with the framework's line convention ``x cos(theta) + y sin(theta) = s``,
``s = it - (det_x-1)/2 + cor`` (tomobar_tpu/geometry.py docstring).  These
tests pin, against exact continuous math:

* the angle direction and detector-axis orientation (sign-flipped
  conventions are rejected at >5% rel-L2 while the true one sits <1%),
* the CoR sign convention (detector shift by +cor),
* FBP's ABSOLUTE amplitude calibration (flat interior of a unit ellipse
  reconstructs to 1.0, not merely "correlates"),
* FOURIER_INV's documented 8/pi amplitude convention and its sub-pixel
  registration on the same grid as FBP (the half-pixel choice of
  ops/usfft.py:213-231): the un-shifted reconstruction must beat every
  1-pixel-shifted copy of itself.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tomobar_tpu import RecToolsDIR, RecToolsDIRCuPy
from tomobar_tpu.geometry import Geometry
from tomobar_tpu.ops.projector import radon_fp

N = 256
NANG = 360
# (value, semi_a, semi_b, x0, y0, phi) in pixel/world units
ELLIPSES = [
    (1.0, 80.0, 110.0, 0.0, 0.0, 0.0),
    (0.5, 30.0, 50.0, 40.0, -20.0, np.deg2rad(30.0)),
    (-0.3, 20.0, 20.0, -50.0, 35.0, 0.0),
]


def _grid(n):
    c = (n - 1) / 2.0
    iy, ix = np.mgrid[0:n, 0:n]
    return ix - c, iy - c


def _raster_phantom(n):
    x, y = _grid(n)
    ph = np.zeros((n, n), np.float32)
    for v, a, b, x0, y0, phi in ELLIPSES:
        xr = (x - x0) * np.cos(phi) + (y - y0) * np.sin(phi)
        yr = -(x - x0) * np.sin(phi) + (y - y0) * np.cos(phi)
        ph[(xr / a) ** 2 + (yr / b) ** 2 <= 1.0] += v
    return ph


def _analytic_sino(angles, n, cor=0.0):
    s = np.arange(n) - (n - 1) / 2.0 + cor
    out = np.zeros((len(angles), n))
    for k, th in enumerate(angles):
        for v, a, b, x0, y0, phi in ELLIPSES:
            s0 = x0 * np.cos(th) + y0 * np.sin(th)
            w2 = a**2 * np.cos(th - phi) ** 2 + b**2 * np.sin(th - phi) ** 2
            d2 = w2 - (s - s0) ** 2
            m = d2 > 0
            out[k, m] += 2.0 * v * a * b / w2 * np.sqrt(d2[m])
    return out.astype(np.float32)


@pytest.fixture(scope="module")
def angles():
    return np.linspace(0, np.pi, NANG, endpoint=False)


@pytest.fixture(scope="module")
def phantom():
    return _raster_phantom(N)


@pytest.fixture(scope="module")
def ana_sino(angles):
    return _analytic_sino(angles, N)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class TestForwardProjector:
    def test_fp_matches_continuous_radon(self, angles, phantom, ana_sino):
        geom = Geometry(
            detectors_x=N, detectors_y=None, angles=angles, recon_size=N
        )
        fp = np.asarray(radon_fp(jnp.asarray(phantom), geom))
        # measured 0.37% on CPU (discretisation of the rasterised edges)
        assert _rel_l2(fp, ana_sino) < 0.01

    def test_convention_flips_rejected(self, angles, phantom, ana_sino):
        """The match is convention-sensitive: negated angles or a mirrored
        detector axis degrade the fit by an order of magnitude (measured
        10.1% / 17.6% vs 0.37%)."""
        geom = Geometry(
            detectors_x=N, detectors_y=None, angles=angles, recon_size=N
        )
        fp = np.asarray(radon_fp(jnp.asarray(phantom), geom))
        assert _rel_l2(fp, _analytic_sino(-angles, N)) > 0.05
        assert _rel_l2(fp, ana_sino[:, ::-1]) > 0.05

    def test_cor_is_positive_detector_shift(self, angles, phantom):
        """cor shifts the sampled line to s = it - (n-1)/2 + cor
        (geometry.py docstring; reference supp/funcs.py:22-41 shifts the
        detector centre by +cor)."""
        cor = 3.5
        geom = Geometry(
            detectors_x=N, detectors_y=None, angles=angles, recon_size=N,
            center_rot_offset=cor,
        )
        fp = np.asarray(radon_fp(jnp.asarray(phantom), geom))
        assert _rel_l2(fp, _analytic_sino(angles, N, cor=cor)) < 0.01
        # and the wrong sign is clearly rejected
        assert _rel_l2(fp, _analytic_sino(angles, N, cor=-cor)) > 0.05


def _flat_interior_mask():
    """Interior of the big ellipse away from edges and the two inserts —
    ground-truth value exactly ELLIPSES[0].value there."""
    x, y = _grid(N)
    m = (x**2 / 40.0**2 + y**2 / 60.0**2) <= 1.0
    m &= ~(((x - 40.0) ** 2 / 35.0**2 + (y + 20.0) ** 2 / 55.0**2) <= 1.0)
    m &= ~(((x + 50.0) ** 2 / 25.0**2 + (y - 35.0) ** 2 / 25.0**2) <= 1.0)
    return m


def _incircle_mask():
    x, y = _grid(N)
    return np.hypot(x, y) < 0.45 * N


class TestFBPCalibration:
    def test_fbp_absolute_amplitude(self, angles, phantom, ana_sino):
        """FBP of the EXACT analytic sinogram reconstructs the flat
        interior of the unit ellipse to 1.0 within ~3% — an absolute
        calibration of filter normalisation x BP scaling that golden or
        correlation tests cannot provide (measured 1.013 on CPU)."""
        d = RecToolsDIR(N, 0, None, 0.0, angles, N)
        fbp = np.asarray(d.FBP(ana_sino, filter_type="ram-lak"))
        flat = float(fbp[_flat_interior_mask()].mean())
        assert abs(flat - 1.0) < 0.03, flat
        rc = _incircle_mask()
        rel = np.sqrt(np.mean((fbp[rc] - phantom[rc]) ** 2)) / np.sqrt(
            np.mean(phantom[rc] ** 2)
        )
        assert rel < 0.10, rel


class TestFourierInvRegistration:
    def test_amplitude_and_subpixel_registration(self, angles, phantom,
                                                 ana_sino):
        """FOURIER_INV output divided by its documented 8/pi convention
        must land on the phantom's absolute scale, and its registration on
        the FBP/iterative grid must be sub-pixel: the unshifted recon
        beats every 1-pixel-shifted copy of itself (pins the half-pixel
        correction of ops/usfft.py:213-231 against exact math)."""
        rt = RecToolsDIRCuPy(N, 0, 0, 0.0, angles, N)
        fi = np.asarray(rt.FOURIER_INV(jnp.asarray(ana_sino),
                                       filter_type="ramp"))
        fi = fi[0] if fi.ndim == 3 else fi
        scale = 8.0 / np.pi
        flat = float(fi[_flat_interior_mask()].mean()) / scale
        assert abs(flat - 1.0) < 0.06, flat
        rc = _incircle_mask()
        base = np.sqrt(np.mean((fi[rc] / scale - phantom[rc]) ** 2))
        for dy, dx in [(1, 0), (-1, 0), (0, 1), (0, -1)]:
            sh = np.roll(fi / scale, (dy, dx), axis=(0, 1))
            shifted = np.sqrt(np.mean((sh[rc] - phantom[rc]) ** 2))
            assert shifted > base, (dy, dx, shifted, base)
