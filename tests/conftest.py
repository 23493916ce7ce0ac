"""Test fixtures: synthetic phantom data (the reference's .npz blobs are not
in the mirror, so we generate our own — see SURVEY.md §4).

A plain pytest run is the CPU lane: JAX is held to the CPU with 8 virtual
devices, so the sharding tests run anywhere.  Tests marked ``gpu`` need an
NVIDIA GPU; they skip on the CPU lane and run inside ``chip_smoke.py``,
whose process has already opened the card and passes ``--on-card``.
"""

import os

import jax
import numpy as np
import pytest

from tomobar_tpu.utils.compile_cache import enable_compile_cache


def pytest_addoption(parser):
    parser.addoption(
        "--on-card", action="store_true",
        help="run inside a process that already uses the GPU "
        "(chip_smoke.py); leaves JAX's platform alone",
    )


def pytest_configure(config):
    if not config.getoption("--on-card"):
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless JAX's default device is a GPU."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU (run through chip_smoke.py)")


def shepp_logan_slice(n: int) -> np.ndarray:
    """A simple Shepp-Logan-like phantom slice (ellipse superposition)."""
    # (value, a, b, x0, y0, phi_deg)
    ellipses = [
        (1.0, 0.69, 0.92, 0.0, 0.0, 0.0),
        (-0.8, 0.6624, 0.874, 0.0, -0.0184, 0.0),
        (-0.2, 0.11, 0.31, 0.22, 0.0, -18.0),
        (-0.2, 0.16, 0.41, -0.22, 0.0, 18.0),
        (0.1, 0.21, 0.25, 0.0, 0.35, 0.0),
        (0.1, 0.046, 0.046, 0.0, 0.1, 0.0),
        (0.1, 0.046, 0.023, -0.08, -0.605, 0.0),
        (0.1, 0.023, 0.046, 0.06, -0.605, 0.0),
    ]
    y, x = np.mgrid[-1 : 1 : n * 1j, -1 : 1 : n * 1j]
    img = np.zeros((n, n), dtype=np.float32)
    for val, a, b, x0, y0, phi in ellipses:
        phi = np.deg2rad(phi)
        xr = (x - x0) * np.cos(phi) + (y - y0) * np.sin(phi)
        yr = -(x - x0) * np.sin(phi) + (y - y0) * np.cos(phi)
        img[(xr / a) ** 2 + (yr / b) ** 2 <= 1.0] += val
    return img


@pytest.fixture(scope="session")
def phantom2d():
    return shepp_logan_slice(64)


@pytest.fixture(scope="session")
def phantom3d():
    sl = shepp_logan_slice(64)
    scale = np.linspace(0.8, 1.2, 4, dtype=np.float32)
    return sl[None, :, :] * scale[:, None, None]


@pytest.fixture(scope="session")
def angles180():
    return np.linspace(0, np.pi, 90, endpoint=False)


@pytest.fixture(scope="session")
def sino2d(phantom2d, angles180):
    """Clean analytic-free sinogram produced by our own projector (used for
    solver convergence tests)."""
    import jax.numpy as jnp

    from tomobar_tpu.geometry import Geometry
    from tomobar_tpu.ops.projector import radon_fp

    geom = Geometry(
        detectors_x=phantom2d.shape[0],
        detectors_y=None,
        angles=angles180,
        recon_size=phantom2d.shape[0],
    )
    return np.asarray(radon_fp(jnp.asarray(phantom2d), geom))


@pytest.fixture(scope="session")
def sino3d(phantom3d, angles180):
    import jax.numpy as jnp

    from tomobar_tpu.geometry import Geometry
    from tomobar_tpu.ops.projector import radon_fp

    geom = Geometry(
        detectors_x=phantom3d.shape[1],
        detectors_y=phantom3d.shape[0],
        angles=angles180,
        recon_size=phantom3d.shape[1],
    )
    return np.asarray(radon_fp(jnp.asarray(phantom3d), geom))


def rmse(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


@pytest.fixture(scope="session")
def rmse_fn():
    return rmse
