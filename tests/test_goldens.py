"""Frozen golden-value regressions on the fixed synthetic phantom.

The reference's core test philosophy is exact-shape + min/max/mean goldens
with tight rtol on fixed data (``tests/test_RecToolsIRCuPy.py:320-323``);
threshold-only tests cannot catch silent numeric drift between rounds.

One frozen table, ``GOLDEN_CPU`` (the XLA float32 path on the CPU).  The
GPU path computes the same operators (the Joseph kernels are the XLA
reference's operator, FFTs are cuFFT), so on the card the same table is
checked with ``RTOL_CARD``: float32 sums taken in another order (kernel
accumulation, scatter-add atomics in FOURIER_INV, cuFFT), amplified by
the iterative solvers.  Regenerate deliberately after an intentional
numeric change with::

    JAX_PLATFORMS=cpu python tests/test_goldens.py
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tomobar_tpu import RecToolsDIRCuPy, RecToolsIRCuPy

RTOL = 3e-4
RTOL_CARD = 2e-3

GOLDEN_CPU = {
    "lc_os5": 1102.98193359375,
    "landweber": (0.0, 0.3156959116458893, 0.10711159557104111),
    "sirt": (-0.08311305195093155, 1.1595118045806885, 0.1213618814945221),
    "cgls": (-0.24761369824409485, 1.347556471824646, 0.1218322142958641),
    "fista_os_tv": (0.0, 1.2763731479644775, 0.12191416323184967),
    "admm_rof": (-0.03473756089806557, 0.7040730118751526, 0.12001736462116241),
    "osem": (0.0, 676.2928466796875, 39.737606048583984),
    "fourier_inv_shepp": (-1.5269206762313843, 3.203871488571167, 0.2956569790840149),
    "fbp_device": (-0.4902627170085907, 2.0110180377960205, 0.06773578375577927),
}

def _stats(x):
    x = np.asarray(x)
    return float(x.min()), float(x.max()), float(x.mean())


def _check(name, rec, rtol=RTOL):
    got = _stats(rec)
    want = GOLDEN_CPU[name]
    for g, w, label in zip(got, want, ("min", "max", "mean")):
        assert g == pytest.approx(w, rel=rtol, abs=1e-7), (
            f"{name}.{label}: got {g!r}, golden {w!r}"
        )


@pytest.fixture(scope="module")
def gp(phantom3d, sino3d, angles180):
    data = {"projection_data": jnp.asarray(sino3d)}
    return dict(
        data=data,
        sino=sino3d,
        os5=RecToolsIRCuPy(64, 0, 4, 0.0, angles180, 64, OS_number=5),
        classic=RecToolsIRCuPy(64, 0, 4, 0.0, angles180, 64),
        direct=RecToolsDIRCuPy(64, 0, 4, 0.0, angles180, 64),
    )


_RUNS = {
    "landweber": lambda gp: gp["classic"].Landweber(
        gp["data"], {"iterations": 50}
    ),
    "sirt": lambda gp: gp["classic"].SIRT(gp["data"], {"iterations": 50}),
    "cgls": lambda gp: gp["classic"].CGLS(gp["data"], {"iterations": 10}),
    "fista_os_tv": lambda gp: gp["os5"].FISTA(
        gp["data"],
        {"iterations": 8, "nonnegativity": True},
        {"method": "PD_TV", "regul_param": 5e-4, "iterations": 30},
    ),
    "admm_rof": lambda gp: gp["os5"].ADMM(
        gp["data"],
        {"iterations": 3},
        {"method": "ROF_TV", "regul_param": 1e-3, "iterations": 40},
    ),
    "osem": lambda gp: gp["os5"].OSEM(gp["data"], {"iterations": 5}),
    "fourier_inv_shepp": lambda gp: gp["direct"].FOURIER_INV(
        jnp.asarray(gp["sino"]), filter_type="shepp"
    ),
    "fbp_device": lambda gp: gp["direct"].FBP(
        jnp.swapaxes(jnp.asarray(gp["sino"]), 0, 1)
    ),
}


class TestGoldens:
    def test_lipschitz(self, gp):
        lc = float(gp["os5"].powermethod(gp["data"]))
        assert lc == pytest.approx(GOLDEN_CPU["lc_os5"], rel=RTOL)

    def test_landweber(self, gp):
        _check("landweber", _RUNS["landweber"](gp))

    def test_sirt(self, gp):
        _check("sirt", _RUNS["sirt"](gp))

    def test_cgls(self, gp):
        _check("cgls", _RUNS["cgls"](gp))

    def test_fista_os_tv(self, gp):
        _check("fista_os_tv", _RUNS["fista_os_tv"](gp))

    def test_admm_rof(self, gp):
        _check("admm_rof", _RUNS["admm_rof"](gp))

    def test_osem(self, gp):
        _check("osem", _RUNS["osem"](gp))

    def test_fourier_inv(self, gp):
        _check("fourier_inv_shepp", _RUNS["fourier_inv_shepp"](gp))

    def test_fbp(self, gp):
        _check("fbp_device", _RUNS["fbp_device"](gp))


@pytest.mark.gpu
class TestGoldensOnCard:
    """The CPU table, reproduced on the GPU path within ``RTOL_CARD``."""

    def test_lipschitz(self, gp):
        lc = float(gp["os5"].powermethod(gp["data"]))
        assert lc == pytest.approx(GOLDEN_CPU["lc_os5"], rel=RTOL_CARD)

    @pytest.mark.parametrize("name", sorted(_RUNS))
    def test_golden(self, gp, name):
        _check(name, _RUNS[name](gp), rtol=RTOL_CARD)


class TestKLFidelity:
    """KL fidelity on Poisson-like pre-log counts (the reference's KL takes
    raw counts: res = 1 - counts/clip(Ax); data_fidelities.py:7-40)."""

    def test_kl_converges_on_counts(self, phantom3d, sino3d, angles180):
        """KL models the projections as Poisson means directly
        (grad = A^T(1 - b/Ax), so the minimiser satisfies Ax ~ b): feed
        Poisson-corrupted projections of a positive phantom and the KL
        reconstruction must recover it."""
        rng = np.random.default_rng(11)
        scale = 50.0  # mean counts per detector cell ~ 50 x sino values
        counts = rng.poisson(scale * np.asarray(sino3d)).astype(np.float32)
        rt = RecToolsIRCuPy(64, 0, 4, 0.0, angles180, 64, OS_number=5)
        # KL needs a strictly positive start (grad has b/Ax; from zeros the
        # first step is 1/clip(0) ~ 1e8 and diverges — same as the
        # reference, whose OSEM starts from ones for the same reason)
        x0 = 0.1 * np.ones((4, 64, 64), np.float32)
        rec = rt.FISTA(
            {
                "projection_data": jnp.asarray(counts / scale),
                "data_fidelity": "KL",
            },
            {"iterations": 15, "nonnegativity": True, "initialise": x0},
            {"method": "PD_TV", "regul_param": 5e-4, "iterations": 30},
        )
        rec = np.asarray(rec)
        ph = np.asarray(phantom3d)
        corr = np.corrcoef(rec.ravel(), ph.ravel())[0, 1]
        assert corr > 0.85, corr
        err = np.sqrt(np.mean((rec - ph) ** 2)) / np.sqrt(np.mean(ph**2))
        assert err < 0.5, err

    def test_kl_matches_reference_gradient_form(self, sino3d, angles180):
        """grad = A^T(1 - b/clip(Ax)) — zero when Ax == b exactly."""
        from tomobar_tpu.fidelity import grad_data_term
        from tomobar_tpu.geometry import Geometry
        from tomobar_tpu.ops.projector import Projector

        geom = Geometry(
            detectors_x=64, detectors_y=4, angles=angles180, recon_size=64
        )
        P = Projector(geom)
        x = jnp.ones((4, 64, 64), dtype=jnp.float32)
        b = P.fp(x)
        g = grad_data_term(P, x, b, fidelity="KL")
        assert float(jnp.abs(g).max()) < 1e-3


def _regenerate():
    """Compute the golden table for the current device and print it
    (paste into GOLDEN_CPU above)."""
    import conftest as _cf

    # replicate the conftest fixtures exactly (angles180 is 90 angles;
    # phantom slices scaled 0.8..1.2)
    angles180 = np.linspace(0.0, np.pi, 90, endpoint=False)
    sl = _cf.shepp_logan_slice(64)
    scale = np.linspace(0.8, 1.2, 4, dtype=np.float32)
    ph = (sl[None, :, :] * scale[:, None, None]).astype(np.float32)
    from tomobar_tpu.geometry import Geometry
    from tomobar_tpu.ops.projector import radon_fp

    geom = Geometry(detectors_x=64, detectors_y=4, angles=angles180,
                    recon_size=64)
    sino3d = np.asarray(radon_fp(jnp.asarray(ph), geom))
    data = {"projection_data": jnp.asarray(sino3d)}
    os5 = RecToolsIRCuPy(64, 0, 4, 0.0, angles180, 64, OS_number=5)
    classic = RecToolsIRCuPy(64, 0, 4, 0.0, angles180, 64)
    direct = RecToolsDIRCuPy(64, 0, 4, 0.0, angles180, 64)

    out = {"lc_os5": float(os5.powermethod(dict(data)))}
    out["landweber"] = _stats(classic.Landweber(dict(data), {"iterations": 50}))
    out["sirt"] = _stats(classic.SIRT(dict(data), {"iterations": 50}))
    out["cgls"] = _stats(classic.CGLS(dict(data), {"iterations": 10}))
    out["fista_os_tv"] = _stats(os5.FISTA(
        dict(data), {"iterations": 8, "nonnegativity": True},
        {"method": "PD_TV", "regul_param": 5e-4, "iterations": 30}))
    out["admm_rof"] = _stats(os5.ADMM(
        dict(data), {"iterations": 3},
        {"method": "ROF_TV", "regul_param": 1e-3, "iterations": 40}))
    out["osem"] = _stats(os5.OSEM(dict(data), {"iterations": 5}))
    out["fourier_inv_shepp"] = _stats(direct.FOURIER_INV(
        jnp.asarray(sino3d), filter_type="shepp"))
    out["fbp_device"] = _stats(direct.FBP(
        jnp.swapaxes(jnp.asarray(sino3d), 0, 1)))
    import jax

    print(f"# device: {jax.devices()[0]}")
    for k, v in out.items():
        print(f'    "{k}": {v!r},')


if __name__ == "__main__":
    _regenerate()
