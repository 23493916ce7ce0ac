"""Solver tests: convergence on self-consistent data, OS/non-OS, fidelities,
warm start, padding semantics (modelled on the reference's
tests/test_RecToolsIRCuPy.py coverage matrix, with RMSE-vs-phantom checks
the reference lacks)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tomobar_tpu import RecToolsIRCuPy


@pytest.fixture(scope="module")
def problem(phantom3d, sino3d, angles180):
    return dict(
        phantom=phantom3d,
        sino=sino3d,
        angles=angles180,
        N=phantom3d.shape[1],
        nz=phantom3d.shape[0],
    )


def rel_rmse(rec, ref):
    rec = np.asarray(rec, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.sqrt(np.mean((rec - ref) ** 2)) / np.sqrt(np.mean(ref**2)))


def make_tools(problem, os_number=None, pad=0):
    return RecToolsIRCuPy(
        DetectorsDimH=problem["N"],
        DetectorsDimH_pad=pad,
        DetectorsDimV=problem["nz"],
        CenterRotOffset=0.0,
        AnglesVec=problem["angles"],
        ObjSize=problem["N"],
        OS_number=os_number,
    )


class TestClassic:
    def test_power_method(self, problem):
        rt = make_tools(problem)
        lc = rt.powermethod({"projection_data": jnp.asarray(problem["sino"])})
        assert lc > 0
        # L must upper-bound ||A^T A|| growth: Landweber with tau < 2/L converges
        rt2 = make_tools(problem, os_number=5)
        lc_os = rt2.powermethod({"projection_data": jnp.asarray(problem["sino"])})
        assert 0 < lc_os < lc  # subset operator has smaller norm

    def test_cgls_converges(self, problem):
        rt = make_tools(problem)
        rec = rt.CGLS(
            {"projection_data": jnp.asarray(problem["sino"])},
            {"iterations": 30},
        )
        rec = np.asarray(rec)
        assert rec.shape == problem["phantom"].shape
        assert rel_rmse(rec, problem["phantom"]) < 0.17

    def test_sirt_runs(self, problem):
        rt = make_tools(problem)
        rec = np.asarray(
            rt.SIRT(
                {"projection_data": jnp.asarray(problem["sino"])},
                {"iterations": 30, "nonnegativity": True},
            )
        )
        assert np.isfinite(rec).all()
        assert rec.min() >= 0.0

    def test_landweber_reduces_residual(self, problem):
        rt = make_tools(problem)
        rec = np.asarray(
            rt.Landweber(
                {"projection_data": jnp.asarray(problem["sino"])},
                {"iterations": 50, "tau_step_lanweber": 1e-4},
            )
        )
        resid = np.asarray(rt._Ax(jnp.asarray(rec))) - problem["sino"]
        assert np.linalg.norm(resid) < np.linalg.norm(problem["sino"])


class TestFISTA:
    def test_fista_ls(self, problem):
        rt = make_tools(problem)
        rec = rt.FISTA(
            {"projection_data": jnp.asarray(problem["sino"])},
            {"iterations": 30, "nonnegativity": True},
        )
        assert rel_rmse(rec, problem["phantom"]) < 0.25

    def test_fista_os_tv(self, problem):
        rt = make_tools(problem, os_number=5)
        rec = rt.FISTA(
            {"projection_data": jnp.asarray(problem["sino"])},
            {"iterations": 10, "nonnegativity": True},
            {"method": "PD_TV", "regul_param": 0.0005, "iterations": 25},
        )
        assert rel_rmse(rec, problem["phantom"]) < 0.2

    def test_fista_pwls(self, problem):
        rt = make_tools(problem, os_number=5)
        rec = rt.FISTA(
            {
                "projection_data": jnp.asarray(problem["sino"]),
                "data_fidelity": "PWLS",
            },
            {"iterations": 20, "nonnegativity": True},
        )
        assert np.isfinite(np.asarray(rec)).all()
        assert rel_rmse(rec, problem["phantom"]) < 0.3

    def test_fista_warm_start(self, problem):
        rt = make_tools(problem, os_number=5)
        d = {"projection_data": jnp.asarray(problem["sino"])}
        cold = rt.FISTA(d, {"iterations": 3, "nonnegativity": True})
        warm = rt.FISTA(
            d, {"iterations": 3, "initialise": cold, "nonnegativity": True}
        )
        assert rel_rmse(warm, problem["phantom"]) < rel_rmse(
            cold, problem["phantom"]
        )

    def test_fista_padding_crop(self, problem):
        rt = make_tools(problem, os_number=5, pad=8)
        rec = rt.FISTA(
            {"projection_data": jnp.asarray(problem["sino"])},
            {"iterations": 5, "nonnegativity": True},
        )
        # padded grid reconstructed then cropped back to ObjSize
        assert np.asarray(rec).shape == problem["phantom"].shape

    def test_fista_2d_input(self, problem):
        rt = RecToolsIRCuPy(
            problem["N"], 0, None, 0.0, problem["angles"], problem["N"],
            OS_number=4,
        )
        sino2d = jnp.asarray(problem["sino"][0])  # (angles, detX)
        rec = rt.FISTA(
            {"projection_data": sino2d}, {"iterations": 5, "nonnegativity": True}
        )
        assert np.asarray(rec).shape == (1, problem["N"], problem["N"])


class TestADMM:
    def test_admm_os_tv_warm(self, problem):
        # production pattern: warm start + OS + few outer iterations
        # (Demos/RealData.py:228-235)
        rt5 = make_tools(problem, os_number=5)
        warm = rt5.FISTA(
            {"projection_data": jnp.asarray(problem["sino"])},
            {"iterations": 5, "nonnegativity": True},
        )
        rt = make_tools(problem, os_number=6)
        rec = rt.ADMM(
            {"projection_data": jnp.asarray(problem["sino"])},
            {"iterations": 3, "nonnegativity": True, "initialise": warm},
            {"method": "PD_TV", "regul_param": 0.0005, "iterations": 20},
        )
        assert rel_rmse(rec, problem["phantom"]) < 0.3

    def test_admm_no_regul(self, problem):
        rt = make_tools(problem)
        rec = rt.ADMM(
            {"projection_data": jnp.asarray(problem["sino"])},
            {"iterations": 5},
        )
        assert np.isfinite(np.asarray(rec)).all()


class TestOSEM:
    def test_osem_on_counts(self, problem):
        # OSEM expects non-negative (emission-like) data
        sino = np.clip(problem["sino"], 0, None)
        rt = make_tools(problem, os_number=5)
        rec = np.asarray(
            rt.OSEM({"projection_data": jnp.asarray(sino)}, {"iterations": 4})
        )
        assert np.isfinite(rec).all()
        assert rec.min() >= 0.0

    def test_osem_divide_mode_converges(self, problem):
        """osem_normalisation="divide" is the textbook EM update (the
        default "reference" mode preserves the reference's multiply-by-
        sensitivity quirk, methodsIR_CuPy.py:654, whose scale diverges on
        generic emission data)."""
        sino = np.clip(problem["sino"], 0, None)
        rt = make_tools(problem, os_number=5)
        rec = np.asarray(
            rt.OSEM(
                {"projection_data": jnp.asarray(sino)},
                {"iterations": 10, "osem_normalisation": "divide",
                 "recon_mask_radius": 2.0},
            )
        )
        assert np.isfinite(rec).all() and rec.min() >= 0.0
        # textbook EM on clean data converges toward the phantom
        assert rel_rmse(rec, problem["phantom"]) < 0.5
        # and the ratio-projection consistency improves: Ax ~ b in scale
        fp = np.asarray(rt.Atools.fp(jnp.asarray(rec)))
        scale = float(fp.sum() / np.maximum(sino.sum(), 1e-9))
        assert 0.8 < scale < 1.2, scale

    def test_osem_bad_mode_rejected(self, problem):
        rt = make_tools(problem, os_number=5)
        with pytest.raises(ValueError):
            rt.OSEM(
                {"projection_data": jnp.asarray(
                    np.clip(problem["sino"], 0, None))},
                {"iterations": 2, "osem_normalisation": "nope"},
            )


class TestErrors:
    def test_os_rejected_for_classic(self, problem):
        rt = make_tools(problem, os_number=4)
        with pytest.raises(NameError):
            rt.SIRT({"projection_data": jnp.asarray(problem["sino"])})

    def test_missing_data(self, problem):
        rt = make_tools(problem)
        with pytest.raises(NameError):
            rt.FISTA({})

    def test_bad_fidelity(self, problem):
        rt = make_tools(problem)
        with pytest.raises(ValueError):
            rt.FISTA(
                {
                    "projection_data": jnp.asarray(problem["sino"]),
                    "data_fidelity": "XX",
                }
            )


class TestRobustFidelities:
    """Legacy RecToolsIR surface: SWLS stripe weighting + Huber/Student-t
    (SURVEY.md §2.4; behavioural reference
    Demos/methods_IR_legacy/DemoFISTA_artifacts2D.py:222-265)."""

    def _striped_sino(self, problem):
        sino = problem["sino"].copy()
        sino[:, :, 20] += 3.0  # a stuck detector column -> ring artifact
        return sino

    def test_swls_suppresses_stripe(self, problem):
        sino = self._striped_sino(problem)
        rt = make_tools(problem, os_number=5)
        ls = np.asarray(
            rt.FISTA(
                {"projection_data": jnp.asarray(sino)},
                {"iterations": 10, "nonnegativity": True},
            )
        )
        rt2 = make_tools(problem, os_number=5)
        swls = np.asarray(
            rt2.FISTA(
                {
                    "projection_data": jnp.asarray(sino),
                    "data_fidelity": "SWLS",
                    "beta_SWLS": 0.1,
                },
                {"iterations": 10, "nonnegativity": True},
            )
        )
        # SWLS must reduce the error caused by the stripe
        assert rel_rmse(swls, problem["phantom"]) < (
            rel_rmse(ls, problem["phantom"])
        )

    def test_huber_suppresses_zinger(self, problem):
        sino = problem["sino"].copy()
        sino[:, 13, 30] += 50.0  # zinger
        rt = make_tools(problem, os_number=5)
        ls = np.asarray(
            rt.FISTA(
                {"projection_data": jnp.asarray(sino)},
                {"iterations": 10, "nonnegativity": True},
            )
        )
        rt2 = make_tools(problem, os_number=5)
        hub = np.asarray(
            rt2.FISTA(
                {
                    "projection_data": jnp.asarray(sino),
                    "huber_threshold": 1.0,
                },
                {"iterations": 10, "nonnegativity": True},
            )
        )
        assert rel_rmse(hub, problem["phantom"]) < rel_rmse(
            ls, problem["phantom"]
        )

    def test_studentst_runs(self, problem):
        rt = make_tools(problem, os_number=5)
        rec = rt.FISTA(
            {
                "projection_data": jnp.asarray(problem["sino"]),
                "studentst_threshold": 2.0,
            },
            {"iterations": 5, "nonnegativity": True},
        )
        assert np.isfinite(np.asarray(rec)).all()


class TestLipschitzCache:
    def test_one_powermethod_across_two_solves(self, problem, monkeypatch):
        """L depends only on (geometry, OS), so repeat solves on the same
        instance must run the power method exactly once (the reference
        recomputes the 15-iteration power method per call,
        methodsIR_CuPy.py:371-372 — ~35% of a production FISTA run)."""
        from tomobar_tpu.models import iterative as it_mod

        calls = []
        real_pm = it_mod.solvers.power_method

        def counting_pm(*args, **kwargs):
            calls.append(1)
            return real_pm(*args, **kwargs)

        monkeypatch.setattr(it_mod.solvers, "power_method", counting_pm)
        rt = make_tools(problem, os_number=4)
        d = {"projection_data": jnp.asarray(problem["sino"])}
        r1 = rt.FISTA(d, {"iterations": 2})
        assert len(calls) == 1
        r2 = rt.FISTA(d, {"iterations": 2})
        assert len(calls) == 1  # cached L reused
        np.testing.assert_allclose(np.asarray(r1), np.asarray(r2),
                                   rtol=1e-6, atol=1e-7)
        rt.ADMM(d, {"iterations": 2}, None)
        assert len(calls) == 1  # shared across solver types too
        # explicit user call recomputes (reference parity) + refreshes cache
        rt.powermethod({"projection_data": d["projection_data"]})
        assert len(calls) == 2
        rt.FISTA(d, {"iterations": 2})
        assert len(calls) == 2
        # user-supplied lipschitz_const bypasses the power method entirely
        rt2 = make_tools(problem, os_number=4)
        rt2.FISTA(d, {"iterations": 2, "lipschitz_const": 5000.0})
        assert len(calls) == 2


class TestSWLSStrictLargeN:
    def test_swls_beats_ls_at_larger_n(self):
        """Strict swls < ls stripe-suppression property at N=128, where the
        SWLS advantage is clear of the rounding noise of the operator."""
        from conftest import shepp_logan_slice
        from tomobar_tpu.geometry import Geometry
        from tomobar_tpu.ops.projector import radon_fp

        n, nz = 128, 2
        angles = np.linspace(0, np.pi, 180, endpoint=False)
        phantom = shepp_logan_slice(n)[None] * np.asarray(
            [0.9, 1.1], dtype=np.float32
        )[:, None, None]
        geom = Geometry(
            detectors_x=n, detectors_y=nz, angles=angles, recon_size=n
        )
        sino = np.array(radon_fp(jnp.asarray(phantom), geom))
        # three strong stuck columns: a clear SWLS advantage at larger N
        for col, amp in ((40, 6.0), (71, 4.0), (90, 5.0)):
            sino[:, :, col] += amp

        def recon(extra_data):
            rt = RecToolsIRCuPy(
                DetectorsDimH=n, DetectorsDimH_pad=0, DetectorsDimV=nz,
                CenterRotOffset=0.0, AnglesVec=angles, ObjSize=n,
                OS_number=5,
            )
            d = {"projection_data": jnp.asarray(sino), **extra_data}
            return np.asarray(
                rt.FISTA(d, {"iterations": 10, "nonnegativity": True})
            )

        ls = recon({})
        swls = recon({"data_fidelity": "SWLS", "beta_SWLS": 0.1})
        assert rel_rmse(swls, phantom) < rel_rmse(ls, phantom)


class TestEarlyStopping:
    def test_tolerance_stops_early(self, problem):
        """tolerance>0 enables real early stopping (fixed reference quirk:
        the parameter was accepted but ignored, dicts.py:153-155)."""
        rt = make_tools(problem, os_number=5)
        d = {"projection_data": jnp.asarray(problem["sino"])}
        loose = rt.FISTA(d, {"iterations": 50, "tolerance": 0.2,
                             "nonnegativity": True})
        rt2 = make_tools(problem, os_number=5)
        full = rt2.FISTA(d, {"iterations": 50, "nonnegativity": True})
        # the early-stopped run must have converged less far
        assert rel_rmse(loose, problem["phantom"]) > rel_rmse(
            full, problem["phantom"]
        )
        # with tolerance=0 behaviour is identical to the reference default
        rt3 = make_tools(problem, os_number=5)
        default = rt3.FISTA(d, {"iterations": 50, "tolerance": 0.0,
                                "nonnegativity": True})
        np.testing.assert_allclose(np.asarray(default), np.asarray(full),
                                   rtol=1e-6, atol=1e-7)


class TestVerbose:
    def test_fista_verbose_prints_progress(self, problem, capsys):
        """verbose=True prints per-outer-iteration progress host-side (the
        reference gates prints in ADMM, methodsIR_CuPy.py:568-576; here it
        works for all OS solvers) and returns the same result as silent."""
        rt = make_tools(problem, os_number=4)
        d = {"projection_data": jnp.asarray(problem["sino"])}
        quiet = rt.FISTA(d, {"iterations": 3, "verbose": False, "lipschitz_const": 5000.0})
        loud = rt.FISTA(d, {"iterations": 3, "verbose": True, "lipschitz_const": 5000.0})
        out = capsys.readouterr().out
        assert out.count("FISTA iteration") == 3
        np.testing.assert_allclose(
            np.asarray(loud), np.asarray(quiet), rtol=1e-5, atol=1e-6
        )

    def test_admm_verbose_and_tolerance(self, problem, capsys):
        rt = make_tools(problem, os_number=4)
        d = {"projection_data": jnp.asarray(problem["sino"])}
        rt.ADMM(d, {"iterations": 30, "verbose": True, "tolerance": 0.05,
                    "lipschitz_const": 5000.0}, None)
        out = capsys.readouterr().out
        n_lines = out.count("ADMM iteration")
        assert 1 <= n_lines < 30, out  # early stop actually triggered
        assert "tolerance reached" in out

    def test_verbose_step_cache_reused(self, problem, capsys):
        """Repeat verbose calls with identical parameters reuse the
        compiled outer step instead of re-jitting per call; different parameters get their own cache entry."""
        rt = make_tools(problem, os_number=4)
        d = {"projection_data": jnp.asarray(problem["sino"])}
        a = {"iterations": 2, "verbose": True, "lipschitz_const": 5000.0}
        r1 = rt.FISTA(d, dict(a))
        assert len(rt._verbose_step_cache) == 1
        step1 = next(iter(rt._verbose_step_cache.values()))
        r2 = rt.FISTA(d, dict(a))
        assert len(rt._verbose_step_cache) == 1
        assert next(iter(rt._verbose_step_cache.values())) is step1
        np.testing.assert_allclose(np.asarray(r2), np.asarray(r1),
                                   rtol=1e-6, atol=1e-7)
        rt.FISTA(d, dict(a, lipschitz_const=4000.0))
        assert len(rt._verbose_step_cache) == 2
        capsys.readouterr()

    def test_verbose_step_cache_numpy_scalar_key(self, problem, capsys):
        """np.float32 parameters must key the cache like their Python-float
        value, not fall out of the key (advisor r4: two verbose calls
        differing only in an np.float32 lipschitz_const hashed identically
        and silently reused the stale compiled step)."""
        rt = make_tools(problem, os_number=4)
        d = {"projection_data": jnp.asarray(problem["sino"])}
        a = {"iterations": 2, "verbose": True}
        r1 = rt.FISTA(d, dict(a, lipschitz_const=np.float32(5000.0)))
        assert len(rt._verbose_step_cache) == 1
        r2 = rt.FISTA(d, dict(a, lipschitz_const=np.float32(500.0)))
        assert len(rt._verbose_step_cache) == 2  # distinct compiled steps
        assert not np.allclose(np.asarray(r1), np.asarray(r2))
        # np scalar and Python float of equal value share one entry
        rt.FISTA(d, dict(a, lipschitz_const=5000.0))
        assert len(rt._verbose_step_cache) == 2
        capsys.readouterr()

    def test_verbose_step_cache_array_param_key(self, problem, capsys):
        """Array-valued regularisation entries (e.g. NLTV weights) must
        contribute a content digest to the cache key (advisor r4)."""
        rt = make_tools(problem, os_number=4)
        d = {"projection_data": jnp.asarray(problem["sino"])}
        a = {"iterations": 2, "verbose": True, "lipschitz_const": 5000.0}
        r = {"method": "ROF_TV", "regul_param": 0.0005, "iterations": 10}
        key1 = rt._step_key("FISTA", d, a, r)
        key2 = rt._step_key(
            "FISTA", d, a, dict(r, some_weights=np.ones((3, 3), np.float32))
        )
        key3 = rt._step_key(
            "FISTA", d, a, dict(r, some_weights=np.zeros((3, 3), np.float32))
        )
        assert key1 is not None and key2 is not None and key3 is not None
        assert len({key1, key2, key3}) == 3
        # unrecognised types disable caching instead of corrupting the key
        assert rt._step_key("FISTA", d, a, dict(r, cb=lambda x: x)) is None
        capsys.readouterr()

    def test_admm_tolerance_stops_early_silent(self, problem):
        """ADMM honours tolerance inside jit too (device while_loop)."""
        rt = make_tools(problem, os_number=4)
        d = {"projection_data": jnp.asarray(problem["sino"])}
        a = rt.ADMM(d, {"iterations": 30, "tolerance": 0.05,
                        "lipschitz_const": 5000.0}, None)
        b = rt.ADMM(d, {"iterations": 30, "verbose": True, "tolerance": 0.05,
                        "lipschitz_const": 5000.0}, None)
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5
        )
