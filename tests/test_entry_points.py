"""The compile-cache rule shared by every entry point, and chip_smoke.py's
refusal to run without a GPU."""

import os
import subprocess
import sys

import jax

from tomobar_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_follows_environment_variable(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_chip_smoke_refuses_cpu_host():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs 1 NVIDIA GPU" in out.stderr
