"""Device-memory estimation from compiled HLO — the equivalent of
the reference's ``DeviceMemStack`` dry-run allocator
(``tomobar/supp/memory_estimator_helpers.py`` + the ``*_estimator`` shadow
methods of ``methodsDIR_CuPy.py``).

Instead of replaying malloc/free sequences by hand, we lower + compile the
actual jitted pipeline with abstract inputs (no data, no execution) and read
XLA's own memory analysis.  This is exact for the compiled program rather
than a hand-maintained model, and is the figure HTTomo-style pipelines need
for slab-size planning.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp

__all__ = ["estimate_memory", "estimate_fourier_inv_memory", "DeviceMemStack"]


def estimate_memory(fn: Callable, *example_args, **example_kwargs) -> Dict[str, int]:
    """Compile ``fn`` for the given example shapes and return XLA's memory
    analysis in bytes.

    Returns keys: argument, output, temp, generated_code, alias, total.
    """
    shaped = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)),
        (example_args, example_kwargs),
    )
    s_args, s_kwargs = shaped
    compiled = jax.jit(fn).lower(*s_args, **s_kwargs).compile()
    m = compiled.memory_analysis()
    out = {
        "argument": int(m.argument_size_in_bytes),
        "output": int(m.output_size_in_bytes),
        "temp": int(m.temp_size_in_bytes),
        "generated_code": int(m.generated_code_size_in_bytes),
        "alias": int(m.alias_size_in_bytes),
    }
    out["total"] = (
        out["argument"] + out["output"] + out["temp"] + out["generated_code"]
        - out["alias"]
    )
    return out


def estimate_fourier_inv_memory(
    model, data_shape: Tuple[int, int, int], per_stage: bool = False, **kwargs
) -> Dict[str, int]:
    """Peak-memory estimate for ``FOURIER_INV`` on a (detY, angles, detX)
    input of the given shape — the use case the reference serves with its
    shape-instead-of-array dry-run mode (``methodsDIR_CuPy.py:253-258``).

    With ``per_stage=True`` each pipeline stage (filter / pack+fft1d /
    grid / ifft2 / unpad) is additionally compiled on its own and
    reported under ``"stages"`` with a ``"stage_peak"`` summary — the
    equivalent of the reference's paired per-stage ``*_estimator``
    methods (``methodsDIR_CuPy.py:547-989``), attributing WHICH stage
    sets the high-water mark that the chunk heuristic
    (``ops/usfft.py:_fourier_inv_memory_chunks``) plans against.  Stage
    attribution reflects the current backend's compiled path and the
    unchunked pipeline."""
    from tomobar_tpu.ops.usfft import fourier_inv

    def run(data):
        return fourier_inv(model, data, **kwargs)

    example = jax.ShapeDtypeStruct(data_shape, jnp.float32)
    out_shape = jax.eval_shape(run, example).shape
    compiled = jax.jit(run).lower(example).compile()
    m = compiled.memory_analysis()
    res = {
        "argument": int(m.argument_size_in_bytes),
        "output": int(m.output_size_in_bytes),
        "temp": int(m.temp_size_in_bytes),
        "total": int(
            m.argument_size_in_bytes
            + m.output_size_in_bytes
            + m.temp_size_in_bytes
        ),
        "output_shape": tuple(out_shape),
    }
    if per_stage:
        res["stages"] = _fourier_inv_stage_memory(model, data_shape, **kwargs)
        res["stage_peak"] = max(
            s["total"] for s in res["stages"].values()
        )
        res["stage_peak_name"] = max(
            res["stages"], key=lambda k: res["stages"][k]["total"]
        )
    return res


def _fourier_inv_stage_memory(
    model, data_shape: Tuple[int, int, int], **kwargs
) -> Dict[str, Dict[str, int]]:
    """Compile each FOURIER_INV stage separately (shape-only) and return
    XLA's memory analysis per stage.  Parameter derivation mirrors
    ``ops/usfft.fourier_inv`` for the default (unchunked) path."""
    import math

    import numpy as np

    from tomobar_tpu.ops import usfft as U
    from tomobar_tpu.ops.fft_real import fft_pairs

    nz, nproj, data_n = data_shape
    nz += nz % 2
    data_n += data_n % 2
    n = data_n + model.geom.detectors_x_pad * 2 + 2 * kwargs.get("padding", 0)
    eps = 1e-4
    mu = -np.log(eps) / (2 * n * n)
    theta = -np.asarray(model.geom.angles, dtype=np.float64)
    filter_type = kwargs.get("filter_type") or "shepp"
    cutoff = kwargs.get("cutoff_freq") or 1.0
    rot = float(np.mean(model.geom.cor_horizontal)) + 0.5
    recon_size = model.recon_size
    pairs = nz // 2
    two_n = 2 * n

    sino = jnp.zeros(1, jnp.float32)  # placeholder; shapes only below
    data_s = jax.ShapeDtypeStruct((nz, nproj, data_n), jnp.float32)
    filt_s = jax.ShapeDtypeStruct((nz, nproj, n), jnp.float32)
    spec_s = jax.ShapeDtypeStruct((pairs, nproj, n), jnp.float32)
    grid_s = jax.ShapeDtypeStruct((pairs, two_n, two_n), jnp.float32)

    stages = {
        "filter": (
            lambda d: U._fbp_filter_stage(d, data_n, n, filter_type, cutoff, rot),
            (data_s,),
        ),
        "fft1d": (lambda f: fft_pairs(*U._pack_pairs(f)), (filt_s,)),
        "grid": (
            lambda r, i: U.usfft_grid(r, i, n, theta, eps),
            (spec_s, spec_s),
        ),
        "ifft2": (
            lambda r, i: U._ifft2_centered(r, i, n),
            (grid_s, grid_s),
        ),
        "unpad": (
            lambda r, i: U._unpad_mul_phi(
                r, i, n, nproj, nz, False, False, recon_size, mu
            ),
            (grid_s, grid_s),
        ),
    }
    out = {}
    for name, (fn, shapes) in stages.items():
        compiled = jax.jit(fn).lower(*shapes).compile()
        m = compiled.memory_analysis()
        out[name] = {
            "argument": int(m.argument_size_in_bytes),
            "output": int(m.output_size_in_bytes),
            "temp": int(m.temp_size_in_bytes),
            "total": int(
                m.argument_size_in_bytes
                + m.output_size_in_bytes
                + m.temp_size_in_bytes
            ),
        }
    return out


class DeviceMemStack:
    """API-compatible shim of the reference's simulated allocator
    (``memory_estimator_helpers.py:4-44``) for user code that used it as a
    context manager; tracks 512-byte-rounded malloc/free high-water marks."""

    ALLOCATION_UNIT_SIZE = 512
    _instance = None
    _stack_count = 0

    def __enter__(self):
        if DeviceMemStack._stack_count == 0:
            DeviceMemStack._instance = self
        DeviceMemStack._stack_count += 1
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        DeviceMemStack._stack_count -= 1
        if DeviceMemStack._stack_count == 0:
            DeviceMemStack._instance = None

    @classmethod
    def instance(cls):
        return cls._instance

    def __init__(self) -> None:
        self.allocations = []
        self.current = 0
        self.highwater = 0

    def _round_up(self, size: int) -> int:
        unit = self.ALLOCATION_UNIT_SIZE
        return (size + unit - 1) // unit * unit

    def malloc(self, byte_count: int) -> None:
        self.allocations.append(byte_count)
        self.current += self._round_up(byte_count)
        self.highwater = max(self.current, self.highwater)

    def free(self, byte_count: int) -> None:
        assert byte_count in self.allocations
        self.allocations.remove(byte_count)
        self.current -= self._round_up(byte_count)
        assert self.current >= 0
