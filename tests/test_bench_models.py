"""Roofline-report sanity: peaks come from a table keyed by the device's
``device_kind`` (an unknown kind is an error), no reported share may
exceed 1.0 (a larger one means the work model is wrong, and raises), and
no rate is derived from a ~0 ms timing."""

import pytest

from tomobar_tpu.bench.breakdown import (
    _MIN_RATE_DT,
    PEAKS,
    peaks,
    pd_tv_bytes,
    stage_report,
)

H100 = "NVIDIA H100 80GB HBM3"


def test_peak_table_h100_and_unknown_kind():
    pk = peaks(H100)
    assert pk["mem_bytes_s"] == 3.35e12
    assert pk["fp32_flops"] == 67e12
    assert pk["bf16_flops"] == 989e12
    with pytest.raises(KeyError, match="no published peaks"):
        peaks("some other accelerator")
    assert set(PEAKS) == {H100}


def test_normal_stage_within_bounds(capsys):
    pk = peaks(H100)
    # 10 ms doing half the peak's worth of flops -> share 0.5
    rec = stage_report("half-peak", 1e-2, pk, flops=0.5 * pk["fp32_flops"] * 1e-2)
    assert abs(rec["fp32_util"] - 0.5) < 1e-6
    capsys.readouterr()


def test_impossible_flop_model_raises(capsys):
    pk = peaks(H100)
    with pytest.raises(ValueError, match="work model is wrong"):
        stage_report("broken-model", 1e-2, pk, flops=3.0 * pk["fp32_flops"] * 1e-2)
    capsys.readouterr()


def test_impossible_bandwidth_model_raises(capsys):
    pk = peaks(H100)
    rec = stage_report(
        "membound", 1e-3, pk, bytes_moved=0.25 * pk["mem_bytes_s"] * 1e-3
    )
    assert abs(rec["mem_util"] - 0.25) < 1e-6
    with pytest.raises(ValueError, match="mem_util"):
        stage_report(
            "membound", 1e-3, pk, bytes_moved=10.0 * pk["mem_bytes_s"] * 1e-3
        )
    capsys.readouterr()


def test_zero_ms_stage_reports_no_rates(capsys):
    rec = stage_report("instant", 1e-7, peaks(H100), flops=1e9, bytes_moved=1e9)
    assert "gflops" not in rec and "mem_gbs" not in rec
    assert "fp32_util" not in rec and "mem_util" not in rec
    assert rec["below_timer_resolution"] is True
    assert rec["ms"] < _MIN_RATE_DT * 1e3
    # the PD-TV traffic model at the flagship slab: 9 float32 moves per
    # voxel per iteration, ~1.9 GB
    assert abs(pd_tv_bytes(8, 2560, 2560, 1) - 1.887e9) < 1e6
    capsys.readouterr()
