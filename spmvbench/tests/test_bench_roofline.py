"""The roofline's operations and bytes against sums by hand."""

import pytest

from spmvbench import roofline


def test_bytes_one_vector():
    # 8 B a nonzero, a 4 B row pointer a row, x and y once
    assert roofline.call_bytes(10, 20, 100) == 800 + 40 + 80 + 40
    # y_in read once more
    assert roofline.call_bytes(10, 20, 100, y_in=True) == 800 + 40 + 80 + 80


def test_bytes_batch_and_flops():
    assert roofline.call_bytes(10, 20, 100, batch=64) == \
        800 + 40 + 64 * (80 + 40)
    assert roofline.call_flops(10, 100) == 220
    assert roofline.call_flops(10, 100, batch=64) == 64 * 220


def test_least_time_takes_the_larger_bound():
    h100 = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    # Flan_1565 at one vector: bytes bound, 932 MB over 3.35 TB/s
    t = roofline.least_seconds(h100, 1_564_794, 1_564_794, 114_165_372)
    assert t == pytest.approx(
        (8 * 114_165_372 + 12 * 1_564_794) / 3.35e12)
    assert t == pytest.approx(0.278e-3, rel=0.01)
    # a dense-ish case where the operations bound
    fat = {"hbm_bytes_per_s": 1e15, "fp32_flops_per_s": 1e9}
    assert roofline.least_seconds(fat, 10, 10, 100) == pytest.approx(220e-9)
    assert roofline.peaks_for("cpu") is None
