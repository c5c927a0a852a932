"""Busy time, call attribution and idle gaps from a Chrome trace."""

import pytest

from spmvbench.trace import Trace


def _x(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


EVENTS = [
    _x("user_annotation", "spmvbench.window", 0, 100),
    _x("user_annotation", "spmvbench.solve", 1, 98),
    _x("user_annotation", "spmvbench.run", 2, 10),
    _x("cuda_runtime", "cudaLaunchKernel", 3, 1, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=2),
    _x("user_annotation", "spmvbench.update", 12, 5),
    _x("cuda_runtime", "cudaLaunchKernel", 13, 1, corr=3),
    _x("user_annotation", "spmvbench.sync", 20, 79),
    _x("kernel", "b4", 10, 30, corr=1),
    _x("kernel", "fill", 35, 10, corr=2),  # overlaps b4: counts once busy
    _x("kernel", "norm", 50, 5, corr=3),
    _x("kernel", "before", -20, 10, corr=9),  # outside the window
]


def test_busy_is_the_union_inside_the_window():
    tr = Trace(EVENTS)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx((45 - 10 + 5) * 1e-6)


def test_call_device_time_by_launch_inside_the_span():
    tr = Trace(EVENTS)
    device_s, calls = tr.call_device_s("spmvbench.run")
    assert calls == 1 and device_s == pytest.approx(40e-6)
    assert tr.call_device_s("spmvbench.update")[0] == pytest.approx(5e-6)


def test_breakdown():
    tr = Trace(EVENTS)
    ops = dict(tr.top_device_ops())
    assert ops["b4"] == pytest.approx(30e-6) and "before" not in ops
    gaps = dict(tr.idle_gaps())
    # 0-10 opens in run (at 0 only the window is open: outside spans),
    # 45-50 and 55-100 in sync
    assert gaps["sync"] == pytest.approx(50e-6)
    assert gaps["outside spans"] == pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx(60e-6)
