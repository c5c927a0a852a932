"""The port's observability: tracer spans, the profiler trace and the
power monitor's plumbing (mirrors of tests/test_trace.py), on the CPU; the
card's power reading and device events are in tests/test_torch_cuda.py."""

import json
import math
import subprocess
import time

import numpy as np
import pytest
import torch

from hispmv_tpu_torch import SpmvHandle
from hispmv_tpu_torch.formats.synth import random_coo
from hispmv_tpu_torch.utils import trace
from hispmv_tpu_torch.utils.trace import PowerMonitor, Tracer, profile_trace


def test_tracer_spans():
    tr = Tracer()
    with tr.span("a"):
        time.sleep(0.01)
    with tr.span("a"):
        pass
    with tr.span("b"):
        pass
    assert tr.counts["a"] == 2 and tr.counts["b"] == 1
    assert tr.segments["a"] >= 0.01
    assert "a" in tr.report()


def test_tracer_counts_a_span_that_raises():
    tr = Tracer()
    with pytest.raises(ValueError):
        with tr.span("bad"):
            raise ValueError("x")
    assert tr.counts["bad"] == 1
    lines = tr.report().splitlines()
    assert lines[0].split() == ["segment", "total_s", "calls"]
    assert lines[1].split()[0] == "bad" and lines[1].split()[2] == "1"


def test_power_monitor_plumbing():
    pm = PowerMonitor(interval_s=0.05, device="cpu")
    pm.start()
    time.sleep(0.2)
    pm.stop()
    assert len(pm.samples) >= 2
    # no power counter on the CPU: watts are NaN by contract
    assert math.isnan(pm.avg_watts) and math.isnan(pm.max_watts)
    assert math.isnan(pm.avg_bytes_in_use)
    assert all(math.isnan(s.watts) for s in pm.samples)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    coo = random_coo(200, 300, 2000, seed=1)
    h = SpmvHandle(coo, format="block", device="cpu")
    x = np.random.default_rng(2).standard_normal(300).astype(np.float32)
    with profile_trace(str(tmp_path / "traces"), device="cpu") as tr:
        assert tr.path is None
        for _ in range(3):
            h.run(x)
    assert tr.path is not None and tr.path.startswith(str(tmp_path))
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)  # CPU ops were recorded
    assert tr.profile is not None and tr.device_us == 0.0


def _no_card_yet_cuda(monkeypatch):
    """Let a monitor be made for cuda:0 on a machine without a card."""
    monkeypatch.setattr(trace, "resolve_device",
                        lambda d: torch.device("cuda", 0))


@pytest.mark.parametrize("error", [
    FileNotFoundError("nvidia-smi"),
    subprocess.CalledProcessError(9, "nvidia-smi"),
    subprocess.TimeoutExpired("nvidia-smi", 30),
])
def test_power_monitor_raises_without_nvidia_smi(monkeypatch, error):
    _no_card_yet_cuda(monkeypatch)

    def run(*a, **k):
        raise error
    monkeypatch.setattr(trace.subprocess, "run", run)
    pm = PowerMonitor(interval_s=0.05, device="cuda")
    with pytest.raises(RuntimeError, match="no power reading"):
        pm.start()


@pytest.mark.parametrize("stdout", ["", "[N/A]\n", "Not Supported\n"])
def test_power_monitor_raises_on_no_number(monkeypatch, stdout):
    _no_card_yet_cuda(monkeypatch)
    monkeypatch.setattr(trace.subprocess, "run", lambda *a, **k:
                        subprocess.CompletedProcess(a, 0, stdout, ""))
    with pytest.raises(RuntimeError, match="no power reading"):
        PowerMonitor(device="cuda").start()


def test_power_monitor_reads_the_card_it_names(monkeypatch):
    """The query, the index (through CUDA_VISIBLE_DEVICES) and the watts;
    a sample that fails later raises from ``stop()``."""
    monkeypatch.setattr(trace, "resolve_device",
                        lambda d: torch.device("cuda", 1))
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    monkeypatch.setattr(trace.torch.cuda, "memory_allocated",
                        lambda dev: 1 << 20)
    seen, fail = [], []

    def run(cmd, **k):
        seen.append(cmd)
        if fail:
            raise FileNotFoundError(cmd[0])
        return subprocess.CompletedProcess(cmd, 0, "312.45\n", "")
    monkeypatch.setattr(trace.subprocess, "run", run)
    pm = PowerMonitor(interval_s=0.02, device="cuda")
    pm.start()
    time.sleep(0.1)
    fail.append(1)
    time.sleep(0.1)
    with pytest.raises(RuntimeError, match="no power reading"):
        pm.stop()
    assert seen[0] == ["nvidia-smi", "--query-gpu=power.draw",
                       "--format=csv,noheader,nounits", "-i", "5"]
    assert len(pm.samples) >= 2
    assert pm.avg_watts == pytest.approx(312.45)
    assert pm.max_watts == pytest.approx(312.45)
    assert pm.avg_bytes_in_use == 1 << 20


def test_power_monitor_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        PowerMonitor(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        with profile_trace("unused", device="cuda"):
            pass
