"""The port's observability: tracer spans, the profiler trace and the
power monitor's plumbing (mirrors of tests/test_trace.py), the program's
spans in prepare, run and linear, on the CPU; the card's power reading and
device events are in tests/test_torch_cuda.py."""

import dataclasses
import inspect
import json
import math
import subprocess
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from hispmv_tpu_torch import SpmvHandle
from hispmv_tpu_torch.formats.synth import random_coo
from hispmv_tpu_torch.ops import spmv_chunked as chunked_ops
from hispmv_tpu_torch.profiles import V5E
from hispmv_tpu_torch.utils import trace
from hispmv_tpu_torch.utils.trace import (
    PowerMonitor,
    Tracer,
    profile_trace,
    span,
    tracing,
)


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


# --- the program's spans -------------------------------------------------

# B6 for every batch: the block handle's linear past its batched budget
B6_ONLY = dataclasses.replace(V5E, batched_budget_bytes=0)


def _block(profile=V5E):
    return SpmvHandle(random_coo(600, 700, 6000, seed=1), format="block",
                      device="cpu", profile=profile)


def _routed():
    return SpmvHandle(random_coo(3000, 3000, 30000, seed=1),
                      format="routed", device="cpu")


def _names(tr, idx):
    return [tr.spans[i].name for i in idx]


def _children(tr, i):
    return [j for j, s in enumerate(tr.spans) if s.parent == i]


def test_tracing_restores_the_tracer_active_before():
    assert trace._active is None
    with tracing() as outer:
        with tracing() as inner:
            with span("a"):
                pass
        with span("b"):
            pass
    assert trace._active is None
    assert [s.name for s in inner.spans] == ["a"]
    assert [s.name for s in outer.spans] == ["b"]
    mine = Tracer()
    with tracing(mine) as got:
        assert got is mine


def test_span_without_a_tracer_is_the_shared_no_op():
    assert span("run") is span("kernel.B4")
    with span("run") as got:
        assert got is None


@pytest.mark.parametrize("kind", ["block", "routed"])
def test_no_tracer_records_nothing(monkeypatch, kind):
    """Once set up (the block format uploads B6's arrays at its first
    ``linear``, recorded as set-up), calls with no tracer and no profiler
    record nothing and annotate nothing."""
    h = _block(B6_ONLY) if kind == "block" else _routed()
    h.linear(np.ones((3, h.shape[1]), np.float32))
    kept = len(trace.recorded().spans)
    seen = []

    def refuse(name):
        seen.append(name)
        raise AssertionError(f"annotation {name!r} with tracing off")
    monkeypatch.setattr(trace, "annotate", refuse)
    x = np.ones(h.shape[1], np.float32)
    h.run(x)
    h.run(x, y_in=np.ones(h.shape[0], np.float32), alpha=0.5, beta=2.0)
    h.linear(np.ones((3, h.shape[1]), np.float32), bias=np.ones(h.shape[0]))
    assert seen == [] and trace._active is None
    assert len(trace.recorded().spans) == kept


def test_prepare_spans_nest_under_prepare():
    with tracing() as tr:
        _block()
    top = [i for i, s in enumerate(tr.spans) if s.parent == -1]
    assert _names(tr, top) == ["prepare"]
    kids = _children(tr, top[0])
    assert _names(tr, kids) == ["prepare.plan", "prepare.pack"]
    uploads = [i for i, s in enumerate(tr.spans) if s.name == "upload"]
    assert uploads and all(tr.spans[i].parent == kids[1] for i in uploads)
    assert all(s.call == -1 and s.end_ns >= s.start_ns for s in tr.spans)
    assert tr.counts["prepare"] == 1


def test_routed_planner_spans_nest_under_prepare_plan():
    with tracing() as tr:
        _routed()
    (plan,) = [i for i, s in enumerate(tr.spans) if s.name == "prepare.plan"]
    assert tr.spans[tr.spans[plan].parent].name == "prepare"
    kids = _names(tr, _children(tr, plan))
    assert kids[0] == "plan.routed.estimate"
    assert 1 <= kids.count("plan.routed.build") <= 2
    assert kids[-1] == "plan.routed.repack"
    assert set(kids) == {"plan.routed.estimate", "plan.routed.build",
                         "plan.routed.repack"}


def _call_spans(tr, name):
    calls = [i for i, s in enumerate(tr.spans) if s.name == name]
    assert len(calls) == 1
    (c,) = calls
    inside = [s for s in tr.spans[c + 1:]]
    assert all(s.call == c for s in inside)
    assert tr.spans[c].call == c and tr.spans[c].parent == -1
    return [s.name for s in inside]


@pytest.mark.parametrize("kind,kernels", [
    ("block", ["kernel.B1"]),
    ("routed", ["kernel.B9"]),
])
def test_run_spans_share_the_call_id(kind, kernels):
    h = _block() if kind == "block" else _routed()
    x = np.ones(h.shape[1], np.float32)
    with tracing() as tr:
        h.run(x, y_in=np.ones(h.shape[0], np.float32), alpha=0.5, beta=2.0)
    names = _call_spans(tr, "run")
    assert names[0] == "pad" and names[-1] == "epilogue"
    assert [n for n in names if n.startswith("kernel.")] == kernels
    if kind == "routed":
        assert "residual" in names


def test_run_spans_one_kernel_span_a_wrapper_call(monkeypatch):
    """Each call of a kernel wrapper is one kernel span: B1 called twice
    in one run gives two."""
    h = _block()
    real = h._block_matvec

    def twice(x2d):
        real(x2d)
        return real(x2d)
    monkeypatch.setattr(h, "_block_matvec", twice)
    with tracing() as tr:
        h.run(np.ones(h.shape[1], np.float32))
    assert _call_spans(tr, "run").count("kernel.B1") == 2


def test_linear_spans_and_the_lazy_upload():
    h = _block(B6_ONLY)
    xb = np.ones((4, h.shape[1]), np.float32)
    with tracing() as tr:
        h.linear(xb, bias=np.ones(h.shape[0], np.float32))
    names = _call_spans(tr, "linear")
    assert names == ["pad", "upload", "transpose", "kernel.B6", "epilogue"]
    with tracing() as tr:
        h.linear(xb)  # uploaded once: no upload span
    assert _call_spans(tr, "linear") == ["pad", "transpose", "kernel.B6"]


def test_routed_linear_spans():
    h = _routed()
    with tracing() as tr:
        h.linear(np.ones((3, h.shape[1]), np.float32))
    names = _call_spans(tr, "linear")
    assert names[:2] == ["pad", "transpose"] and "residual" in names
    assert names.count("kernel.B10") == len(h._routed_meta["streams"])


def test_kernel_span_keeps_the_wrapper_and_its_counter():
    fn = chunked_ops.spmv_chunked_tiled
    assert "sector_mask" in inspect.signature(fn).parameters
    assert fn.__name__ == "spmv_chunked_tiled"
    assert isinstance(chunked_ops.spmv_chunked.launches, int)


def test_segments_and_counts_from_the_span_list():
    tr = Tracer()
    with tr.span("run"):
        with tr.span("pad"):
            time.sleep(0.002)
    with tr.span("run"):
        pass
    assert tr.counts == {"run": 2, "pad": 1}
    assert tr.segments["run"] >= tr.segments["pad"] >= 0.002
    assert [s.parent for s in tr.spans] == [-1, 0, -1]
    assert [s.call for s in tr.spans] == [0, 0, 2]


def test_program_spans_land_in_the_profilers_trace(tmp_path):
    """Under torch.profiler, inside a benchmark's annotation, the
    program's ``hispmv.`` annotations nest in it on the same clock."""
    h = _block()
    x = np.ones(h.shape[1], np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing():
            with record_function("spmvbench.run"):
                h.run(x)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
                  and e.get("cat") in ("user_annotation", "cpu_op")]
    by = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
          for e in events}
    outer = by["spmvbench.run"]
    for name in ("hispmv.run", "hispmv.pad", "hispmv.kernel.B1",
                 "hispmv.epilogue"):
        s0, s1 = by[name]
        assert outer[0] <= s0 <= s1 <= outer[1], name
    assert by["hispmv.run"][0] <= by["hispmv.kernel.B1"][0]
    assert by["hispmv.kernel.B1"][1] <= by["hispmv.run"][1]


def test_profile_trace_turns_the_programs_tracing_on(tmp_path):
    h = _block()
    with profile_trace(str(tmp_path), device="cpu") as tr:
        assert trace._active is tr.tracer
        h.run(np.ones(h.shape[1], np.float32))
    assert trace._active is None
    assert tr.tracer.counts["run"] == 1
    assert tr.tracer.counts["kernel.B1"] == 1
    with open(tr.path) as f:
        assert "hispmv.kernel.B1" in f.read()


def test_device_us_is_the_union_of_device_intervals(tmp_path):
    def x(cat, ts, dur):
        return {"ph": "X", "cat": cat, "name": "k", "ts": ts, "dur": dur}
    events = [x("kernel", 0, 10), x("kernel", 5, 10),  # overlap: 0-15
              x("gpu_memcpy", 20, 5), x("gpu_memset", 22, 1),  # 20-25
              x("cpu_op", 30, 100), x("kernel", 40, 0)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert trace._device_us(str(path)) == pytest.approx(20.0)


# --- the program's own record --------------------------------------------


def _new_spans(before):
    return trace.recorded().spans[before:]


def test_prepare_records_without_a_tracer():
    """Set-up records with no tracer active: into the program's own
    record, ``prepare`` over its phases."""
    before = len(trace.recorded().spans)
    _block()
    spans = _new_spans(before)
    assert spans[0].name == "prepare" and spans[0].parent == -1
    top = before  # the record's index of that prepare
    kids = [s.name for s in spans if s.parent == top]
    assert kids == ["prepare.plan", "prepare.pack"]
    assert any(s.name == "upload" for s in spans)
    assert all(s.end_ns is not None for s in spans)
    assert trace._active is None


def test_prepare_with_a_tracer_records_only_there():
    before = len(trace.recorded().spans)
    with tracing() as tr:
        _routed()
    assert len(trace.recorded().spans) == before
    assert tr.counts["prepare"] == 1


def test_lazy_upload_is_recorded_as_set_up():
    h = _block(B6_ONLY)
    before = len(trace.recorded().spans)
    xb = np.ones((2, h.shape[1]), np.float32)
    h.linear(xb)
    (up,) = [s for s in _new_spans(before) if s.parent == -1]
    assert up.name == "upload" and up.call == -1
    h.linear(xb)  # uploaded once: nothing more
    assert len(_new_spans(before)) == 1


@pytest.mark.parametrize("kind,call", [("block", "run"), ("routed", "run"),
                                       ("routed", "linear")])
def test_profiler_session_records_the_calls(kind, call):
    """Inside a torch.profiler session with no tracer active, a call's
    spans go to the program's own record and into the profile."""
    h = _block() if kind == "block" else _routed()
    x = np.ones(h.shape[1], np.float32)
    fn = (lambda: h.run(x)) if call == "run" else \
        (lambda: h.linear(np.stack([x, x])))
    fn()
    before = len(trace.recorded().spans)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    spans = _new_spans(before)
    assert spans[0].name == call and spans[0].parent == -1
    assert all(s.call == before for s in spans)
    assert any(s.name.startswith("kernel.") for s in spans)
    names = {e.name for e in prof.events()}
    assert "hispmv." + call in names
    fn()  # after the session: nothing more
    assert len(_new_spans(before)) == len(spans)


def test_recording_uses_the_active_tracer():
    with tracing() as tr:
        with trace.recording():
            with span("upload"):
                pass
    assert [s.name for s in tr.spans] == ["upload"]
    before = len(trace.recorded().spans)
    with trace.recording() as got:
        assert got is trace.recorded()
        with span("upload"):
            pass
    assert [s.name for s in _new_spans(before)] == ["upload"]
    assert trace._active is None


def test_tracer_limit_starts_again_between_top_spans():
    tr = Tracer(limit=3)
    with tracing(tr):
        with span("run"):
            with span("pad"):
                pass
            with span("kernel.B4"):  # over the limit inside a call: kept
                pass
        with span("run"):  # a top span at the limit: the list starts again
            pass
    assert [s.name for s in tr.spans] == ["run"]
    assert tr.spans[0].call == 0 and tr.spans[0].parent == -1
