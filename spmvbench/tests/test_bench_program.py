"""The program's own span record read beside a Chrome trace: set-up by
phase, the calls put on the trace's clock, and the readers of the metrics
they give (``spmvbench/program.py``)."""

import types

import pytest

from spmvbench import manifest, program
from spmvbench.roofline import PEAKS
from spmvbench.trace import Trace


def _x(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


# the trace's clock, microseconds: one benchmark call (2-20) in the window
EVENTS = [
    _x("user_annotation", "spmvbench.window", 0, 100),
    _x("user_annotation", "spmvbench.solve", 1, 98),
    _x("user_annotation", "spmvbench.run", 2, 18),
    _x("cuda_runtime", "cudaLaunchKernel", 4, 0.5, corr=1),  # pad
    _x("cuda_runtime", "cudaLaunchKernel", 7, 1, corr=2),  # B4
    _x("cuda_runtime", "cudaLaunchKernel", 12, 0.5, corr=3),  # epilogue
    _x("user_annotation", "spmvbench.update", 21, 4),
    _x("cuda_runtime", "cudaLaunchKernel", 22, 1, corr=4),
    _x("user_annotation", "spmvbench.sync", 26, 73),
    _x("kernel", "pad", 8, 1.5, corr=1),
    _x("kernel", "b4", 12, 30, corr=2),
    _x("kernel", "scale", 45, 3, corr=3),
    _x("kernel", "norm", 50, 5, corr=4),
    # the solve before the window: no benchmark call span
    _x("cuda_runtime", "cudaLaunchKernel", -45, 1, corr=5),
    _x("kernel", "b4", -44, 30, corr=5),
]
# the program's annotations as they also stand in the trace
ANNOTATIONS = [_x("cpu_op", "hispmv.run", 3, 16),
               _x("cpu_op", "hispmv.kernel.B4", 6, 4)]

OFF = 7_000_000_000_000  # perf_counter_ns at the trace's 0


def _ns(us):
    return int(us * 1000) + OFF


def _span(name, start, end, parent, call=-1):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end,
                                 parent=parent, call=call)


def _record(spans):
    return types.SimpleNamespace(spans=spans)


SETUP = [
    _span("prepare", 0, 100, -1),
    _span("prepare.plan", 0, 60, 0),
    _span("plan.routed.build", 0, 50, 1),
    _span("prepare.pack", 60, 95, 0),
    _span("upload", 70, 80, 3),
    _span("upload", 72, 78, 4),  # nested in an upload: counted once
    _span("upload", 85, 90, 3),
    _span("upload", 200, 230, -1),  # at the first call, in the warm-up
]


def _calls(first):
    """The solve before the window and the window's call, from index
    ``first``, on the program's clock."""
    return [
        _span("run", _ns(-48), _ns(-40), -1, first),
        _span("kernel.B4", _ns(-46), _ns(-44), first, first),
        _span("run", _ns(3), _ns(19), -1, first + 2),
        _span("pad", _ns(3.5), _ns(5), first + 2, first + 2),
        _span("kernel.B4", _ns(6), _ns(10), first + 2, first + 2),
        _span("epilogue", _ns(11), _ns(13), first + 2, first + 2),
    ]


RECORD = _record(SETUP + _calls(len(SETUP)))


def test_setup_seconds_of_the_last_prepare():
    assert program.setup_seconds(RECORD, "prepare.plan") == \
        pytest.approx(60e-9)
    assert program.setup_seconds(RECORD, "upload") == pytest.approx(45e-9)
    assert program.setup_seconds(RECORD, "prepare.pack", own=True) == \
        pytest.approx(20e-9)
    assert program.setup_seconds(RECORD, "nothing") is None
    older = _record([_span("prepare", 0, 10, -1),
                     _span("prepare.plan", 0, 9, 0)] + [
        _span(s.name, s.start_ns, s.end_ns,
              s.parent + 2 if s.parent >= 0 else -1) for s in SETUP])
    assert program.setup_seconds(older, "prepare.plan") == \
        pytest.approx(60e-9)
    assert program.setup_seconds(_record(SETUP[1:]), "upload") is None
    assert program.setup_seconds(None, "upload") is None


def test_calls_land_on_the_trace_clock():
    (call,) = program.calls_on_trace(RECORD, Trace(EVENTS), "run")
    assert call[0] == pytest.approx(3) and call[1] == pytest.approx(19)
    assert call[2] == [pytest.approx((6, 10))]
    assert program.calls_on_trace(RECORD, Trace(EVENTS), "linear") is None


def test_one_offset_from_the_tightest_bounds():
    """Two calls: the first bounds the offset from below (its program
    call starts 1 us after the benchmark's), the second from above (it
    ends 1 us before); every span takes the midpoint of the two."""
    events = [_x("user_annotation", "spmvbench.window", 0, 100),
              _x("user_annotation", "spmvbench.run", 10, 10),
              _x("user_annotation", "spmvbench.run", 30, 10)]
    rec = _record([_span("run", _ns(11), _ns(15), -1, 0),
                   _span("kernel.B4", _ns(12), _ns(13), 0, 0),
                   _span("run", _ns(35), _ns(39), -1, 2)])
    first, second = program.calls_on_trace(rec, Trace(events), "run")
    # lo: 10 - 11 = -1 and 30 - 35 = -5; hi: 20 - 15 = 5, 40 - 39 = 1;
    # one offset, 0
    assert first[:2] == (pytest.approx(11), pytest.approx(15))
    assert first[2] == [pytest.approx((12, 13))]
    assert second[:2] == (pytest.approx(35), pytest.approx(39))
    # bounds that cross (a clock that moved): each call its own midpoint
    rec.spans[0] = _span("run", _ns(11), _ns(19.5), -1, 0)  # lo -1, hi 0.5
    rec.spans[2] = _span("run", _ns(28), _ns(35), -1, 2)  # lo 2, hi 5
    first, second = program.calls_on_trace(rec, Trace(events), "run")
    assert first[0] == pytest.approx(11 - 0.25)
    assert second[0] == pytest.approx(28 + 3.5)


def test_pairing_fails_cleanly():
    tr = Trace(EVENTS)
    only_warm = _record(SETUP + _calls(len(SETUP))[:2])
    assert program.calls_on_trace(only_warm, Trace(
        [e for e in EVENTS if e["name"] != "spmvbench.run"]), "run") is None
    long = _record(SETUP + _calls(len(SETUP))[:2] + [
        _span("run", _ns(0), _ns(30), -1, len(SETUP) + 2)])
    assert program.calls_on_trace(long, tr, "run") is None
    assert program.calls_on_trace(_record([]), tr, "run") is None
    assert program.calls_on_trace(RECORD, None, "run") is None


def test_glue_share_host_wait_and_launches():
    tr = Trace(EVENTS)
    # pad and epilogue of 1.5 + 30 + 3 us that the call launched
    assert program.glue_share(RECORD, tr, "run") == \
        pytest.approx(100 * 4.5 / 34.5)
    # idle 3-8 and 9.5-12 while the host is in the call (3-19)
    wait = program.host_wait_share(RECORD, tr, "run")
    assert wait == pytest.approx(7.5)
    assert wait <= 100 * (1 - tr.busy_s / tr.window_s)
    assert program.launches_per_call(RECORD, tr, "run") == 1.0


def test_glue_share_without_device_time_is_none():
    tr = Trace([e for e in EVENTS if e["cat"] != "kernel"])
    assert program.glue_share(RECORD, tr, "run") is None
    assert program.host_wait_share(RECORD, tr, "run") is None


NEW = ("plan_s", "pack_s", "upload_s", "glue_device_pct.run",
       "glue_device_pct.linear", "host_wait_pct.run", "host_wait_pct.linear",
       "launches_per_call.run", "launches_per_call.linear")


def _ctx(events, call="run"):
    return types.SimpleNamespace(
        call=call, trace=Trace(events), peaks=PEAKS["H100"], rows=1000,
        cols=1000, nnz=10_000, batch=1, y_in=False, window_s=1.0, calls=10,
        solve_s=[0.1, 0.2], setup_s=3.0, prepare_s=2.0, host_call_s=1e-3,
        host_calls=10)


def _as(call, events):
    return [dict(e, name=e["name"].replace("run", call)) for e in events]


@pytest.mark.parametrize("call", ["run", "linear"])
def test_existing_readers_ignore_the_programs_spans(monkeypatch, call):
    bench = manifest.load()
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]
             if m["name"] not in NEW]
    monkeypatch.setattr(program, "record", lambda: None)
    want = {n: manifest.reader(n)(_ctx(_as(call, EVENTS), call))
            for n in names}
    monkeypatch.setattr(program, "record", lambda: RECORD)
    got = {n: manifest.reader(n)(_ctx(_as(call, EVENTS + ANNOTATIONS),
                                      call)) for n in names}
    assert got == want
    assert got[f"{call}_roofline"] is not None


@pytest.mark.parametrize("rec", [None, _record([])])
@pytest.mark.parametrize("call", ["run", "linear"])
def test_new_readers_read_nothing_without_the_record(monkeypatch, rec,
                                                     call):
    monkeypatch.setattr(program, "record", lambda: rec)
    for name in NEW:
        assert manifest.reader(name)(_ctx(_as(call, EVENTS), call)) is None, \
            name


def test_new_readers_read_the_record(monkeypatch):
    monkeypatch.setattr(program, "record", lambda: RECORD)
    got = {n: manifest.reader(n)(_ctx(EVENTS)) for n in NEW}
    assert got["plan_s"] == pytest.approx(60e-9)
    assert got["pack_s"] == pytest.approx(20e-9)
    assert got["upload_s"] == pytest.approx(45e-9)
    assert got["glue_device_pct.run"] == pytest.approx(100 * 4.5 / 34.5)
    assert got["host_wait_pct.run"] == pytest.approx(7.5)
    assert got["launches_per_call.run"] == 1.0
    assert all(got[n] is None for n in NEW if n.endswith(".linear"))


def test_record_of_a_program_without_one(monkeypatch):
    """The parent's program has no ``recorded``: nothing to read."""
    from hispmv_tpu_torch.utils import trace

    monkeypatch.delattr(trace, "recorded")
    assert program.record() is None
