"""Tracing / profiling observability on the card.

The contract of ``hispmv_tpu/utils/trace.py``, with the card's own
counters (SURVEY.md section 5: the reference times wall-clock segments
around preprocessing and kernel runs, and samples platform power):

- :class:`Tracer` — the program's span recorder: a list of spans (name,
  start and end on ``time.perf_counter_ns``, parent, call), with the
  named wall-clock totals ``segments`` / ``counts`` and a report (the
  std::chrono segments analog, spmv-helper.cpp:659-714).  It does not
  synchronize the device: a span around asynchronous launches measures
  the host's time unless the caller synchronizes inside it.
- :func:`tracing` / :func:`span` — the program's switch: inside
  ``with tracing() as tr:`` every :func:`span` of the program records
  into ``tr`` and opens a profiler annotation ``"hispmv." + name``
  (:data:`annotate`), so that under ``torch.profiler`` the spans share
  the device trace's clock.  With no tracer active, :func:`span` returns
  a shared no-op context, except inside a ``torch.profiler`` session,
  where it records into the program's own record (:func:`recorded`) and
  annotates all the same: any profile of the program shows its spans.
- :func:`recording` — set-up (``prepare``, and the arrays a layout uploads
  at its first call) records always: into the active tracer, or with none
  into :func:`recorded`; it runs once and takes seconds, its few spans
  cost microseconds.
- :func:`profile_trace` — context manager around ``torch.profiler``
  (CPU activity always, CUDA activity on a card), with the program's
  tracing on, that writes a Chrome trace JSON under ``logdir``; on a
  card it raises when the profile holds no device event.
- :class:`PowerMonitor` — the FpgaPowerMonitor-shaped interface
  (start/stop/avg/max, fpga-power.h:17-38): on a card a thread polls
  ``nvidia-smi`` for the board's power draw and reads the bytes PyTorch
  holds on the card; on the CPU there is no power counter and watts are
  NaN by contract.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.profiler import record_function

from hispmv_tpu_torch.utils.device import resolve_device


PREFIX = "hispmv."  # the profiler annotation of a span is PREFIX + name
CALLS = ("run", "linear")  # the spans of one call into the program

# The annotation a span opens: torch's C++ fast path (a "cpu_op" event in
# the Chrome trace, about 1 us a span on the card's host), where this
# torch has it, else ``record_function`` (a "user_annotation", about 20 us
# a span through torch.ops).
annotate = getattr(torch._C._profiler, "_RecordFunctionFast",
                   record_function)


@dataclasses.dataclass(slots=True)
class Span:
    """One span of a :class:`Tracer`: ``end_ns`` is None while it is open;
    ``parent`` and ``call`` are indices into the tracer's ``spans`` (-1:
    none), ``call`` the innermost enclosing span named in ``CALLS`` (the
    span itself for one)."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    call: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Tracer:
    """The program's spans, in the order they opened:
    ``with tracer.span("prepare"): ...``.  ``segments`` and ``counts``
    total the closed spans by name.  With a ``limit``, a span that opens
    with none open and ``limit`` spans kept clears the list first."""

    def __init__(self, limit: Optional[int] = None):
        self.spans: List[Span] = []
        self._open: List[int] = []
        self.limit = limit

    @contextlib.contextmanager
    def span(self, name: str):
        if not self._open and self.limit and len(self.spans) >= self.limit:
            self.spans.clear()
        i = len(self.spans)
        parent = self._open[-1] if self._open else -1
        call = i if name in CALLS else (
            self.spans[parent].call if parent >= 0 else -1)
        rec = Span(name, time.perf_counter_ns(), None, parent, call)
        self.spans.append(rec)
        self._open.append(i)
        try:
            with annotate(PREFIX + name):
                yield rec
        finally:
            rec.end_ns = time.perf_counter_ns()
            self._open.pop()

    def closed(self) -> List[Span]:
        return [s for s in self.spans if s.end_ns is not None]

    @property
    def segments(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.closed():
            out[s.name] = out.get(s.name, 0.0) + s.seconds
        return out

    @property
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.closed():
            out[s.name] = out.get(s.name, 0) + 1
        return out

    def report(self) -> str:
        counts = self.counts
        lines = ["segment               total_s   calls"]
        for name, total in sorted(
            self.segments.items(), key=lambda kv: -kv[1]
        ):
            lines.append(f"{name:20} {total:8.3f} {counts[name]:7d}")
        return "\n".join(lines)


_active: Optional[Tracer] = None  # the tracer that span() records into
_own = Tracer(limit=1 << 17)  # what is recorded with none active
_OFF = contextlib.nullcontext()
# ``_PROFILER._is_profiler_enabled``: a torch.profiler session is on
_PROFILER = torch.autograd.profiler


def recorded() -> Tracer:
    """The program's own record: the spans made with no tracer active
    (:func:`tracing`), under ``torch.profiler`` and in set-up
    (:func:`recording`); at most ~131k spans, then it starts again."""
    return _own


@contextlib.contextmanager
def tracing(tracer: Optional[Tracer] = None):
    """Make ``tracer`` (None: a new one) the one the program's spans record
    into for the block, and give it back; the tracer active before is
    active again after."""
    global _active
    tracer = Tracer() if tracer is None else tracer
    prev, _active = _active, tracer
    try:
        yield tracer
    finally:
        _active = prev


def recording():
    """The block's spans into the active tracer, or, with none active,
    into the program's own record (:func:`recorded`): for set-up."""
    return tracing(_own) if _active is None else contextlib.nullcontext()


def span(name: str):
    """A span of the program: records into the active tracer; with none
    active, into :func:`recorded` inside a ``torch.profiler`` session, and
    else the shared no-op context (no allocation, no torch call)."""
    tracer = _active
    if tracer is None:
        if not _PROFILER._is_profiler_enabled:
            return _OFF
        tracer = _own
    return tracer.span(name)


def traced(name: str, record: bool = False):
    """Decorator: each call of the function as one :func:`span` ``name``;
    ``record``: inside :func:`recording` (set-up)."""
    def wrap(fn):
        if record:
            @functools.wraps(fn)
            def call(*args, **kwargs):
                with recording(), span(name):
                    return fn(*args, **kwargs)
            return call

        @functools.wraps(fn)
        def call(*args, **kwargs):
            tracer = _active
            if tracer is None:
                if not _PROFILER._is_profiler_enabled:
                    return fn(*args, **kwargs)
                tracer = _own
            with tracer.span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@dataclasses.dataclass
class ProfileTrace:
    """What :func:`profile_trace` yields; filled in when the block ends."""

    logdir: str
    path: Optional[str] = None  # the Chrome trace JSON
    device_us: float = 0.0  # union of the device's operations' intervals
    profile: Optional[object] = None  # the torch.profiler.profile
    tracer: Optional[Tracer] = None  # the program's spans of the region


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # Chrome trace events


def _device_us(path: str) -> float:
    """Microseconds in which the device ran any operation of the Chrome
    trace at ``path``: the union of their intervals, so that operations
    on two streams at once count once."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    total, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            total += e - max(s, end)
            end = e
    return total


@contextlib.contextmanager
def profile_trace(logdir: str, device="cuda"):
    """``torch.profiler`` around a region, with the program's tracing on
    (:func:`tracing`: its spans appear in the trace as ``hispmv.``
    annotations), written as a Chrome trace JSON (open it in Perfetto or
    chrome://tracing) under ``logdir``::

        with profile_trace("traces") as tr:
            h.run(x)
        print(tr.path, tr.tracer.report())

    On a CUDA device the region is synchronized before the profile closes,
    and a profile without device time raises: a trace that saw no kernel
    is never taken for an empty one."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    out = ProfileTrace(logdir=logdir)
    with profile(activities=activities) as prof:
        with tracing() as out.tracer:
            yield out
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    out.profile = prof
    out.path = os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(out.path)
    if dev.type == "cuda":
        out.device_us = _device_us(out.path)
        if out.device_us <= 0:
            raise RuntimeError(
                f"profile_trace on {dev}: the profile holds no device event "
                f"(trace {out.path})")


class PowerSample(NamedTuple):
    t_s: float  # time.perf_counter() of the sample
    watts: float  # board power draw; NaN where there is no counter
    bytes_in_use: float  # bytes PyTorch holds on the device; NaN on the CPU


def _smi_id(dev: torch.device) -> str:
    """The card's ``nvidia-smi -i`` id: its index, or the entry of
    CUDA_VISIBLE_DEVICES that PyTorch's index stands for."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    visible = [v.strip() for v in
               os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
               if v.strip()]
    return visible[idx] if idx < len(visible) else str(idx)


class PowerMonitor:
    """start/stop/avg/max sampler, FpgaPowerMonitor-shaped
    (fpga-power.cpp:3-63).  On a CUDA device every ``interval_s`` the
    thread reads the board's power draw with ``nvidia-smi
    --query-gpu=power.draw`` and ``torch.cuda.memory_allocated``;
    ``start()`` raises when ``nvidia-smi`` cannot be run or prints no
    number, and a failed later sample raises from ``stop()``, so watts on a
    card are never NaN.  On the CPU watts are NaN and bytes in use are not
    read (NaN): the sampling thread runs all the same."""

    def __init__(self, interval_s: float = 1.0, device="cuda"):
        self.interval_s = interval_s
        self.device = resolve_device(device)
        self.samples: List[PowerSample] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _watts(self) -> float:
        if self.device.type != "cuda":
            return float("nan")
        cmd = ["nvidia-smi", "--query-gpu=power.draw",
               "--format=csv,noheader,nounits", "-i", _smi_id(self.device)]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=30, check=True).stdout
            return float(out.strip().splitlines()[0])
        except (OSError, subprocess.SubprocessError, ValueError,
                IndexError) as e:
            raise RuntimeError(
                f"PowerMonitor: {' '.join(cmd)} gave no power reading: "
                f"{e!r}") from e

    def _sample_once(self) -> PowerSample:
        watts = self._watts()
        used = (float(torch.cuda.memory_allocated(self.device))
                if self.device.type == "cuda" else float("nan"))
        return PowerSample(time.perf_counter(), watts, used)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.samples.append(self._sample_once())
            except RuntimeError as e:
                self._error = e
                return

    def start(self):
        self._stop.clear()
        self._error = None
        self.samples.append(self._sample_once())  # raises at once
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None
        if self._error is not None:
            raise self._error

    @property
    def avg_watts(self) -> float:
        return _mean([s.watts for s in self.samples])

    @property
    def max_watts(self) -> float:
        good = [s.watts for s in self.samples if not math.isnan(s.watts)]
        return max(good) if good else float("nan")

    @property
    def avg_bytes_in_use(self) -> float:
        return _mean([s.bytes_in_use for s in self.samples])


def _mean(values) -> float:
    good = [v for v in values if not math.isnan(v)]
    return sum(good) / len(good) if good else float("nan")
