"""Tracing / profiling observability on the card.

The contract of ``hispmv_tpu/utils/trace.py``, with the card's own
counters (SURVEY.md section 5: the reference times wall-clock segments
around preprocessing and kernel runs, and samples platform power):

- :class:`Tracer` — named wall-clock segments with a report (the
  std::chrono segments analog, spmv-helper.cpp:659-714).  It does not
  synchronize the device: a span around asynchronous launches measures
  the host's time unless the caller synchronizes inside it.
- :func:`profile_trace` — context manager around ``torch.profiler``
  (CPU activity always, CUDA activity on a card) that writes a Chrome
  trace JSON under ``logdir``; on a card it raises when the profile holds
  no device event.
- :class:`PowerMonitor` — the FpgaPowerMonitor-shaped interface
  (start/stop/avg/max, fpga-power.h:17-38): on a card a thread polls
  ``nvidia-smi`` for the board's power draw and reads the bytes PyTorch
  holds on the card; on the CPU there is no power counter and watts are
  NaN by contract.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import subprocess
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from hispmv_tpu_torch.utils.device import resolve_device


class Tracer:
    """Named wall-clock segments: ``with tracer.span("prepare"): ...``"""

    def __init__(self):
        self.segments: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.segments[name] = self.segments.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = ["segment               total_s   calls"]
        for name, total in sorted(
            self.segments.items(), key=lambda kv: -kv[1]
        ):
            lines.append(f"{name:20} {total:8.3f} {self.counts[name]:7d}")
        return "\n".join(lines)


@dataclasses.dataclass
class ProfileTrace:
    """What :func:`profile_trace` yields; filled in when the block ends."""

    logdir: str
    path: Optional[str] = None  # the Chrome trace JSON
    device_us: float = 0.0  # self device time of every event, summed
    profile: Optional[object] = None  # the torch.profiler.profile


def _device_us(prof) -> float:
    total = 0.0
    for e in prof.key_averages():
        total += getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
    return total


@contextlib.contextmanager
def profile_trace(logdir: str, device="cuda"):
    """``torch.profiler`` around a region, written as a Chrome trace JSON
    (open it in Perfetto or chrome://tracing) under ``logdir``::

        with profile_trace("traces") as tr:
            h.run(x)
        print(tr.path)

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
        yield out
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    out.profile = prof
    out.path = os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(out.path)
    if dev.type == "cuda":
        out.device_us = _device_us(prof)
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
