"""Reading a ``torch.profiler`` Chrome trace of the traced window.

The benchmark opens its own spans with ``record_function`` (names under
``spmvbench.``): the window, each solve, each call into the program, the
solver's own update and the synchronise.  From the trace this module
takes:

- the device's operations (kernels, copies, fills) as intervals, and the
  busy time as the union of those inside the window, so that work on two
  streams at once counts once;
- each call's own device time: the operations whose launch (a runtime or
  driver API event with the same correlation id) lies inside the call's
  span on the host;
- a breakdown: the device operations that took most time, and the idle
  gaps by the benchmark span open on the host when each gap began.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

PREFIX = "spmvbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _merge(intervals):
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """The events of one Chrome trace (times in microseconds)."""

    def __init__(self, events):
        self.device = []  # (start, end, name, correlation)
        self.spans = []  # (start, end, name): the benchmark's spans
        launches = []  # (ts, correlation)
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
            corr = (ev.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, ev.get("name", ""), corr))
            elif cat in LAUNCH_CATS and corr is not None:
                launches.append((ts, corr))
            elif cat == "user_annotation" and \
                    str(ev.get("name", "")).startswith(PREFIX):
                self.spans.append((ts, ts + dur, ev["name"]))
        self.spans.sort(key=lambda s: (s[0], -s[1]))
        launches.sort()
        self._launch_ts = [t for t, _ in launches]
        self._launches = launches
        windows = [s for s in self.spans if s[2] == PREFIX + "window"]
        self.window = (windows[0][0], windows[0][1]) if windows else None

    @classmethod
    def load(cls, path):
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events)

    @property
    def window_s(self) -> float:
        if self.window is None:
            return 0.0
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self):
        """Device busy intervals, merged, clipped to the window."""
        if self.window is None:
            return []
        w0, w1 = self.window
        return _merge((max(s, w0), min(e, w1)) for s, e, _, _ in self.device
                      if e > w0 and s < w1)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def call_device_s(self, name: str):
        """(device seconds of the operations launched inside the spans
        named ``name``, number of such spans)."""
        spans = [s for s in self.spans if s[2] == name]
        corrs = set()
        for s0, s1, _ in spans:
            i = bisect.bisect_left(self._launch_ts, s0)
            while i < len(self._launches) and self._launches[i][0] <= s1:
                corrs.add(self._launches[i][1])
                i += 1
        total = sum(e - s for s, e, _, c in self.device if c in corrs)
        return total * 1e-6, len(spans)

    def top_device_ops(self, k: int = 10):
        """[[name, seconds], ...] of the device operations in the window
        that took most time, summed by name."""
        if self.window is None:
            return []
        w0, w1 = self.window
        by = defaultdict(float)
        for s, e, name, _ in self.device:
            if e > w0 and s < w1:
                by[name] += (min(e, w1) - max(s, w0)) * 1e-6
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])
                ][:k]

    def idle_gaps(self, k: int = 10):
        """[[span, seconds], ...]: the device's idle time in the window,
        summed by the innermost benchmark span open on the host when each
        gap began ("outside spans" where none was)."""
        if self.window is None:
            return []
        w0, w1 = self.window
        busy = self.busy_intervals()
        gaps, t = [], w0
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < w1:
            gaps.append((t, w1))
        spans = [s for s in self.spans if s[2] != PREFIX + "window"]
        starts = [s[0] for s in spans]
        parent, stack = [], []
        for i, (s0, _, _) in enumerate(spans):
            while stack and spans[stack[-1]][1] < s0:
                stack.pop()
            parent.append(stack[-1] if stack else -1)
            stack.append(i)
        by = defaultdict(float)
        for g0, g1 in gaps:
            i = bisect.bisect_right(starts, g0) - 1
            while i >= 0 and spans[i][1] < g0:
                i = parent[i]
            name = spans[i][2][len(PREFIX):] if i >= 0 else "outside spans"
            by[name] += (g1 - g0) * 1e-6
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])
                ][:k]
