"""The program's own span record, read beside the traced window.

The program under test keeps the spans it makes with no tracer of its
own active (``hispmv_tpu_torch.utils.trace.recorded``): its set-up always
(``prepare`` by phase, and the arrays a layout uploads at its first
call), and every span made inside a ``torch.profiler`` session, as the
traced window is.  A span has a name, a start and an end on
``time.perf_counter_ns``, the index of its parent and that of its call
(the ``run`` or ``linear`` span it lies in).  From it this module reads:

- set-up: seconds of the last ``prepare``'s phases and of the uploads
  from it on (``plan_s``, ``pack_s``, ``upload_s``);
- the traced window (``trace.Trace``): the program's outermost call spans
  are paired one to one, in order, with the benchmark's own call spans
  (``spmvbench.run`` / ``spmvbench.linear``), each of which holds one
  program call; the window's are the last of the program's, since the
  solve before the window opens no benchmark call span.  The two clocks
  differ by one offset: each pair bounds it (the program's call lies
  inside the benchmark's), and the program's spans are put on the trace's
  clock by the midpoint of the tightest bounds over all pairs, so that
  the fastest call's host microseconds between the two starts and
  between the two ends are split evenly (on the card within 0.01 points
  of the glue share read from the program's own annotations, PERF.md).
  Where the bounds cross, each call takes the midpoint of its own.  Then
  the device time a call launched inside its
  ``kernel.*`` spans and outside them (``glue_device_pct``), the idle time
  while the host was inside a call (``host_wait_pct``), and the kernel
  spans a call (``launches_per_call``).

Against a program without the record every function returns None.
"""

from __future__ import annotations

import bisect

from spmvbench.trace import _merge

BENCH = "spmvbench."  # the benchmark's spans in the trace
KERNEL = "kernel."  # a kernel wrapper's span in the program's record


def record():
    """The program's record (its ``spans``), or None where it has none."""
    try:
        from hispmv_tpu_torch.utils import trace
    except ImportError:
        return None
    recorded = getattr(trace, "recorded", None)
    return None if recorded is None else recorded()


def _closed(s):
    return s.end_ns is not None


def _last_prepare(spans):
    """Index of the last closed top-level ``prepare`` span, or None."""
    for i in range(len(spans) - 1, -1, -1):
        s = spans[i]
        if s.name == "prepare" and s.parent == -1 and _closed(s):
            return i
    return None


def _has_ancestor(spans, i, test):
    p = spans[i].parent
    while p >= 0:
        if test(p):
            return True
        p = spans[p].parent
    return False


def setup_seconds(rec, name, own=False):
    """Seconds of the spans named ``name`` from the last ``prepare`` on:
    inside it, or after it (an upload at a layout's first call); nested
    spans of that name counted once.  ``own``: less the time of their
    children.  None without a ``prepare`` or such a span."""
    if rec is None:
        return None
    spans = rec.spans
    p = _last_prepare(spans)
    if p is None:
        return None
    total_ns, found = 0, False
    for i in range(p, len(spans)):
        s = spans[i]
        if s.name != name or not _closed(s) or _has_ancestor(
                spans, i, lambda j: spans[j].name == name):
            continue
        total_ns += s.end_ns - s.start_ns
        found = True
        if own:
            total_ns -= sum(c.end_ns - c.start_ns for c in spans[i + 1:]
                            if c.parent == i and _closed(c))
    return total_ns * 1e-9 if found else None


def calls_on_trace(rec, trace, call):
    """The program's ``call`` calls of the traced window, on the trace's
    clock (microseconds): a list of (start, end, [kernel spans as (start,
    end)]); None where the record has no such calls, the trace no window,
    or the pairing fails (fewer program calls than benchmark ones, or a
    program call longer than its benchmark span)."""
    if rec is None or trace is None or trace.window is None:
        return None
    spans = rec.spans
    p = _last_prepare(spans)
    first = 0 if p is None else p + 1
    prog = [i for i in range(first, len(spans))
            if spans[i].name == call and spans[i].parent == -1
            and _closed(spans[i])]
    bench = sorted((s for s in trace.spans if s[2] == BENCH + call),
                   key=lambda s: s[0])
    if not bench or len(prog) < len(bench):
        return None
    prog = prog[len(prog) - len(bench):]
    kernels = {c: [] for c in prog}
    for s in spans[prog[0]:]:
        if s.name.startswith(KERNEL) and s.call in kernels and _closed(s):
            kernels[s.call].append(s)
    pairs = [(b0, b1, spans[c].start_ns * 1e-3, spans[c].end_ns * 1e-3, c)
             for (b0, b1, _), c in zip(bench, prog)]
    if any(a1 - a0 > b1 - b0 for b0, b1, a0, a1, _ in pairs):
        return None
    lo = max(b0 - a0 for b0, _, a0, _, _ in pairs)
    hi = min(b1 - a1 for _, b1, _, a1, _ in pairs)
    w0, w1 = trace.window
    out = []
    for b0, b1, a0, a1, c in pairs:
        off = (lo + hi) / 2 if lo <= hi else ((b0 - a0) + (b1 - a1)) / 2
        if b0 >= w0 and b1 <= w1:
            out.append((a0 + off, a1 + off,
                        [(k.start_ns * 1e-3 + off, k.end_ns * 1e-3 + off)
                         for k in kernels[c]]))
    return out or None


def _launched_in(trace, intervals):
    """Correlation ids of the trace's launches inside any interval."""
    ts, launches = trace._launch_ts, trace._launches
    corrs = set()
    for s0, s1 in intervals:
        i = bisect.bisect_left(ts, s0)
        while i < len(launches) and launches[i][0] <= s1:
            corrs.add(launches[i][1])
            i += 1
    return corrs


def _device_s(trace, corrs):
    return sum(e - s for s, e, _, c in trace.device if c in corrs) * 1e-6


def glue_share(rec, trace, call):
    """Percent of the device time that the window's ``call`` calls
    launched which they launched outside their kernel spans; None where
    there is nothing to read."""
    return glue_of(trace, calls_on_trace(rec, trace, call))


def glue_of(trace, calls):
    """``glue_share`` of ``calls`` (``calls_on_trace``'s list)."""
    if not calls:
        return None
    launched = _launched_in(trace, [(c0, c1) for c0, c1, _ in calls])
    in_kernels = _launched_in(trace, [k for _, _, ks in calls for k in ks])
    total = _device_s(trace, launched)
    if total <= 0:
        return None
    return 100.0 * _device_s(trace, launched - in_kernels) / total


def host_wait_share(rec, trace, call):
    """Percent of the window in which the device was idle while the host
    was inside a ``call`` call; None where there is nothing to read."""
    return host_wait_of(trace, calls_on_trace(rec, trace, call))


def host_wait_of(trace, calls):
    """``host_wait_share`` of ``calls`` (``calls_on_trace``'s list)."""
    if not calls or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    w0, w1 = trace.window
    idle, t = [], w0
    for s, e in trace.busy_intervals():
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if t < w1:
        idle.append((t, w1))
    inside = _merge((c0, c1) for c0, c1, _ in calls)
    wait = 0.0
    for g0, g1 in idle:
        for s0, s1 in inside:
            wait += max(0.0, min(g1, s1) - max(g0, s0))
    return 100.0 * wait * 1e-6 / trace.window_s


def launches_per_call(rec, trace, call):
    """Kernel spans a ``call`` call of the window; None where there is
    nothing to read."""
    calls = calls_on_trace(rec, trace, call)
    if calls is None:
        return None
    return sum(len(ks) for _, _, ks in calls) / len(calls)
