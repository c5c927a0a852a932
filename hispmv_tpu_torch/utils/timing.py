"""Kernel timing on the card: the median of N calls after a warm-up, with
CUDA events recorded around each call.

The port's counterpart of ``hispmv_tpu/utils/timing.py``.  The JAX package
times a loop inside one compiled executable and takes the slope between
two loop lengths, because per-call wall time through its remote TPU
backend was dominated by the relay; none of that applies to a local card,
where an event pair around each call reads the device's own clock.  Each
sample is the device time from the start event to the end event, so it
includes any gap in which the card waits for the host's next launch: a
call whose launches outrun the device measures its device time, one whose
host work dominates measures that.

On a CPU device (asked for by the caller, as the tests do) the samples
are ``time.perf_counter`` wall times instead.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import numpy as np
import torch

TIMED_RUNS = 20
WARMUP = 3


def median_ms(fn: Callable, runs: int = TIMED_RUNS, warmup: int = WARMUP,
              device="cuda") -> float:
    """Median milliseconds of ``runs`` calls of ``fn`` after ``warmup``
    calls: between CUDA events recorded on ``device``'s current stream
    around each call, or by ``time.perf_counter`` on a CPU device."""
    dev = torch.device(device)
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        samples = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(samples))
    stream = torch.cuda.current_stream(dev)
    torch.cuda.synchronize(dev)
    events = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        fn()
        end.record(stream)
        events.append((start, end))
    torch.cuda.synchronize(dev)
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bench_spmv(handle, x, runs: int = TIMED_RUNS,
               warmup: int = WARMUP) -> Tuple[float, np.ndarray]:
    """Seconds of one ``handle.run(x)``, and its result.

    ``x`` goes to the handle's device and is padded once (``_pad_x``), so
    the timed call is the run's own work: the matrix product at alpha 1
    with no y_in, on the device.  Returns ``(median seconds, y)`` with
    ``y`` [R] float32 on the host, from the first call."""
    xd = torch.as_tensor(x, dtype=torch.float32, device=handle.device)
    xp = handle._pad_x(xd)
    y = handle._matvec(xp).cpu().numpy()
    ms = median_ms(lambda: handle._matvec(xp), runs, warmup, handle.device)
    return ms * 1e-3, y
