"""The one general solver loop that every traffic mix parameterises.

A closed loop: one solver process enqueues the K dependent calls of a
solve, then synchronises once, reading one scalar; the next solve starts
when that read returns.  A traffic file sets:

- ``call``: ``"run"`` (one vector) or ``"linear"`` (a batch of ``batch``);
- ``iterations``: K, the calls a solve;
- ``step``: ``"normalize"`` (power iteration: each vector scaled to unit
  norm after each call) or ``"restart"`` (personalized PageRank:
  ``x <- alpha A x + beta e_u``; through ``run``'s ``y_in`` for one
  vector, as ``alpha linear(X) + beta E`` for a batch);
- ``start``: ``"randn"`` (start vectors drawn from the seed) or
  ``"users"`` (one-hot rows of users drawn Zipf(``zipf_s``) over the
  rows from the seed, also the start);
- ``readout``: the scalar of the synchronise, ``"norm"`` or
  ``"l1_change"`` (of the last step);
- ``pool``: how many start vectors or user sets are made at set-up;
- ``sample_solves``: how many solves a run keeps for the check, by
  reservoir sampling drawn from the seed; of each, the last call and one
  drawn at random are kept (input, output, and ``y_in``);
- ``trace_solves``: the solves of the traced window.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

SPAN = "spmvbench."


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def zipf_rows(rows: int, count: int, s: float, rng) -> np.ndarray:
    """``count`` row ids drawn Zipf(``s``) over ranks 1..rows, each rank
    a row by a permutation drawn from ``rng``."""
    w = np.cumsum(1.0 / np.arange(1, rows + 1, dtype=np.float64) ** s)
    rank = np.searchsorted(w, rng.random(count) * w[-1], side="right")
    return rng.permutation(rows)[np.minimum(rank, rows - 1)]


class Record:
    """One call of the program kept for the check: its input, output and
    ``y_in``, held by reference (every one is a tensor of its own), so
    that keeping a call costs the window no copy."""

    def __init__(self, solve, x, y, y_in):
        self.solve, self.x, self.y, self.y_in = solve, x, y, y_in


class Solver:
    """The traffic mix ``traffic`` on the program ``program`` (an object
    with ``run`` and ``linear`` as ``SpmvHandle`` has them) for a matrix of
    ``shape``, made from ``seed`` on ``device``."""

    def __init__(self, program, shape, traffic, seed, device):
        self.program = program
        self.rows, self.cols = shape
        if self.rows != self.cols:
            raise ValueError("the solvers iterate a square matrix")
        self.t = traffic
        self.device = device
        self.K = int(traffic["iterations"])
        self.batch = int(traffic.get("batch", 1))
        self.linear = traffic["call"] == "linear"
        if not self.linear and self.batch != 1:
            raise ValueError("a run call takes one vector")
        self.restart = traffic["step"] == "restart"
        self.alpha = float(traffic.get("alpha", 1.0))
        self.beta = float(traffic.get("beta", 0.0))
        self.rng = np.random.default_rng([int(seed) % (1 << 63), 1])
        gen = torch.Generator(device=device)
        gen.manual_seed((int(seed) * 2654435761 + 7) % (1 << 63))
        pool = int(traffic.get("pool", 4))
        vshape = (self.batch, self.cols) if self.linear else (self.cols,)
        if traffic["start"] == "randn":
            self.starts = []
            for _ in range(pool):
                x = torch.randn(vshape, generator=gen, device=device)
                self.starts.append(self._normalize(x))
            self.users = None
        elif traffic["start"] == "users":
            users = zipf_rows(self.rows, pool * self.batch,
                              float(traffic.get("zipf_s", 1.0)), self.rng)
            users = users.reshape(pool, self.batch)
            flat = users + np.arange(self.batch)[None, :] * self.rows
            self.users = torch.from_numpy(flat).to(device)
            self.starts = None
        else:
            raise ValueError(f"unknown start {traffic['start']!r}")
        self.with_y_in = self.restart and not self.linear
        self.records = [[] for _ in range(int(traffic.get("sample_solves",
                                                          4)))]
        self.solves_seen = 0
        self.call_s = 0.0  # host time inside the program's calls
        self.calls_timed = 0

    # -- one solve ------------------------------------------------------

    def _normalize(self, y):
        if y.ndim == 1:
            return y / y.norm()
        return y / y.norm(dim=1, keepdim=True)

    def _start(self, i):
        if self.users is None:
            return self.starts[i % len(self.starts)], None
        e = torch.zeros(self.batch * self.rows, device=self.device)
        e.index_fill_(0, self.users[i % len(self.users)], 1.0)
        if self.linear:
            e = e.view(self.batch, self.rows)
        return e, e

    def _call(self, x, e, timed):
        t0 = time.perf_counter() if timed else 0.0
        if self.linear:
            y = self.program.linear(x)
        elif self.restart:
            y = self.program.run(x, y_in=e, alpha=self.alpha, beta=self.beta)
        else:
            y = self.program.run(x)
        if timed:
            self.call_s += time.perf_counter() - t0
            self.calls_timed += 1
        return y

    def _slot(self):
        """The reservoir slot of the next solve (None: not kept)."""
        i, k = self.solves_seen, len(self.records)
        self.solves_seen += 1
        if i < k:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < k else None

    def solve(self, i, sample=True, timed=False, spans=False):
        """Solve ``i``: K calls enqueued, one synchronise; returns the
        scalar read."""
        slot = self._slot() if sample else None
        pick = -1
        if slot is not None:
            pick = int(self.rng.integers(0, self.K))
            self.records[slot] = []
        x, e = self._start(i)
        name = "linear" if self.linear else "run"
        readout = None
        for k in range(self.K):
            if spans:
                with record_function(SPAN + name):
                    y = self._call(x, e, timed)
                with record_function(SPAN + "update"):
                    x_new = self._update(y, e)
            else:
                y = self._call(x, e, timed)
                x_new = self._update(y, e)
            if slot is not None and k in (pick, self.K - 1):
                self.records[slot].append(
                    Record(i, x, y, e if self.with_y_in else None))
            if k == self.K - 1:
                readout = self._readout(x, x_new)
            x = x_new
        if spans:
            with record_function(SPAN + "sync"):
                return float(readout.item())
        return float(readout.item())

    def _update(self, y, e):
        if not self.restart:
            return self._normalize(y)
        if self.linear:
            return self.alpha * y + self.beta * e
        return y  # run already applied alpha and beta

    def _readout(self, x, x_new):
        if self.t.get("readout", "norm") == "l1_change":
            return (x_new - x).abs().sum()
        return x_new.norm()

    # -- windows --------------------------------------------------------

    def warm_up(self):
        """As many solves as there are sample slots, and one more, kept
        and then forgotten: every shape of the window has run once, and
        the allocator's pool holds what the kept calls will."""
        for i in range(len(self.records) + 1):
            self.solve(i)
        sync(self.device)
        self.solves_seen = 0
        self.records = [[] for _ in self.records]
        self.call_s, self.calls_timed = 0.0, 0

    def window(self, seconds, timed=False):
        """Solves until ``seconds`` have passed; returns (the seconds
        each solve took, the window's seconds, the solves whose scalar
        was not finite)."""
        times, bad = [], 0
        t_start = time.perf_counter()
        i = 0
        while True:
            s0 = time.perf_counter()
            v = self.solve(i, timed=timed)
            s1 = time.perf_counter()
            times.append(s1 - s0)
            bad += not np.isfinite(v)
            i += 1
            if s1 - t_start >= seconds:
                return times, s1 - t_start, bad

    def traced(self, solves):
        """``solves`` solves inside the profiler's window span."""
        with record_function(SPAN + "window"):
            for i in range(solves):
                with record_function(SPAN + "solve"):
                    self.solve(i, sample=False, spans=True)

    def kept(self):
        """The records of the kept solves."""
        return [rec for slot in self.records for rec in slot]
