"""A run with the timed path broken underneath reads ``correct`` false.

Each test drives the whole of a run but the look for a card (``core.
run_cell`` on the CPU, where the program's kernel wrappers run their plain
versions) at a small size and three calls a solve, with one fault planted in the program's
``run`` or ``linear``: the state returned unchanged, half of the batch
left out (the mean of the rest in its place), one answer altered where it
is produced, and the half of the rows with the smallest answers lost
(a fault that the widest gap alone can miss).  The same run without the fault reads ``correct`` true.
"""

import time

import pytest
import torch

from hispmv_tpu_torch.api.handle import SpmvHandle
from spmvbench import core
from spmvbench.tests.helpers import CELLS, cell_spec


def _unchanged(y, x):
    return x.clone()


def _half_batch(y, x):
    y = y.clone()
    half = y.shape[0] // 2
    y[half:] = y[:half].mean(dim=0)
    return y


def _altered(y, x):
    y = y.contiguous().clone()
    flat = y.view(-1)
    flat[int(flat.abs().argmax())] = 0.0
    return y


def _small_rows_lost(y, x):
    y = y.contiguous().clone()
    vectors = y.view(-1, y.shape[-1])
    order = vectors.abs().argsort(dim=1)[:, : y.shape[-1] // 2]
    vectors.scatter_(1, order, 0.0)
    return y


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "altered": _altered, "small_rows_lost": _small_rows_lost}


def _plant(monkeypatch, fault):
    run, linear = SpmvHandle.run, SpmvHandle.linear

    def bad_run(self, x, y_in=None, alpha=1.0, beta=0.0):
        return fault(run(self, x, y_in, alpha, beta), torch.as_tensor(x))

    def bad_linear(self, x_batch, bias=None):
        return fault(linear(self, x_batch, bias), torch.as_tensor(x_batch))

    monkeypatch.setattr(SpmvHandle, "run", bad_run)
    monkeypatch.setattr(SpmvHandle, "linear", bad_linear)


def _run(cell, seed=2**31 + 99):
    out = core.run_cell(cell_spec(cell, iterations=3), seed, 0.2, 0, "cpu",
                        time.perf_counter())
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(out)[-1] == "checks"
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["checked_calls"]["value"] >= 1
    assert "setup_s" in out["metrics"]


CASES = [(cell, f) for cell in CELLS for f in FAULTS
         if f != "half_batch" or cell_spec(cell)["traffic"]["call"] ==
         "linear"]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    _plant(monkeypatch, FAULTS[fault])
    out = _run(cell)
    assert out["correct"] is False
    checks = out["checks"]
    assert any(checks[k]["value"] > checks[k]["limit"] for k in core.NUMBERS)
