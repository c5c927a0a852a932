"""One run of one cell: set-up, the measured window, the traced window,
the check, and the metrics by their readers.

Everything a cell is made of is found by name from ``BENCHMARK.json``
(``manifest.py``): the configuration's file, the traffic mix's file, the
limits of the check, and one reader a metric.  The program is reached
only through ``hispmv_tpu_torch.prepare`` and the handle's ``run`` and
``linear``.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
import types

import torch

from spmvbench import gen, manifest
from spmvbench.loop import Solver, sync
from spmvbench.reference import Bf16Stand, CsrReference, rel_errors
from spmvbench.roofline import peaks_for
from spmvbench.trace import Trace

class Matrix:
    """A configuration's matrix made from the seed on the device, handed
    to the program as a COO of host arrays, and kept apart (a second
    host copy) for the reference."""

    def __init__(self, config, seed, device):
        self.shape = (int(config["rows"]), int(config["cols"]))
        r, c, v = gen.generate(config, seed, device)
        self.nnz = int(v.numel())
        self.ref = (r.cpu().numpy(), c.cpu().numpy(), v.cpu().numpy())
        self.prog = (r.int().cpu().numpy(), c.int().cpu().numpy(),
                     v.cpu().numpy())
        del r, c, v

    def coo(self):
        from hispmv_tpu_torch.formats.matrix import COOMatrix

        return COOMatrix(self.shape, *self.prog)


def make_program(config, matrix, device, control=None):
    """The program under test for ``config``: ``prepare(...)`` of its
    format and ``SpmvConfig``, or a control in its place (``control``:
    ``"program_bf16"``, the program with bfloat16 values;
    ``"reference_bf16"``, the reference rounded to bfloat16)."""
    if control == "reference_bf16":
        return Bf16Stand(matrix.shape, *matrix.ref, device)
    from hispmv_tpu_torch import SpmvConfig, prepare

    fields = dict(config.get("spmv_config", {}))
    if control == "program_bf16":
        fields["value_dtype"] = "bfloat16"
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    return prepare(matrix.coo(), SpmvConfig(**fields),
                   format=config["format"], device=device)


NUMBERS = ("norm_rel_err", "l1_rel_err")  # see reference.rel_errors


def judge(spec, records, ref, nonfinite):
    """The check of a run: each number of ``reference.rel_errors`` over
    the kept calls ``records`` against the float64 reference ``ref``,
    beside its limit (``spec["limits"]``), with the solves whose scalar was
    not finite and the calls kept.  Returns (correct, the solves that
    failed, the numbers compared)."""
    traffic, limits = spec["traffic"], spec["limits"]
    run_restart = traffic["call"] == "run" and traffic["step"] == "restart"
    alpha = float(traffic.get("alpha", 1.0)) if run_restart else 1.0
    beta = float(traffic.get("beta", 0.0)) if run_restart else 0.0
    worst = {k: 0.0 if records else float("inf") for k in NUMBERS}
    wrong = set()
    for rec in records:
        errs = rel_errors(ref, rec.x, rec.y, rec.y_in, alpha, beta)
        for k in NUMBERS:
            worst[k] = max(worst[k], errs[k])
            if not errs[k] <= float(limits[k]):
                wrong.add(rec.solve)
    checks = {k: {"value": worst[k], "limit": float(limits[k])}
              for k in NUMBERS}
    checks["nonfinite_solves"] = {"value": nonfinite, "limit": 0}
    checks["checked_calls"] = {"value": len(records), "at_least": 1}
    correct = (bool(records) and nonfinite == 0
               and all(worst[k] <= float(limits[k]) for k in NUMBERS))
    return correct, len(wrong) + nonfinite, checks


def profiled(solver, solves, device):
    """The traced window: ``solves`` solves under ``torch.profiler`` (CPU
    and CUDA activity: the benchmark's spans are CPU annotations), after
    one solve in the same session outside the window's span, so that the
    profiler's first launches fall outside it; the Chrome trace goes to a
    temporary directory under ``TMPDIR`` and is read back and removed."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    tmp = tempfile.mkdtemp(prefix="spmvbench-")
    try:
        with profile(activities=acts) as prof:
            solver.solve(0, sample=False)
            solver.traced(solves)
            sync(device)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return Trace.load(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def free_device(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def measure(spec, program, shape, seed, seconds, trace, device, t0):
    """The cell's traffic on ``program``: warm-up, the measured window
    and, where ``trace``, the traced window.  ``setup_s`` runs from ``t0``
    to the end of the warm-up.  The solver holds the kept calls."""
    traffic = spec["traffic"]
    solver = Solver(program, shape, traffic, seed, device)
    solver.warm_up()
    setup_s = time.perf_counter() - t0
    solve_s, window_s, nonfinite = solver.window(seconds, timed=bool(trace))
    tr = profiled(solver, int(traffic.get("trace_solves", 4)), device) \
        if trace else None
    return types.SimpleNamespace(solver=solver, setup_s=setup_s,
                                 solve_s=solve_s, window_s=window_s,
                                 nonfinite=nonfinite, trace=tr)


def run_cell(spec, seed, seconds, trace, device, t0, control=None):
    """One run of the cell ``spec`` (``manifest.cell_spec``); ``t0`` is
    the ``perf_counter`` of the process's start.  Returns the result's
    fields, the checks last."""
    cuda = torch.device(device).type == "cuda"
    config, traffic = spec["config"], spec["traffic"]
    matrix = Matrix(config, seed, device)
    free_device(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    program = make_program(config, matrix, device, control)
    sync(device)
    prepare_s = time.perf_counter() - t
    m = measure(spec, program, matrix.shape, seed, seconds, trace, device,
                t0)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    solver, tr = m.solver, m.trace
    records = solver.kept()
    solver.program = None
    del program
    free_device(device)
    ref = CsrReference(matrix.shape, *matrix.ref, device)
    correct, failed, checks = judge(spec, records, ref, m.nonfinite)
    del ref

    ctx = types.SimpleNamespace(
        cell=spec["workload"], config=config, traffic=traffic,
        rows=matrix.shape[0], cols=matrix.shape[1], nnz=matrix.nnz,
        call=traffic["call"], batch=solver.batch,
        y_in=traffic["call"] == "run" and traffic["step"] == "restart",
        solve_s=m.solve_s, window_s=m.window_s,
        calls=len(m.solve_s) * solver.K,
        setup_s=m.setup_s, prepare_s=prepare_s,
        host_call_s=solver.call_s, host_calls=solver.calls_timed,
        trace=tr,
        peaks=peaks_for(torch.cuda.get_device_name(device)) if cuda
        else None)
    metrics = {}
    for metric in spec["per_layer" if trace else "end_to_end"]:
        value = manifest.reader(metric["name"])(ctx)
        if value is not None:
            metrics[metric["name"]] = {"value": float(value),
                                       "unit": metric["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    out = {"correct": correct, "attempted": len(m.solve_s),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if tr is not None:
        out["breakdown"] = {"device_ops": tr.top_device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = checks
    return out
