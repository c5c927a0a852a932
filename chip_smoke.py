#!/usr/bin/env python3
"""Smoke run of hispmv_tpu_torch on one CUDA card (written for an H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``hispmv_tpu_torch/csrc/``
(B1-B13), then drives seven paths of the port, each run with the launch
counts zeroed just before it and read just after:

- ``prepare`` -> ``SpmvHandle.run`` and ``Accelerator`` (formats window,
  ellx, block, dense and routed, the latter in original and rank space) on
  full-scale suite stand-ins;
- ``SpmvHandle.linear`` / ``Accelerator.linear`` on those handles at a
  batch of 64 (8 for the ELLX base; TSOPF_RS_b2383 also at 8, where the
  block handle's batch fits its budget and runs B2 instead of B6), with a
  bias;
- the three-layer MLP at full width (4096 -> 8192 -> 8192 -> 1024, density
  0.1) swapped onto the card by ``AcceleratorLayerManager``, at batches of
  64 and 1;
- the sharded executors of ``dist`` (per-block with x gathered, chunked
  with the x ring and replicated, windowed) on TSOPF_RS_b2383 and crystk03
  over a mesh that repeats the one card four times, and over one card, then
  ``dryrun_multichip``; on distinct cards too when there are two or more;
- the ``ops`` entry: the one-shot ``spmv_block`` (B5) and B6 at a batch of
  64 on TSOPF_RS_b2383, beside the handle's ``run`` (B1) and ``linear``;
- block matrices past the chunked layout's budget: a Flan_1565-sized one
  in the x- and y-paneled layout (``run`` through B4, which reads only the
  sectors its handle's sector mask marks live, ``linear`` at B 64 through
  B6) and a 200,000 x 5,120,000 one in the x-paneled layout (``run``
  through B3);
- the routed format's gathered side-plan on the analytics stand-in, with
  the gathered executor's modelled cost lowered so that the planner diverts
  its scattered tiles: ``run`` through B12, B11 twice, B13 and B9, and
  ``linear`` at B 8 vector by vector.

Every result is held to a float64 golden at rtol 1e-3.  Then each kernel
is compared with its plain PyTorch version on the arrays the paths gave it
and both are timed beside the kernel's bound (bytes over the HBM rate or
fp32 operations over the FMA rate, whichever is larger) and, where one
PyTorch call computes the same function (a CSR product, ``index_select``),
that call; the rank-space permutation is timed beside a direct
``index_select`` and the gathered executor's chain (B12, B11, B11, B13)
beside a CSR product of the nonzeros it takes.  B9 (every stream of a
routed part in one launch) is held on each stream of trans5 and ford2
alone and on the whole routed part of trans5, ford2, language (rank
space) and analytics (gathered), against the plain sum of its streams,
beside its must-read bound (each tile's live boundary rows, by the plan's
lt; its packed bound beside it) and a CSR product of exactly the nonzeros
it covers (the matrix less its residual and its gathered side-plan, in
the launch's coordinates).  B10 (the routed stream against a batch) is also timed at each V it is built for (vectors a
thread: 4, 8), with x = 0 (no atomic issued) and beside the zeroing of
its y, and each routed ``linear`` line carries the sum of B10's device
time over the handle's streams beside cuSPARSE SpMM of the whole matrix.
B2 is also run directly on TSOPF_RS_b2383's arrays at B 64 and timed at V
4 and 8 on each of its cases, and B8 (x vector-minor, as B2's and B10's)
likewise on crystk03's window handle and the MLP's fc3 at B 64.  B1 and B7
(B2's and B8's kernel at one vector) are timed at V 1 and 4 on each of
their cases, and their lines name V, the row slices and the CTAs, as B3's
(the same kernel at V 1 with each chunk's x panel offset) do.  The B 64
``linear`` of the Flan_1565-sized matrix (B6) is logged beside B6's
bound on its arrays; B6's lines name its launch shape (warps a CTA, row
slices, CTAs) and its longest run.  B4 runs with its handle's sector mask
and is held both to its plain version with that mask and to the plain
version without one (the true product, so a wrong mask shows); its bound
is the must-read one (the live sectors the mask marks, the mask, meta, x
and y), and its line gives the bound of its arrays as packed beside it.
It exits nonzero, without a result line, when there is
no CUDA card or any check fails.  The last line of standard output is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import hispmv_tpu_torch.ops as ops
from hispmv_tpu_torch import Accelerator, SpmvConfig, prepare
from hispmv_tpu_torch.dist import (
    build_sharded_block_plan,
    build_sharded_chunked_plan,
    build_sharded_window_plan,
    make_mesh,
    spmv_sharded,
    spmv_sharded_chunked,
    spmv_sharded_window,
    to_device,
)
from hispmv_tpu_torch.dist.dryrun import dryrun_multichip
from hispmv_tpu_torch.dist.shard import device_bytes
from hispmv_tpu_torch.formats.synth import blocked_coo, suite_matrix
from hispmv_tpu_torch.models import (
    AcceleratorLayerManager,
    ThreeLayerFCModel,
    compare_model_outputs,
)
from hispmv_tpu_torch.ops import cuda_build
from hispmv_tpu_torch.ops.permute import (
    clos_gather,
    panel_permute_apply_from,
    permute_apply,
    permute_stage,
    permute_stage_plain,
)
from hispmv_tpu_torch.ops.spmv_block import (
    block_batched_grid,
    spmv_block_batched,
    spmv_block_batched_plain,
    spmv_block_stream,
    spmv_block_stream_plain,
    upload_block_plan,
)
from hispmv_tpu_torch.ops.spmv_chunked import (
    chunk_for,
    chunked_batched_grid,
    chunked_paneled_grid,
    chunked_tiled_grid,
    pack_chunks_paneled,
    spmv_chunked,
    spmv_chunked_batched,
    spmv_chunked_batched_plain,
    spmv_chunked_paneled,
    spmv_chunked_paneled_plain,
    spmv_chunked_plain,
    spmv_chunked_tiled,
    spmv_chunked_tiled_plain,
)
from hispmv_tpu_torch.ops.spmv_gathered import (
    gathered_gather_apply,
    s1_gather,
    s1_gather_plain,
    spmv_gathered_tiles,
    spmv_gathered_tiles_plain,
)
from hispmv_tpu_torch.ops.spmv_routed import (
    spmv_routed_stream,
    spmv_routed_stream_batched,
    spmv_routed_stream_batched_plain,
    routed_batched_v,
    spmv_routed_stream_plain,
    RoutedTable,
    routed_table,
    spmv_routed_streams,
    spmv_routed_streams_plain,
    stream_array_names,
)
from hispmv_tpu_torch.ops.spmv_windowed import (
    spmv_windowed,
    spmv_windowed_batched,
    spmv_windowed_batched_plain,
    spmv_windowed_plain,
    windowed_batched_grid,
)
from hispmv_tpu_torch.plan import gathered as gathered_plan
from hispmv_tpu_torch.utils.errors import error_stats

SEED = 0
ALPHA, BETA = 1.5, -0.5
RTOL = 1e-3  # the reference's acceptance (utils/errors.py)
KERNEL_RTOL = 1e-5  # kernel vs plain: fp32 both, only the summation order
# linear outputs against the float64 golden: rtol 1e-3 plus an absolute
# floor of 1e-5 of the largest |y|, since an fp32 sum of K terms errs by
# ~eps*sqrt(K) of the output's scale, and among a batch's millions of
# outputs some cancel to near zero
GOLDEN_ATOL = 1e-5
TIMED_RUNS = 20

# (label, fixture, config, format asked, format expected, kernels expected)
SPARSE_RUNS = [
    ("crystk03 auto", "crystk03", SpmvConfig(), "auto", "window",
     ("spmv_windowed",)),
    ("crystk03 window bh64", "crystk03", SpmvConfig(block_h=64), "window",
     "window", ("spmv_windowed",)),
    ("trans5 auto", "trans5", SpmvConfig(), "auto", "ellx",
     ("spmv_chunked",)),
    ("TSOPF_RS_b2383 block", "TSOPF_RS_b2383", SpmvConfig(), "block",
     "block", ("spmv_chunked",)),
    ("trans5 routed", "trans5", SpmvConfig(), "routed", "routed",
     ("spmv_routed",)),
    ("ford2 routed", "ford2", SpmvConfig(), "routed", "routed",
     ("spmv_routed",)),
    ("language routed rank", "language", SpmvConfig(rank_sort=True),
     "routed", "routed", ("spmv_routed", "permute_stage")),
]
DENSE_N = 4096
SPARSE_NAME = {r[0]: r[1] for r in SPARSE_RUNS}

BATCH = 64
# (label, handle of the main path, batch, kernels expected)
LINEAR_RUNS = [
    ("TSOPF_RS_b2383 block linear", "TSOPF_RS_b2383 block", BATCH,
     ("spmv_block_batched",)),
    # last of TSOPF's: phase 4 holds B2 to this batch
    ("TSOPF_RS_b2383 block linear B 8", "TSOPF_RS_b2383 block", 8,
     ("spmv_chunked_batched",)),
    ("trans5 ellx linear", "trans5 auto", 8, ("spmv_chunked_batched",)),
    ("crystk03 auto linear", "crystk03 auto", BATCH,
     ("spmv_windowed_batched",)),
    ("trans5 routed linear", "trans5 routed", BATCH,
     ("spmv_routed_batched",)),
    ("ford2 routed linear", "ford2 routed", BATCH, ("spmv_routed_batched",)),
    ("language routed rank linear", "language routed rank", BATCH,
     ("spmv_routed", "permute_stage")),
]
# the model of hispmv_tpu/models/demo.py at full width
MLP = {"input": 4096, "hidden": 8192, "out": 1024, "density": 0.1}
MLP_BATCHES = (64, 1)
MLP_FORMATS = ["dense", "ellx", "window"]

# sharded paths: meshes that repeat the one card, and the runs on each
SHARD_MESHES = [("cuda:0",) * 4, ("cuda:0",)]
# (label, fixture, plan kind, x_mode, single-device handle of the main path)
SHARDED_RUNS = [
    ("TSOPF_RS_b2383 block gather", "TSOPF_RS_b2383", "block", "gather",
     "TSOPF_RS_b2383 block"),
    ("TSOPF_RS_b2383 chunked ring", "TSOPF_RS_b2383", "chunked", "ring",
     "TSOPF_RS_b2383 block"),
    ("TSOPF_RS_b2383 chunked replicated", "TSOPF_RS_b2383", "chunked",
     "replicated", "TSOPF_RS_b2383 block"),
    ("crystk03 window replicated", "crystk03", "window", "replicated",
     "crystk03 auto"),
]
SHARD_KINDS = {  # plan builder, executor, kernel, launches per call of D
    "block": (lambda coo, D: build_sharded_block_plan(coo, D), spmv_sharded,
              "spmv_block", lambda D: D),
    "chunked": (lambda coo, D: build_sharded_chunked_plan(
        coo, D, chunk=min(chunk_for(8), 128)), spmv_sharded_chunked,
        "spmv_chunked_paneled", lambda D: D * D),
    "window": (lambda coo, D: build_sharded_window_plan(coo, D),
               spmv_sharded_window, "spmv_windowed", lambda D: D),
}
MAX_BALANCE = 1.3  # max/mean device load of the nnz-balanced planners
PANEL_NCB = 64  # x panel of the multi-panel B3 check (8192 columns)

# phase 3f: block matrices past the chunked layout's budget, the JAX
# handle's dispatch with its constants.  (label, rows, cols, nonzeros
# before dedup, layout, kernel of run, linear batch or None); the first is
# SuiteSparse Janna/Flan_1565's size, the second tests/test_api.py's wide
# shape.
LARGE_BLOCK_RUNS = [
    ("Flan_1565-sized block", 1_564_794, 1_564_794, 114_165_372, "tiled",
     "spmv_chunked_tiled", BATCH),
    ("200000x5120000 block", 200_000, 5_120_000, 14_600_000, "paneled",
     "spmv_chunked_paneled", None),
]
# phase 3g: the gathered side-plan, diverted with cheap modelled costs
GATHERED_FIXTURE = "analytics"
GATHERED_COSTS = {"GATH_TILE_NS": 1.0, "GATH_STAGE_NS": 1.0}
GATHERED_BATCH = 8

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bandwidth and
# fp32 rate outside the tensor cores (an FMA counts as two operations).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

KERNELS = {
    "spmv_chunked": {
        "wrapper": spmv_chunked,
        "source": "hispmv_tpu_torch/csrc/spmv_chunked.cu",
        "replaces": "hispmv_tpu/ops/spmv_chunked.py:89",
    },
    "spmv_windowed": {
        "wrapper": spmv_windowed,
        "source": "hispmv_tpu_torch/csrc/spmv_windowed.cu",
        "replaces": "hispmv_tpu/ops/spmv_windowed.py:60",
    },
    "spmv_routed": {  # B9: every stream of a routed part in one launch
        "wrapper": spmv_routed_streams,
        "source": "hispmv_tpu_torch/csrc/spmv_routed.cu",
        "replaces": "hispmv_tpu/ops/spmv_routed.py:301",
    },
    "permute_stage": {
        "wrapper": permute_stage,
        "source": "hispmv_tpu_torch/csrc/permute.cu",
        "replaces": "hispmv_tpu/ops/permute.py:58",
    },
    "spmv_chunked_batched": {
        "wrapper": spmv_chunked_batched,
        "source": "hispmv_tpu_torch/csrc/spmv_chunked_batched.cu",
        "replaces": "hispmv_tpu/ops/spmv_chunked.py:240",
    },
    "spmv_windowed_batched": {
        "wrapper": spmv_windowed_batched,
        "source": "hispmv_tpu_torch/csrc/spmv_windowed_batched.cu",
        "replaces": "hispmv_tpu/ops/spmv_windowed.py:211",
    },
    "spmv_routed_batched": {
        "wrapper": spmv_routed_stream_batched,
        "source": "hispmv_tpu_torch/csrc/spmv_routed.cu",
        "replaces": "hispmv_tpu/ops/spmv_routed.py:469",
    },
    "spmv_chunked_paneled": {
        "wrapper": spmv_chunked_paneled,
        "source": "hispmv_tpu_torch/csrc/spmv_chunked_paneled.cu",
        "replaces": "hispmv_tpu/ops/spmv_chunked.py:417",
    },
    "spmv_block": {
        "wrapper": spmv_block_stream,
        "source": "hispmv_tpu_torch/csrc/spmv_block.cu",
        "replaces": "hispmv_tpu/ops/spmv_block.py:36",
    },
    "spmv_block_batched": {
        "wrapper": spmv_block_batched,
        "source": "hispmv_tpu_torch/csrc/spmv_block.cu",
        "replaces": "hispmv_tpu/ops/spmv_block.py:215",
    },
    "spmv_chunked_tiled": {
        "wrapper": spmv_chunked_tiled,
        "source": "hispmv_tpu_torch/csrc/spmv_chunked_tiled.cu",
        "replaces": "hispmv_tpu/ops/spmv_chunked.py:615",
    },
    "s1_gather": {
        "wrapper": s1_gather,
        "source": "hispmv_tpu_torch/csrc/spmv_gathered.cu",
        "replaces": "hispmv_tpu/ops/spmv_gathered.py:55",
    },
    "spmv_gathered": {
        "wrapper": spmv_gathered_tiles,
        "source": "hispmv_tpu_torch/csrc/spmv_gathered.cu",
        "replaces": "hispmv_tpu/ops/spmv_gathered.py:179",
    },
}
# phase 4's cases that call a kernel of KERNELS through another entry
# point: B9 on one stream (a one-entry table, every layer) and on a whole
# routed part
CASE_KERNEL = {"spmv_routed_part": "spmv_routed"}
CALL = {"spmv_routed": spmv_routed_stream,
        "spmv_routed_part": spmv_routed_streams}
PLAIN = {"spmv_chunked": spmv_chunked_plain,
         "spmv_windowed": spmv_windowed_plain,
         "spmv_routed": spmv_routed_stream_plain,
         "spmv_routed_part": spmv_routed_streams_plain,
         "permute_stage": permute_stage_plain,
         "spmv_chunked_batched": spmv_chunked_batched_plain,
         "spmv_windowed_batched": spmv_windowed_batched_plain,
         "spmv_routed_batched": spmv_routed_stream_batched_plain,
         "spmv_chunked_paneled": spmv_chunked_paneled_plain,
         "spmv_block": spmv_block_stream_plain,
         "spmv_block_batched": spmv_block_batched_plain,
         "spmv_chunked_tiled": spmv_chunked_tiled_plain,
         "s1_gather": s1_gather_plain,
         "spmv_gathered": spmv_gathered_tiles_plain}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def launches() -> dict:
    return {n: k["wrapper"].launches for n, k in KERNELS.items()}


def zero_launches() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def median_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median over ``runs`` calls of the device time between CUDA events
    recorded around each call (host gaps included when the host lags)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def device_ms(fn, runs: int = TIMED_RUNS, tries: int = 3):
    """Device busy time per call: the self device time of every kernel,
    copy and fill that torch.profiler records over ``runs`` calls, summed,
    over ``runs``; a window in which the profiler records no device time
    is taken again, up to ``tries`` windows, then None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total
                       for e in prof.key_averages())
        if total_us > 0:
            return total_us / runs / 1e3
    return None


def _ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def inputs(rows: int, cols: int, rng):
    x = rng.standard_normal(cols).astype(np.float32)
    y_in = rng.standard_normal(rows).astype(np.float32)
    return x, y_in


def check_run(label, y, want, handle, failures):
    """Hold the alpha/beta result and ``verify()`` to the golden."""
    st = error_stats(y.cpu().numpy(), want, rtol=RTOL)
    vf = handle.verify(rtol=RTOL)
    log(f"  {label}: axpby max rel err {st.max_rel_error:.3e} "
        f"({st.num_mismatches} mismatches), verify() max rel err "
        f"{vf.max_rel_error:.3e} ({vf.num_mismatches} mismatches)")
    if not st.ok:
        failures.append(f"{label}: alpha/beta result off the golden")
    if not vf.ok:
        failures.append(f"{label}: verify() failed")
    if y.shape != want.shape or not torch.isfinite(y).all():
        failures.append(f"{label}: output of shape {tuple(y.shape)} is not "
                        f"{want.shape} and finite")


def routed_checks(label, h, once, failures):
    """What each routed run must show, from the launches of ONE run."""
    nstreams = len(h.plan.streams)
    meta = h._routed_meta
    log(f"  {label}: streams (tiles, W, l1, lmax) "
        f"{[(s.num_tiles, s.wmax, s.l1, s.lmax) for s in h.plan.streams]}, "
        f"residual {len(h.plan.residual_vals)} nnz "
        f"({'COO' if meta['res_coo'] else 'ELLX' if meta['res'] else 'none'}"
        f"), launches of one run {once}")
    if once["spmv_routed"] != 1:  # one launch runs every stream
        failures.append(f"{label}: {once['spmv_routed']} B9 launches for "
                        f"{nstreams} streams, want 1")
    if label.startswith("trans5") and not meta["res_coo"]:
        failures.append(f"{label}: no COO residual")
    if label.startswith("ford2") and any(s.l1 != 1 for s in h.plan.streams):
        failures.append(f"{label}: a stream with l1 > 1")
    want_perm = 6 if h.config.rank_sort else 0  # 3 stages, x in and y out
    if once["permute_stage"] != want_perm:
        failures.append(f"{label}: {once['permute_stage']} B11 launches, "
                        f"want {want_perm}")


def main_path(fixtures, failures):
    """Drive prepare -> run (and Accelerator) once per configuration; the
    kernels' launch counts are zeroed just before each run and read just
    after it.  Returns the handles, the run rows and the launch counts
    summed over the runs."""
    rng = np.random.default_rng(SEED)
    handles, rows_out = {}, []
    counts = dict.fromkeys(KERNELS, 0)
    for label, name, cfg, fmt, want_fmt, kernels in SPARSE_RUNS:
        coo = fixtures[name]
        zero_launches()
        t0 = time.perf_counter()
        h = prepare(coo, cfg, fmt)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        if h.format != want_fmt:
            failures.append(f"{label}: format {h.format}, want {want_fmt}")
        if want_fmt == "ellx" and "odata" not in h._d:
            failures.append(f"{label}: no ELLX overflow stream")
        x, y_in = inputs(coo.num_rows, coo.num_cols, rng)
        xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y_in).cuda()
        y = h.run(xd, yd, ALPHA, BETA)
        torch.cuda.synchronize()
        once = launches()
        want = ALPHA * coo.matvec(x.astype(np.float64)) + BETA * y_in
        check_run(label, y, want, h, failures)
        ms = median_ms(lambda: h.run(xd, yd, ALPHA, BETA))
        used = launches()
        for n in kernels:
            if used[n] == 0:
                failures.append(f"{label}: {n} was not launched")
        if want_fmt == "routed":
            routed_checks(label, h, once, failures)
        for n, c in used.items():
            counts[n] += c
        a = csr_of(name, coo)
        lib_ms = median_ms(lambda: a @ xd)
        rows_out.append(_row(label, h, coo.nnz, coo.num_rows, prep_s, ms,
                             used, lib_ms))
        handles[label] = (h, xd)

    # dense overlay through the Accelerator
    label = f"dense {DENSE_N}x{DENSE_N} Accelerator"
    w = rng.standard_normal((DENSE_N, DENSE_N)).astype(np.float32)
    zero_launches()
    acc = Accelerator()
    t0 = time.perf_counter()
    mid = acc.create_dense_handle(w)
    acc.load_matrices()
    prep_s = time.perf_counter() - t0
    acc.select_matrix(mid)
    x, y_in = inputs(DENSE_N, DENSE_N, rng)
    xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y_in).cuda()
    y = acc.run_kernel(xd, yd, ALPHA, BETA)
    torch.cuda.synchronize()
    want = (ALPHA * (w.astype(np.float64) @ x.astype(np.float64))
            + BETA * y_in)
    check_run(label, y, want, acc.handle(mid), failures)
    ms = median_ms(lambda: acc.run_kernel(xd, yd, ALPHA, BETA))
    used = launches()
    rows_out.append(_row(label, acc.handle(mid), DENSE_N * DENSE_N, DENSE_N,
                         prep_s, ms, used))
    for n, c in used.items():
        counts[n] += c
    handles["dense"] = (acc, mid)
    return handles, rows_out, counts


def _row(label, h, nnz, rows, prep_s, ms, used, lib_ms=None):
    gflops = 2.0 * (nnz + rows) / (ms * 1e-3) / 1e9
    row = {
        "run": label, "format": h.format, "nnz": int(nnz),
        "prepare_s": prep_s, "device_mb": h.device_bytes / 2**20,
        "launches": used, "run_ms": ms, "gflops": gflops,
        "library_ms": lib_ms,
    }
    lib = "" if lib_ms is None else f", CSR A @ x {lib_ms:.4f} ms"
    log(f"  {label}: format {h.format}, nnz {nnz}, prepare {prep_s:.2f} s, "
        f"device {row['device_mb']:.1f} MB, launches {used}, "
        f"median run {ms:.4f} ms, {gflops:.2f} GFLOP/s{lib}")
    return row


_CSR: dict = {}


def csr_of(name, coo):
    """Fixture ``name`` as a CSR tensor on the card, the operand of the
    library's (cuSPARSE) product that each run is timed beside."""
    if name not in _CSR:
        m = coo.to_scipy().tocsr()
        _CSR[name] = torch.sparse_csr_tensor(
            torch.from_numpy(m.indptr.astype(np.int64)),
            torch.from_numpy(m.indices.astype(np.int64)),
            torch.from_numpy(m.data.astype(np.float32)), size=m.shape,
        ).cuda()
    return _CSR[name]


def linear_checks(label, h, B, once, failures):
    """Launch counts of ONE linear call: B10 once per stream for the whole
    batch; B9 once and B11 six times per vector in rank space."""
    if h.format != "routed":
        return
    nstreams = len(h.plan.streams)
    want = {"spmv_routed_batched": nstreams, "spmv_routed": 0,
            "permute_stage": 0}
    if h.config.rank_sort:
        want = {"spmv_routed_batched": 0, "spmv_routed": B,
                "permute_stage": B * 6}
    for n, c in want.items():
        if once[n] != c:
            failures.append(f"{label}: {once[n]} {n} launches in one call, "
                            f"want {c}")


def linear_path(handles, fixtures, counts, failures):
    """Drive ``linear`` on the main path's handles (and the dense one
    through ``Accelerator.linear``), each held to the float64 golden
    ``A @ xb.T + bias``; counts zeroed before each run, read after."""
    rng = np.random.default_rng(SEED + 1)
    rows_out, inputs_used = [], {}
    runs = LINEAR_RUNS + [(f"dense {DENSE_N}x{DENSE_N} Accelerator.linear",
                           "dense", BATCH, ())]
    for label, key, B, kernels in runs:
        if key == "dense":
            acc, mid = handles["dense"]
            h = acc.handle(mid)
            dense = h._dense.cpu().numpy()[:DENSE_N, :DENSE_N]
            golden_a = dense.astype(np.float64)
            nnz = DENSE_N * DENSE_N

            def call(xd, bd, acc=acc, mid=mid):
                return acc.linear(mid, xd, bd)
        else:
            h, _ = handles[key]
            coo = fixtures[SPARSE_NAME[key]]
            golden_a = coo.to_scipy()
            nnz = coo.nnz
            a_csr = csr_of(SPARSE_NAME[key], coo)

            def call(xd, bd, h=h):
                return h.linear(xd, bd)
        R, C = h.shape
        xb = rng.standard_normal((B, C)).astype(np.float32)
        bias = rng.standard_normal(R).astype(np.float32)
        xd = torch.from_numpy(xb).cuda()
        bd = torch.from_numpy(bias).cuda()
        zero_launches()
        y = call(xd, bd)
        torch.cuda.synchronize()
        once = launches()
        want = (golden_a @ xb.astype(np.float64).T).T + bias
        got = y.cpu().numpy()
        atol = GOLDEN_ATOL * float(np.abs(want).max())
        st = error_stats(got, want, rtol=RTOL, atol=atol)
        slack = np.abs(got - want) / (atol + RTOL * np.abs(want))
        worst = np.unravel_index(np.argmax(slack), want.shape)
        log(f"  {label}: B {B}, max abs err {st.max_abs_error:.3e} (max |y| "
            f"{np.abs(want).max():.3e}), {st.num_mismatches} past rtol "
            f"{RTOL} + atol {atol:.2e}; closest to the bound: y{list(worst)} "
            f"= {got[worst]:.6e}, golden {want[worst]:.6e}; launches of one "
            f"call {once}")
        if not st.ok:
            failures.append(f"{label}: linear off the golden")
        if y.shape != (B, R) or not torch.isfinite(y).all():
            failures.append(f"{label}: output of shape {tuple(y.shape)} is "
                            f"not ({B}, {R}) and finite")
        linear_checks(label, h, B, once, failures)
        ms = median_ms(lambda: call(xd, bd))
        used = launches()
        for n in kernels:
            if used[n] == 0:
                failures.append(f"{label}: {n} was not launched")
        for n, c in used.items():
            counts[n] += c
        gflops = 2.0 * B * (nnz + R) / (ms * 1e-3) / 1e9
        lib_ms = None
        if key != "dense":
            xt = xd.T.contiguous()
            lib_ms = median_ms(lambda: a_csr @ xt)
        lib = "" if lib_ms is None else f", CSR A @ X {lib_ms:.4f} ms"
        if {"spmv_chunked_batched", "spmv_windowed_batched"} & set(kernels):
            # after `used`: not counted
            lib += (f"; the whole linear's device busy "
                    f"{_ms(device_ms(lambda: call(xd, bd)))}")
        b10_ms = None
        if "spmv_routed_batched" in kernels:  # after `used`: not counted
            b10 = [device_ms(lambda a=a: spmv_routed_stream_batched(*a))
                   for a in routed_batched_args(h, xd)]
            b10_ms = None if None in b10 else sum(b10)
            lib += (f"; B10 device time summed over {len(b10)} streams "
                    f"{_ms(b10_ms)} beside CSR A @ X; the whole linear's "
                    f"device busy {_ms(device_ms(lambda: call(xd, bd)))}")
        log(f"  {label}: launches {used}, median linear {ms:.4f} ms, "
            f"{gflops:.2f} GFLOP/s{lib}")
        rows_out.append({"run": label, "format": h.format, "batch": B,
                         "launches": used, "linear_ms": ms,
                         "gflops": gflops, "library_ms": lib_ms,
                         "b10_device_ms": b10_ms,
                         "device_mb": h.device_bytes / 2**20})
        inputs_used[key] = xd
    return rows_out, inputs_used


def model_forward_f64(model, x):
    """Float64 numpy forward of the same masked weights."""
    def w(m):
        mask = getattr(m, "mask", None)
        wt = m.weight if mask is None else m.weight * mask
        return (wt.detach().double().cpu().numpy(),
                m.bias.detach().double().cpu().numpy())
    y = x.astype(np.float64)
    for i, m in enumerate((model.fc1, model.fc2, model.fc3)):
        wt, b = w(m)
        y = y @ wt.T + b
        if i < 2:
            y = np.maximum(y, 0.0)
    return y


def model_path(counts, failures):
    """The three-layer MLP at full width, built on the card from a seeded
    ``torch.Generator``, swapped onto an ``Accelerator``, run at batches of
    64 and 1 and held to a float64 forward (rtol 1e-3, atol 1e-4)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    model = ThreeLayerFCModel(MLP["input"], hidden=MLP["hidden"],
                              out=MLP["out"], density=MLP["density"],
                              generator=gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mgr = AcceleratorLayerManager(Accelerator())
    accel = mgr.replace_layers(model)
    swap_s = time.perf_counter() - t0
    fmts = [h.format for h, _ in accel.layers]
    mb = [h.device_bytes / 2**20 for h, _ in accel.layers]
    log(f"  model init {init_s:.2f} s, layer swap {swap_s:.2f} s; formats "
        f"{dict(zip(mgr.layer_names, fmts))}, device MB "
        f"{[round(m, 1) for m in mb]}")
    if fmts != MLP_FORMATS:
        failures.append(f"MLP: layer formats {fmts}, want {MLP_FORMATS}")
    rng = np.random.default_rng(SEED + 2)
    rows_out = []
    for B in MLP_BATCHES:
        xb = rng.standard_normal((B, MLP["input"])).astype(np.float32)
        x = torch.from_numpy(xb).cuda()
        zero_launches()
        got = accel(x)
        torch.cuda.synchronize()
        once = launches()
        want = model_forward_f64(model, xb)
        st = compare_model_outputs(got, want)
        log(f"  MLP B {B}: max rel err {st.max_rel_error:.3e} "
            f"({st.num_mismatches} mismatches), launches of one forward "
            f"{once}")
        if not st.ok or got.shape != (B, MLP["out"]):
            failures.append(f"MLP B {B}: output off the float64 forward")
        accel_ms = median_ms(lambda: accel(x))
        used = launches()
        if used["spmv_windowed_batched"] == 0:
            failures.append(f"MLP B {B}: B8 was not launched")
        for n, c in used.items():
            counts[n] += c
        with torch.no_grad():
            module_ms = median_ms(lambda: model(x))
        layer_ms = []
        y = x
        for (h, bias), act in zip(accel.layers, accel.activations):
            layer_ms.append(median_ms(lambda: h.linear(y, bias)))
            y = h.linear(y, bias)
            y = act(y) if act is not None else y
        log(f"  MLP B {B}: accelerated {accel_ms:.4f} ms/batch, torch.nn "
            f"module {module_ms:.4f} ms/batch, linear per layer "
            f"{[round(m, 4) for m in layer_ms]} ms, launches {used}")
        rows_out.append({"batch": B, "accelerated_ms": accel_ms,
                         "module_ms": module_ms, "layer_linear_ms": layer_ms,
                         "formats": fmts, "device_mb": mb})
    return accel, rows_out


def sharded_path(handles, fixtures, meshes, counts, failures):
    """The sharded executors on each mesh: y against the float64 golden
    and the single-device handle's y, balance, launches and ring copies of
    one call, then 20 timed calls beside the handle's ``run``.  Counts
    zeroed before each run and read after.  Returns the rows and the
    arrays for phase 4 (shard 0 of the first mesh's block and ring plans)."""
    rng = np.random.default_rng(SEED + 5)
    rows_out, plans, kernel_args = [], {}, {}
    xs = {n: rng.standard_normal(fixtures[n].num_cols).astype(np.float32)
          for n in sorted({r[1] for r in SHARDED_RUNS})}
    for devices in meshes:
        mesh = make_mesh(devices=list(devices))
        D = mesh.size
        for label, name, kind, x_mode, single in SHARDED_RUNS:
            coo = fixtures[name]
            build, run, kernel, per_call = SHARD_KINDS[kind]
            key = (name, kind, D)
            t0 = time.perf_counter()
            if key not in plans:
                plans[key] = build(coo, D)
            plan = plans[key]
            plan_s = time.perf_counter() - t0
            x = xs[name]
            xd = torch.from_numpy(x).to(mesh.devices[0])
            tag = f"{label}, D {D} on {','.join(str(d) for d in devices)}"
            zero_launches()
            rot0 = spmv_sharded_chunked.rotations
            y = run(plan, xd, mesh, x_mode=x_mode)
            torch.cuda.synchronize()
            once, rot = launches(), spmv_sharded_chunked.rotations - rot0
            want = coo.matvec(x.astype(np.float64))
            st = error_stats(y.cpu().numpy(), want, rtol=RTOL)
            h, _ = handles[single]
            y1 = h.run(xd)
            same = _agree(kernel, y, y1)[0]
            want_rot = D * (D - 1) if x_mode == "ring" else 0
            mb = device_bytes(plan, mesh) / 2**20
            extra = ""
            if kind == "chunked":  # every (device, shard) segment padded
                nch = plan.data5.shape[2]
                extra = (f", data5 {plan.data5.nbytes / 2**20:.1f} MB "
                         f"({nch} chunks of {plan.chunk} a segment: "
                         f"{sum(plan.blocks_per_dev)} real blocks in "
                         f"{D * D * nch * plan.chunk} slots)")
            log(f"  {tag}: plan {plan_s:.2f} s, balance {plan.balance:.3f}, "
                f"device {mb:.1f} MB{extra}; max rel err {st.max_rel_error:.3e}"
                f" ({st.num_mismatches} mismatches), "
                f"{'equal to' if same else 'OFF'} the single-device y "
                f"within {KERNEL_RTOL}; launches of one call {once}, ring "
                f"copies {rot}")
            if not st.ok or y.shape != want.shape:
                failures.append(f"{tag}: off the golden")
            if not same:
                failures.append(f"{tag}: off the single-device handle's y")
            if plan.balance >= MAX_BALANCE:
                failures.append(f"{tag}: balance {plan.balance:.3f}")
            if once[kernel] != per_call(D):
                failures.append(f"{tag}: {once[kernel]} {kernel} launches, "
                                f"want {per_call(D)}")
            if rot != want_rot:  # ring: D - 1 rounds of D copies
                failures.append(f"{tag}: {rot} ring copies, want "
                                f"{want_rot}")
            ms = median_ms(lambda: run(plan, xd, mesh, x_mode=x_mode))
            busy = device_ms(lambda: run(plan, xd, mesh, x_mode=x_mode))
            used = launches()
            for n, c in used.items():
                counts[n] += c
            single_ms = median_ms(lambda: h.run(xd))
            log(f"  {tag}: median {ms:.4f} ms (device busy {_ms(busy)}), "
                f"single-device run {single_ms:.4f} ms ({h.format})")
            rows_out.append({
                "run": label, "devices": [str(d) for d in devices],
                "x_mode": x_mode, "balance": plan.balance,
                "device_mb": mb, "ms": ms, "device_busy_ms": busy,
                "single_device_ms": single_ms,
                "launches": used, "ring_copies_per_call": rot,
                "max_rel_error": st.max_rel_error,
            })
            if D == 4 and kind in ("block", "chunked") and \
                    kind not in kernel_args:
                kernel_args[kind] = (plan, mesh, xd)
    return rows_out, kernel_args


def sharded_cases(kernel_args, handles):
    """B5 and B3 on shard 0 of the four-position plans of phase 3d, and B3
    on TSOPF_RS_b2383 packed in x panels of PANEL_NCB col blocks (several
    panels, so the panel offset is exercised)."""
    cases = []
    plan, mesh, xd = kernel_args["block"]
    sh = to_device(plan, mesh)[0]
    Cp = plan.num_col_blocks * 128
    xb = torch.nn.functional.pad(xd, (0, Cp - xd.shape[0])).reshape(
        -1, 1, 128)
    cases.append(("spmv_block",
                  f"TSOPF_RS_b2383 shard 0 of 4, bh {plan.block_h}, "
                  f"{plan.blocks_per_dev[0]} blocks",
                  (sh["data"], sh["rows"], sh["cols"], sh["firsts"],
                   sh["lasts"], xb, plan.nrb_max), {"starts": sh["starts"]}))
    plan, mesh, xd = kernel_args["chunked"]
    sh = to_device(plan, mesh)[0]
    per = plan.ncb_per_shard * 128
    x0 = torch.nn.functional.pad(xd, (0, 4 * per - xd.shape[0]))[:per]
    nch = plan.data5.shape[2]
    cases.append(("spmv_chunked_paneled",
                  f"TSOPF_RS_b2383 ring shard 0 step 0, bh {plan.block_h}, "
                  f"{nch} chunks of {plan.chunk}, "
                  f"{b3_shape(nch, plan.chunk, plan.block_h)}",
                  (sh["data"][0], sh["meta"][0], sh["panels"],
                   x0.reshape(-1, 128), plan.nrb_max, plan.block_h,
                   plan.chunk, plan.ncb_per_shard)))
    h, xd = handles["TSOPF_RS_b2383 block"]
    p = h.plan
    data3d, meta, panels, nch = pack_chunks_paneled(p, h._chunk, PANEL_NCB)
    npanels = -(-p.num_col_blocks // PANEL_NCB)
    x = torch.nn.functional.pad(xd, (0, npanels * PANEL_NCB * 128
                                     - xd.shape[0]))
    cases.append(("spmv_chunked_paneled",
                  f"TSOPF_RS_b2383 in {npanels} x panels of {PANEL_NCB} "
                  f"col blocks, bh {p.block_h}, {nch} chunks of {h._chunk}, "
                  f"{b3_shape(nch, h._chunk, p.block_h)}",
                  (torch.from_numpy(data3d).cuda(),
                   torch.from_numpy(meta).cuda(),
                   torch.from_numpy(panels).cuda(), x.reshape(-1, 128),
                   p.num_row_blocks, p.block_h, h._chunk, PANEL_NCB)))
    return cases


def b3_shape(nchunks, chunk, block_h, grid=chunked_paneled_grid):
    """B3's launch shape (B4's with ``grid=chunked_tiled_grid``) as its
    labels name it."""
    V, slices, ctas = grid(nchunks, chunk, block_h)
    return f"V {V}, {slices} row slices, {ctas} CTAs"


def b6_shape(starts, nblocks, block_h, batch):
    """B6's launch shape and its longest run, as its labels name them."""
    warps, slices, ctas = block_batched_grid(starts.numel(), block_h, batch)
    ends = torch.cat([starts[1:].long(), starts.new_tensor([nblocks]).long()])
    longest = int((ends - starts.long()).max())
    return (f"{warps} warps a CTA, {slices} row slices, {ctas} CTAs, "
            f"longest run {longest} blocks")


def ops_entry(handles, fixtures, counts, failures):
    """The ``ops`` entry on TSOPF_RS_b2383: the one-shot ``spmv_block``
    (B5) with alpha, beta and y_in against the golden, then B5 on resident
    arrays beside the handle's ``run`` (B1), and B6 at a batch of 64 on
    these arrays against the golden, beside the handle's ``linear`` (B6 on
    arrays of its own, as the JAX handle runs a batch past its budget).
    Returns the row and the phase 4 cases."""
    name = "TSOPF_RS_b2383"
    coo = fixtures[name]
    h, _ = handles["TSOPF_RS_b2383 block"]
    plan = h.plan
    R, C = coo.shape
    nrb, B = plan.num_row_blocks, BATCH
    rng = np.random.default_rng(SEED + 6)
    x, y_in = inputs(R, C, rng)
    zero_launches()
    y = ops.spmv_block(plan, x, y_in, ALPHA, BETA)
    torch.cuda.synchronize()
    once = launches()
    want = ALPHA * coo.matvec(x.astype(np.float64)) + BETA * y_in
    st = error_stats(y.cpu().numpy(), want, rtol=RTOL)
    log(f"  ops.spmv_block (one-shot, uploads the plan): max rel err "
        f"{st.max_rel_error:.3e} ({st.num_mismatches} mismatches), launches "
        f"{once}")
    if not st.ok or once["spmv_block"] != 1:
        failures.append("ops.spmv_block: off the golden or not one B5 launch")
    d = upload_block_plan(plan, "cuda")
    stream = (d["data"], d["rows"], d["cols"], d["firsts"], d["lasts"])
    xd = torch.from_numpy(x).cuda()
    x1 = h._pad_x(xd).reshape(-1, 1, 128)
    b5_ms = median_ms(lambda: spmv_block_stream(*stream, x1, nrb,
                                                starts=d["starts"]))
    run_ms = median_ms(lambda: h.run(xd))

    xb = rng.standard_normal((B, C)).astype(np.float32)
    xbd = torch.from_numpy(xb).cuda()

    def b6_linear():
        xt = h._pad_x(xbd).T.reshape(-1, 128, B).contiguous()
        yb = spmv_block_batched(*stream, xt, nrb, starts=d["starts"])
        return yb.reshape(-1, B)[:R].T

    got = b6_linear()
    torch.cuda.synchronize()
    b6_once = launches()
    wantb = (coo.to_scipy() @ xb.astype(np.float64).T).T
    atol = GOLDEN_ATOL * float(np.abs(wantb).max())
    stb = error_stats(got.cpu().numpy(), wantb, rtol=RTOL, atol=atol)
    if not stb.ok or b6_once["spmv_block_batched"] != 1:
        failures.append("B6 at B 64: off the golden or not one launch")
    xt = h._pad_x(xbd).T.reshape(-1, 128, B).contiguous()
    b6_ms = median_ms(lambda: spmv_block_batched(*stream, xt, nrb,
                                                 starts=d["starts"]))
    b6_linear_ms = median_ms(b6_linear)
    linear_ms = median_ms(lambda: h.linear(xbd))
    used = launches()
    for n, c in used.items():
        counts[n] += c
    log(f"  TSOPF_RS_b2383 B5 {b5_ms:.4f} ms vs handle run (B1) "
        f"{run_ms:.4f} ms; B6 at B {B}: max abs err {stb.max_abs_error:.3e}"
        f" ({stb.num_mismatches} past rtol {RTOL} + atol {atol:.2e}), kernel"
        f" {b6_ms:.4f} ms, as a linear (pad, transpose, B6) "
        f"{b6_linear_ms:.4f} ms vs handle linear (B6) {linear_ms:.4f} ms; "
        f"launches {used}")
    row = {"run": "ops entry TSOPF_RS_b2383", "b5_ms": b5_ms,
           "handle_run_ms": run_ms, "b6_ms": b6_ms,
           "b6_linear_ms": b6_linear_ms, "handle_linear_ms": linear_ms,
           "batch": B, "launches": used}
    cases = [
        ("spmv_block", f"TSOPF_RS_b2383, bh {plan.block_h}, "
         f"{plan.num_blocks} blocks", stream + (x1, nrb),
         {"starts": d["starts"]}),
        ("spmv_block_batched", f"TSOPF_RS_b2383, bh {plan.block_h}, B {B}, "
         f"{b6_shape(d['starts'], plan.num_blocks, plan.block_h, B)}",
         stream + (xt, nrb), {"starts": d["starts"]}),
    ]
    return row, cases


def _layout(h):
    return [n for n in ("chunked", "paneled", "tiled") if getattr(h, "_" + n)]


def large_block_path(counts, failures):
    """Phase 3f: ``prepare(coo, format="block")`` on matrices past the
    chunked layout's budget, ``run`` against the float64 golden through B4
    or B3, and ``linear`` through B6 where a batch is given; counts zeroed
    before each run and read after.  Returns the rows and, per run, the
    handle and its x."""
    rng = np.random.default_rng(SEED + 7)
    rows_out, handles = [], {}
    for label, R, C, nnz, layout, kernel, B in LARGE_BLOCK_RUNS:
        t0 = time.perf_counter()
        coo = blocked_coo(R, C, nnz, seed=SEED, spread_frac=0.4)
        gen_s = time.perf_counter() - t0
        zero_launches()
        t0 = time.perf_counter()
        h = prepare(coo, SpmvConfig(), "block")
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        if _layout(h) != [layout]:
            failures.append(f"{label}: layout {_layout(h)}, want {layout}")
        x, y_in = inputs(R, C, rng)
        xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y_in).cuda()
        y = h.run(xd, yd, ALPHA, BETA)
        torch.cuda.synchronize()
        once = launches()
        want = ALPHA * coo.matvec(x.astype(np.float64)) + BETA * y_in
        check_run(label, y, want, h, failures)
        if once[kernel] != 1 or sum(once.values()) != 1:
            failures.append(f"{label}: launches of one run {once}, want one "
                            f"{kernel}")
        ms = median_ms(lambda: h.run(xd, yd, ALPHA, BETA))
        busy = device_ms(lambda: h.run(xd, yd, ALPHA, BETA))
        used = launches()
        for n, c in used.items():
            counts[n] += c
        a = csr_of(label, coo)
        lib_ms = median_ms(lambda: a @ xd)
        log(f"  {label}: {R}x{C}, generated in {gen_s:.1f} s, layout "
            f"{layout}, {h._d['data'].shape[0]} chunks of {h._chunk}, "
            f"device busy {_ms(busy)} a run")
        row = _row(label, h, coo.nnz, R, prep_s, ms, used, lib_ms)
        row.update(layout=layout, device_busy_ms=busy, generate_s=gen_s)
        if B:
            row["linear"] = _large_linear(label, h, coo, a, B, rng, counts,
                                          failures)
        rows_out.append(row)
        handles[label] = (h, xd)
    return rows_out, handles


def _large_linear(label, h, coo, a, B, rng, counts, failures):
    """``linear`` at batch ``B`` on a handle past the budget: one B6 launch
    on per-block arrays uploaded at the first call, against the golden."""
    R, C = coo.shape
    xb = rng.standard_normal((B, C)).astype(np.float32)
    xbd = torch.from_numpy(xb).cuda()
    zero_launches()
    t0 = time.perf_counter()
    yb = h.linear(xbd)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    once = launches()
    want = (coo.to_scipy() @ xb.astype(np.float64).T).T
    atol = GOLDEN_ATOL * float(np.abs(want).max())
    st = error_stats(yb.cpu().numpy(), want, rtol=RTOL, atol=atol)
    if not st.ok or yb.shape != (B, R) or not torch.isfinite(yb).all():
        failures.append(f"{label} linear B {B}: off the golden")
    if once["spmv_block_batched"] != 1 or sum(once.values()) != 1:
        failures.append(f"{label} linear B {B}: launches {once}, want one "
                        "B6")
    ms = median_ms(lambda: h.linear(xbd))
    busy = device_ms(lambda: h.linear(xbd))
    used = launches()
    for n, c in used.items():
        counts[n] += c
    xt = xbd.T.contiguous()
    lib_ms = median_ms(lambda: a @ xt)
    batch_mb = sum(v.nbytes for v in h._batch_d.values()) / 2**20
    gflops = 2.0 * B * (coo.nnz + R) / (ms * 1e-3) / 1e9
    bound_ms, bound_by = b6_bound(h, xbd)
    bd = h._batch_d
    shape = b6_shape(bd["starts"], bd["data"].shape[0], h.plan.block_h, B)
    log(f"  {label} linear B {B} [B6: {shape}]: max abs err "
        f"{st.max_abs_error:.3e} "
        f"({st.num_mismatches} past rtol {RTOL} + atol {atol:.2e}); first "
        f"call {first_s:.2f} s (uploads {batch_mb:.1f} MB of per-block "
        f"arrays); launches {used}, median linear {ms:.4f} ms (device busy "
        f"{_ms(busy)}), {gflops:.2f} GFLOP/s, CSR A @ X {lib_ms:.4f} ms; "
        f"B6 bound {bound_ms:.4f} ms ({bound_by})")
    return {"batch": B, "linear_ms": ms, "device_busy_ms": busy,
            "gflops": gflops, "library_ms": lib_ms, "batch_arrays_mb":
            batch_mb, "launches": used, "b6_bound_ms": bound_ms,
            "b6_bound_by": bound_by, "b6_shape": shape}


def b6_bound(h, xbd):
    """``kernel_bound`` of the B6 launch the handle's ``linear`` makes on
    the batch ``xbd`` [B, C]: its per-block arrays, x [ncb, 128, B] and y
    [nrb, bh, B] as ``_block_matmat`` passes them."""
    plan, bd, B = h._block_plan_meta, h._batch_d, xbd.shape[0]
    xt = h._pad_x(xbd).T.reshape(-1, 128, B)
    y = torch.empty((plan.num_row_blocks, plan.block_h, B),
                    device=xbd.device)
    args = (bd["data"], bd["rows"], bd["cols"], bd["firsts"], bd["lasts"],
            xt, plan.num_row_blocks)
    return kernel_bound("spmv_block_batched", args, {"starts": bd["starts"]},
                        y)


def gathered_path(counts, failures):
    """Phase 3g: ``prepare(coo, format="routed")`` on the analytics
    stand-in with the gathered executor's modelled cost lowered (this
    phase only), so that the planner diverts its scattered tiles to a
    gathered side-plan; ``run`` against the golden, then ``linear`` at
    GATHERED_BATCH vector by vector.  Counts zeroed before each run and
    read after.  Returns the row and (handle, x)."""
    coo = suite_matrix(GATHERED_FIXTURE, 1.0, seed=SEED)
    label = f"{GATHERED_FIXTURE} routed gathered"
    saved = {k: getattr(gathered_plan, k) for k in GATHERED_COSTS}
    zero_launches()
    t0 = time.perf_counter()
    try:
        for k, v in GATHERED_COSTS.items():
            setattr(gathered_plan, k, v)
        h = prepare(coo, SpmvConfig(), "routed")
    finally:
        for k, v in saved.items():
            setattr(gathered_plan, k, v)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    g = h.plan.gathered
    if h.format != "routed" or g is None:
        failures.append(f"{label}: no gathered side-plan")
        return None, None
    nstreams = len(h.plan.streams)
    diverted = int(np.count_nonzero(g.vals))
    log(f"  {label}: {coo.shape[0]}x{coo.shape[1]}, nnz {coo.nnz}; gathered "
        f"side-plan {g.num_tiles} tiles, K {g.num_windows}, P "
        f"{g.num_panels}, {g.num_ytiles} y tiles, {diverted} nonzeros "
        f"diverted; {nstreams} streams")
    rng = np.random.default_rng(SEED + 8)
    x, y_in = inputs(*coo.shape, rng)
    xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y_in).cuda()
    zero_launches()
    y = h.run(xd, yd, ALPHA, BETA)
    torch.cuda.synchronize()
    once = launches()
    want = ALPHA * coo.matvec(x.astype(np.float64)) + BETA * y_in
    check_run(label, y, want, h, failures)
    per_run = {"s1_gather": 1, "permute_stage": 2, "spmv_gathered": 1,
               "spmv_routed": 1}
    if any(once[n] != c for n, c in per_run.items()):
        failures.append(f"{label}: launches of one run {once}, want "
                        f"{per_run}")
    ms = median_ms(lambda: h.run(xd, yd, ALPHA, BETA))
    busy = device_ms(lambda: h.run(xd, yd, ALPHA, BETA))
    used = launches()
    for n, c in used.items():
        counts[n] += c
    a = csr_of(GATHERED_FIXTURE, coo)
    lib_ms = median_ms(lambda: a @ xd)
    log(f"  {label}: launches of one run {once}, device busy {_ms(busy)} a "
        "run")
    row = _row(label, h, coo.nnz, coo.shape[0], prep_s, ms, used, lib_ms)
    row.update(device_busy_ms=busy, tiles=g.num_tiles, K=g.num_windows,
               P=g.num_panels, diverted_nnz=diverted)

    B = GATHERED_BATCH
    xb = rng.standard_normal((B, coo.shape[1])).astype(np.float32)
    xbd = torch.from_numpy(xb).cuda()
    zero_launches()
    yb = h.linear(xbd)
    torch.cuda.synchronize()
    once = launches()
    wantb = (coo.to_scipy() @ xb.astype(np.float64).T).T
    atol = GOLDEN_ATOL * float(np.abs(wantb).max())
    st = error_stats(yb.cpu().numpy(), wantb, rtol=RTOL, atol=atol)
    if not st.ok or yb.shape != (B, coo.shape[0]):
        failures.append(f"{label} linear B {B}: off the golden")
    if any(once[n] != B * c for n, c in per_run.items()):
        failures.append(f"{label} linear B {B}: launches {once}, want "
                        f"{B} x {per_run}")
    lin_ms = median_ms(lambda: h.linear(xbd))
    used = launches()
    for n, c in used.items():
        counts[n] += c
    log(f"  {label} linear B {B}: max abs err {st.max_abs_error:.3e} "
        f"({st.num_mismatches} past rtol {RTOL} + atol {atol:.2e}), "
        f"launches of one call {once}, median linear {lin_ms:.4f} ms")
    row["linear"] = {"batch": B, "linear_ms": lin_ms, "launches": used}
    return row, (h, xd)


def large_block_cases(large):
    """B4 and B3 on the arrays and x of phase 3f's handles."""
    cases = []
    for label, *_ in LARGE_BLOCK_RUNS:
        h, xd = large[label]
        p, d = h.plan, h._d
        x2d = h._pad_x(xd).reshape(-1, 128)
        shape = (f"{label}, bh {p.block_h}, {d['data'].shape[0]} chunks of "
                 f"{h._chunk}")
        if h._tiled:
            pnrb = h._panel_nrb(p.block_h)
            npy = -(-p.num_row_blocks // pnrb)
            cases.append(("spmv_chunked_tiled",
                          f"{shape}, {npy} y panels of {pnrb} row blocks, "
                          + b3_shape(d["data"].shape[0], h._chunk,
                                     p.block_h, chunked_tiled_grid),
                          (d["data"], d["meta"], d["xpanels"], d["ypanels"],
                           x2d, npy, pnrb, p.block_h, h._chunk,
                           h._PANEL_NCB, h._sector_mask)))
        else:
            nch = d["data"].shape[0]
            cases.append(("spmv_chunked_paneled",
                          f"{shape}, x panels of {h._PANEL_NCB} col blocks, "
                          f"{b3_shape(nch, h._chunk, p.block_h)}",
                          (d["data"], d["meta"], d["panels"], x2d,
                           p.num_row_blocks, p.block_h, h._chunk,
                           h._PANEL_NCB)))
    return cases


def _gathered_x(h, xd):
    """The routed executor's x of the gathered side-plan: its first K
    windows, [K*8, 128]."""
    kw = h._routed_meta["gathered"]["K"] * 1024
    x = h._pad_x(xd)
    return torch.nn.functional.pad(x[:kw], (0, max(kw - x.shape[0], 0)))


def gathered_cases(gath):
    """B12 and B13 on the side-plan arrays and x of phase 3g's handle."""
    h, xd = gath
    d, gm, nyt = h._d, h._routed_meta["gathered"], h._routed_meta["nyt"]
    x2d = _gathered_x(h, xd).reshape(-1, 128)
    xg = gathered_gather_apply(d, gm, "g_", x2d)
    return [
        ("s1_gather", f"{GATHERED_FIXTURE}: P {gm['P']} x K {gm['K']} "
         "windows", (d["g_s1"], x2d, gm["P"], gm["K"])),
        ("spmv_gathered", f"{GATHERED_FIXTURE}: {gm['T']} tiles, {nyt} y "
         "tiles", (d["g_vals"], d["g_word"], d["g_byt"], xg, nyt, gm["nch"],
                   gm["tchunk"])),
    ]


def routed_part_x2d(h, xd):
    """The x2d that a routed handle's B9 launch reads for the x ``xd``, as
    ``_run_routed_part`` makes it: padded, permuted into rank space (B11)
    when the plan is ranked, padded to whole windows."""
    meta = h._routed_meta
    x = h._pad_x(xd)
    if meta["xperm"] is not None:
        x = panel_permute_apply_from(h._d, meta["xperm"], "xp", x)
    need = meta["nwin"] * 1024
    x = torch.nn.functional.pad(x, (0, max(need - x.shape[0], 0)))
    return x.reshape(-1, 128)


def routed_part_cases(handles, gath):
    """B9 on the whole routed part (every stream, one launch) of trans5,
    ford2, language in rank space and analytics with its gathered
    side-plan, on the x each run gave it."""
    runs = [(SPARSE_NAME[k], handles[k]) for k in (
        "trans5 routed", "ford2 routed", "language routed rank")]
    runs += [(GATHERED_FIXTURE, gath)] if gath is not None else []
    cases = []
    for name, (h, xd) in runs:
        table = h._routed_meta["table"]
        dims = [d for _, d, _ in table.streams]
        cases.append(("spmv_routed_part",
                      f"{name} routed part: {len(dims)} streams, "
                      f"{table.num_tiles} tiles, lmax "
                      f"{[d[4] for d in dims]}",
                      (table, routed_part_x2d(h, xd))))
    return cases


def kernel_checks(handles, linear_x, accel, extra_cases, failures):
    """Each kernel against its plain PyTorch version on the arrays and x
    that the paths gave it (the batched kernels on the batches of the
    linear runs and on the MLP's fc3 activations; ``extra_cases`` from the
    sharded paths, the ops entry and the routed parts), timed beside its
    bound and its library call; launches here are not counted."""
    cases = b1_b7_cases(handles)
    for label in ("trans5 routed", "ford2 routed"):
        h, xd = handles[label]
        meta = h._routed_meta
        x2d = h._pad_x(xd).reshape(-1, 128)
        for i, dims in enumerate(meta["streams"]):
            p = f"s{i}_"
            packed = tuple(h._d[p + n] for n in stream_array_names(dims[4]))
            packed += (h._d[p + "base"], h._d[p + "byt"])
            cases.append(("spmv_routed",
                          f"{label.split()[0]} stream {i}: {dims[0]} tiles, "
                          f"W {dims[2]}, l1 {dims[3]}, lmax {dims[4]}",
                          (packed, dims, x2d, meta["nyt"])))
    h, xd = handles["language routed rank"]
    xmeta = h._routed_meta["xperm"][0]
    rng = np.random.default_rng(SEED)
    for si, dims in enumerate(xmeta["dims"]):
        a = torch.from_numpy(rng.standard_normal(
            (dims[0] * dims[1] * 8, 128)).astype(np.float32)).to(xd.device)
        cases.append(("permute_stage",
                      f"language x S{si + 1}: {dims[0] * dims[1]} windows",
                      ((h._d[f"xp0_a{si}_0"],), dims, a)))
    cases += batched_cases(handles, linear_x, accel)
    cases += extra_cases
    results = []
    for name, shape, args, *kw in cases:
        kw = kw[0] if kw else {}
        kern = CALL[name] if name in CALL else KERNELS[name]["wrapper"]
        yk = kern(*args, **kw)
        yp = PLAIN[name](*args)
        torch.cuda.synchronize()
        ok, err, line = _agree(name, yk, yp)
        if name == "spmv_chunked_tiled":
            # the plain version without the mask: the true product, so a
            # mask that drops a live granule shows here
            full_ok, _, full_line = _agree(name, yk, PLAIN[name](*args[:10]))
            line += f"; without the mask {full_line}"
            if not full_ok:
                failures.append(f"{name} [{shape}] with its sector mask "
                                "disagrees with the unmasked product")
        ms = median_ms(lambda: kern(*args, **kw))
        busy = device_ms(lambda: kern(*args, **kw))
        plain_ms = median_ms(lambda: PLAIN[name](*args))
        bound_ms, bound_by = kernel_bound(name, args, kw, yk)
        extra = {}
        if name == "spmv_chunked_tiled":
            # B4 reads only the live sectors: its bound is the must-read one
            extra["packed_bound_ms"] = bound_ms
            bound_ms, bound_by, must_mb = b4_must_read(args, yk)
            line += (f", must-read {must_mb:.1f} MB, packed bound "
                     f"{extra['packed_bound_ms']:.4f} ms")
        if name == "spmv_routed_part":
            # B9 reads only the live layers' boundary rows
            extra["packed_bound_ms"] = bound_ms
            bound_ms, bound_by, must_mb = b9_must_read(args, yk)
            line += (f", must-read {must_mb:.2f} MB, packed bound "
                     f"{extra['packed_bound_ms']:.4f} ms")
        lib = library_call(name, args)
        lib_ms = None
        if lib is not None:
            lib_ok, _, lib_line = _agree(name, lib().reshape(yp.shape), yp)
            lib_ms = median_ms(lib)
            line += f"; library {lib_line}"
            if not lib_ok:
                failures.append(f"{name} [{shape}]: the library call "
                                "computes another function")
        log(f"  {name} [{shape}]: {line}, kernel {ms:.4f} ms (device busy "
            f"{_ms(busy)}), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} [{shape}] disagrees with its plain "
                            "version")
        results.append({"name": CASE_KERNEL.get(name, name), "shape": shape,
                        "max_abs_err": err,
                        "ms": ms, "device_busy_ms": busy,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": lib_ms, **extra})
    return results


def _agree(name, got, want):
    """(ok, max abs err, log text): ``got`` within KERNEL_RTOL of ``want``
    (relative, plus KERNEL_RTOL of max|want|; exact for a permutation)."""
    diff = (got - want).abs()
    ymax = float(want.abs().max())
    bound = KERNEL_RTOL * want.abs() + KERNEL_RTOL * max(ymax, 1e-30)
    if name in ("permute_stage", "s1_gather"):  # gathers: no arithmetic
        bound = torch.zeros_like(bound)
    worst = float((diff / bound.clamp_min(1e-30)).max())
    err = float(diff.max())
    ok = bool((diff <= bound).all()) and bool(torch.isfinite(got).all())
    return ok, err, (f"max abs err {err:.3e} (max |y| {ymax:.3e}, max rel "
                     f"diff {err / max(ymax, 1e-30):.3e}, worst err/bound "
                     f"{worst:.3f})")


def _tensors_in(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors_in(o)
    elif isinstance(obj, RoutedTable):
        yield from _tensors_in(obj.streams)


# per kernel: (payload tensor, vectors) from its arguments, for the
# operations its inputs need (2 per nonzero payload value and vector)
_WORK = {
    "spmv_chunked": lambda a: (a[0], 1),
    "spmv_chunked_paneled": lambda a: (a[0], 1),
    "spmv_windowed": lambda a: (a[0], 1),
    "spmv_block": lambda a: (a[0], 1),
    "spmv_routed": lambda a: (a[0][0], 1),
    "spmv_routed_part": lambda a: (torch.cat(
        [p[0].reshape(-1) for p, _, _ in a[0].streams]), 1),
    "spmv_chunked_batched": lambda a: (a[0], a[2].shape[2]),
    "spmv_block_batched": lambda a: (a[0], a[5].shape[2]),
    "spmv_windowed_batched": lambda a: (a[0], a[3].shape[2]),
    "spmv_routed_batched": lambda a: (a[0][0], a[2].shape[2]),
    "permute_stage": lambda a: (None, 0),
    "spmv_chunked_tiled": lambda a: (a[0], 1),
    "s1_gather": lambda a: (None, 0),
    "spmv_gathered": lambda a: (a[0], 1),
}


def kernel_bound(name, args, kw, y):
    """(ms, "bytes" or "operations"): the least time of the call on an H100
    SXM, the larger of its inputs' and output's bytes (as packed, each read
    or written once) over the HBM rate and its fp32 operations over the FMA
    rate."""
    nbytes = sum(t.nbytes for t in _tensors_in((args, tuple(kw.values()))))
    nbytes += y.nbytes
    payload, vectors = _WORK[name](args)
    flops = 0.0
    if payload is not None:
        flops = 2.0 * int(torch.count_nonzero(payload)) * vectors
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def b4_must_read(args, y):
    """(ms, "bytes" or "operations", MB): B4's must-read bound on an H100
    SXM, the larger of the bytes it cannot skip over the HBM rate (the
    payload's live sectors: 8 lanes a set bit of the sector mask, 32 B at
    f32, 16 B at bf16; the mask, meta, the panel ids, x and y, each read or
    written once) and its fp32 operations over the FMA rate."""
    data3d, mask = args[0], args[10]
    words = mask.to(torch.int32) & 0xFFFF
    live = sum(int(((words >> g) & 1).sum()) for g in range(16))
    nbytes = (live * 8 * data3d.element_size() + mask.nbytes + y.nbytes
              + sum(t.nbytes for t in args[1:5]))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * int(torch.count_nonzero(data3d)) / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes / 1e6)


def b9_must_read(args, y):
    """(ms, "bytes" or "operations", MB): the bound of a B9 table's launch on
    an H100 SXM, the larger of the bytes it cannot skip over the HBM rate
    (each stream's vals, slot, gsub, base, byt and lt, the bl and bs rows
    of each tile's live layers, x and y, each read or written once) and
    its fp32 operations over the FMA rate."""
    table, x2d = args
    nbytes, nnz = x2d.nbytes + y.nbytes, 0
    for packed, dims, lt in table.streams:
        lmax = dims[4]
        nbytes += sum(t.nbytes for t in packed[:3] + packed[-2:])
        layers = (lt.long() if lt is not None else torch.full(
            (dims[0] * dims[1],), lmax, device=x2d.device))
        if lt is not None:
            nbytes += lt.nbytes
        rows = ((layers > 0).long() if lmax == 1
                else (layers + 1) // 2 + (layers + 3) // 4)
        nbytes += int(rows.sum()) * 4096
        nnz += int(torch.count_nonzero(packed[0]))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2.0 * nnz / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes / 1e6)


def _block_csr(blocks, rb, col, nrows, ncols):
    """CSR of a block stream on the card: ``blocks`` [nb, bh, 128], ``rb``
    [nb] row-block of each block, ``col(j, l)`` the column of lane l of
    block j; zero slots (padding included) are left out."""
    bh = blocks.shape[1]
    j, r, lane = blocks.nonzero().unbind(1)
    rows = rb.long()[j] * bh + r
    coo = torch.sparse_coo_tensor(torch.stack([rows, col(j, lane)]),
                                  blocks[j, r, lane].float(), (nrows, ncols))
    return coo.coalesce().to_sparse_csr()


def library_call(name, args):
    """A callable running one PyTorch call that computes the kernel's
    function on the same inputs (a CSR product for the block streams,
    ``index_select`` for B11, the CSR product of the nonzeros that a B9
    stream or routed part covers), or None where none does (B10: its
    lines are per stream and per batch)."""
    if name in ("spmv_chunked", "spmv_chunked_batched",
                "spmv_chunked_paneled", "spmv_chunked_tiled"):
        if name == "spmv_chunked_paneled":
            data3d, meta, panels, x, nrb, bh, chunk, panel_ncb = args
        elif name == "spmv_chunked_tiled":
            (data3d, meta, panels, ypanels, x, npy, panel_nrb, bh, chunk,
             panel_ncb) = args[:10]
            nrb = npy * panel_nrb
        else:
            data3d, meta, x, nrb, bh, chunk = args
        cb = meta[:, 1, :].reshape(-1).long()
        rb = (meta[:, 0, :].reshape(-1) >> 1).long()
        if name in ("spmv_chunked_paneled", "spmv_chunked_tiled"):
            cb = cb + (panels.long() * panel_ncb).repeat_interleave(chunk)
        if name == "spmv_chunked_tiled":
            rb = rb + (ypanels.long() * panel_nrb).repeat_interleave(chunk)
        blocks = data3d.reshape(-1, bh, 128)
        a = _block_csr(blocks, rb, lambda j, lane: cb[j] * 128 + lane,
                       nrb * bh, x.shape[0] * 128)
        xs = x.reshape(-1, x.shape[2]) if x.ndim == 3 else x.reshape(-1)
        return lambda: a @ xs
    if name in ("spmv_block", "spmv_block_batched"):
        data, rows, cols, x, nrb = args[0], args[1], args[2], args[5], args[6]
        a = _block_csr(data, rows, lambda j, lane: cols.long()[j] * 128 + lane,
                       nrb * data.shape[1], x.shape[0] * 128)
        xs = (x.reshape(-1) if name == "spmv_block"
              else x.reshape(-1, x.shape[2]))
        return lambda: a @ xs
    if name in ("spmv_windowed", "spmv_windowed_batched"):
        data3d, subidx3d, meta, x, nrb, bh = args[:6]
        win = meta[:, 1, :].reshape(-1).long()
        sub = subidx3d.reshape(-1, 128).long()
        if name == "spmv_windowed":
            xs = x.reshape(-1)
        else:  # xt [S, 128, B] -> [S*128, B]
            xs = x.reshape(-1, x.shape[2])
        ncols = xs.shape[0]
        a = _block_csr(data3d.reshape(-1, bh, 128),
                       meta[:, 0, :].reshape(-1) >> 1,
                       lambda j, lane: (win[j] * 8 + sub[j, lane]) * 128
                       + lane, nrb * bh, ncols)
        return lambda: a @ xs
    if name == "permute_stage":
        arrays, dims, a = args
        n = a.numel()
        idx = permute_stage_plain(arrays, dims, torch.arange(
            n, device=a.device, dtype=torch.float32).reshape(a.shape))
        idx = idx.reshape(-1).long()  # exact: n < 2**24
        flat = a.reshape(-1)
        return lambda: flat.index_select(0, idx)
    if name == "s1_gather":  # the composed source of every slot
        words, x, P, K = args
        idx = s1_gather_plain(words, torch.arange(
            x.numel(), device=x.device, dtype=torch.float32).reshape(x.shape),
            P, K).reshape(-1).long()  # exact: K*1024 < 2**24
        flat = x.reshape(-1)
        return lambda: flat.index_select(0, idx)
    if name == "spmv_routed":
        packed, dims, x2d, nyt = args
        return routed_csr_call(routed_table([(packed, dims, None)], nyt), x2d)
    if name == "spmv_routed_part":
        return routed_csr_call(*args)
    if name == "spmv_gathered":
        vals3, word3, byt, xg, nyt, nch, tchunk = args
        rows, slots, v = gathered_tile_coo(vals3, word3, byt, nyt)
        a = torch.sparse_coo_tensor(torch.stack([rows, slots]), v, (
            nyt * 1024, nch * tchunk * 1024)).coalesce().to_sparse_csr()
        xs = torch.nn.functional.pad(xg.reshape(-1), (
            0, nch * tchunk * 1024 - xg.numel()))
        return lambda: a @ xs
    return None


def gathered_tile_coo(vals3, word3, byt, num_ytiles):
    """(y row, tile slot, value) of every nonzero slot of the gathered
    tiles: cell c of tile t sums the prefix from the slot after route 2's
    source to route 1's source, so each slot in that run adds into y row
    byt[t]*1024 + c (cell 0 is the trash cell)."""
    Tp = byt.shape[0]
    dev = vals3.device
    w = word3.reshape(Tp, 8, 128)
    slot = torch.arange(1024, device=dev, dtype=torch.float32).reshape(
        1, 8, 128).expand(Tp, 8, 128).contiguous()
    src1 = clos_gather(w & 0x1FFF, slot).reshape(Tp, 1024).long()
    src2 = clos_gather((w >> 13) & 0x1FFF, slot).reshape(Tp, 1024).long()
    cell = torch.arange(1024, device=dev)
    run = (src1 > src2) & (cell > 0)[None, :] & (byt < num_ytiles)[:, None]
    t, c = run.nonzero().unbind(1)
    end = t * 1024 + src1[t, c]
    order = torch.argsort(end)
    end, t, c = end[order], t[order], c[order]
    start = t * 1024 + src2[t, c] + 1
    v = vals3.reshape(-1)
    s = v.nonzero().squeeze(1)
    k = torch.searchsorted(end, s).clamp(max=end.numel() - 1)
    inside = (start[k] <= s) & (s <= end[k])
    s, k = s[inside], k[inside]
    return byt.long()[t[k]] * 1024 + c[k], s, v[s]


def routed_tile_coo(table, x_rows):
    """(y row, x2d flat column, value) of every nonzero slot that the
    streams of a B9 table multiply: slot f of tile t reads x2d column
    row*128 + L of its x gather, and sums into y row byt[t, k]*1024 + c of
    the boundary layer k and cell c whose prefix difference P[end] -
    P[start] spans it (slots start+1 .. end of the tile's flat order)."""
    out = []
    for packed, dims, _ in table.streams:
        nch, tchunk, W, l1, lmax = dims
        if lmax == 1:
            vals, slot, gsub, bm, base, byt = packed
        else:
            vals, slot, gsub, bl, bs, base, byt = packed
        Tp, dev = nch * tchunk, vals.device
        slot3, gsub3 = slot.reshape(Tp, 8, 128), gsub.reshape(Tp, 8, 128)
        lane = (slot3 & 127).long()
        rank = (slot3 >> 7) & 7
        col = torch.full((Tp, 8, 128), -1, dtype=torch.long, device=dev)
        for layer in range(l1):  # the x gather of _routed_plain
            word = gsub3 if layer < 3 else slot3
            shift = 9 * layer if layer < 3 else 10 + 9 * (layer - 3)
            field = torch.gather((word >> shift) & 511, 2, lane)
            vid = (field >> 3).long()
            row = (base.long().view(Tp, 1, 1) + vid) * 8 + (field & 7).long()
            c = torch.where((vid < W) & (row < x_rows), row * 128 + lane, -1)
            col = c if l1 == 1 else torch.where(rank == layer, c, col)
        byt2 = byt.reshape(Tp, lmax).long()
        cell = torch.arange(1024, device=dev).view(1, 8, 128)
        tile = torch.arange(Tp, device=dev).view(Tp, 1, 1) * 1024
        lo, hi, yrow = [], [], []
        for k in range(lmax):
            if lmax == 1:
                raw = bm.reshape(Tp, 8, 128)
                q = ((raw >> 14) & 7) | (((raw >> 17) & 7) << 4)
            else:
                raw = bl.reshape(Tp, -1, 8, 128)[:, k // 2] >> (14 * (k % 2))
                q = bs.reshape(Tp, -1, 8, 128)[:, k // 4] >> (8 * (k % 4))
            a, b = (raw & 127).long(), ((raw >> 7) & 127).long()
            end = (torch.gather(q, 2, a) & 7).long() * 128 + a
            start = ((torch.gather(q, 2, b) >> 4) & 7).long() * 128 + b
            yt = byt2[:, k].view(Tp, 1, 1).expand(Tp, 8, 128)
            run = (end > start) & (yt < table.num_ytiles)
            lo.append((tile + start + 1)[run])
            hi.append((tile + end)[run])
            yrow.append((yt * 1024 + cell)[run])
        lo, hi, yrow = torch.cat(lo), torch.cat(hi), torch.cat(yrow)
        if hi.numel() == 0:
            continue
        order = torch.argsort(hi)
        lo, hi, yrow = lo[order], hi[order], yrow[order]
        v, col = vals.reshape(-1), col.reshape(-1)
        f = ((v != 0) & (col >= 0)).nonzero().squeeze(1)
        k = torch.searchsorted(hi, f).clamp(max=hi.numel() - 1)
        inside = (lo[k] <= f) & (f <= hi[k])
        f, k = f[inside], k[inside]
        out.append((yrow[k], col[f], v[f]))
    return [torch.cat(t) for t in zip(*out)]


def routed_csr_call(table, x2d):
    """cuSPARSE's CSR product of exactly the nonzeros a B9 table covers
    (the matrix less its residual and its gathered side-plan, in the
    coordinates the launch reads and writes), as a callable on x2d."""
    rows, cols, v = routed_tile_coo(table, x2d.shape[0])
    a = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), v,
        (table.num_ytiles * 1024, x2d.numel())).coalesce().to_sparse_csr()
    xs = x2d.reshape(-1)
    return lambda: a @ xs


def gathered_chain(gath, failures):
    """The gathered executor's whole chain (B12, two transposes and B11s,
    B13) beside one CSR product of the nonzeros it takes, A_g @ x: A_g's
    columns are the tile slots' sources, from the chain's gather of the
    column indices."""
    h, xd = gath
    d, gm, nyt = h._d, h._routed_meta["gathered"], h._routed_meta["nyt"]
    x = _gathered_x(h, xd)
    x2d = x.reshape(-1, 128)

    def chain():
        xg = gathered_gather_apply(d, gm, "g_", x2d)
        return spmv_gathered_tiles(d["g_vals"], d["g_word"], d["g_byt"], xg,
                                   nyt, gm["nch"], gm["tchunk"])

    src = gathered_gather_apply(d, gm, "g_", torch.arange(
        x.numel(), device=x.device, dtype=torch.float32).reshape(x2d.shape))
    rows, slots, v = gathered_tile_coo(d["g_vals"], d["g_word"], d["g_byt"],
                                       nyt)
    cols = src.reshape(-1).long()[slots]  # exact: K*1024 < 2**24
    a = torch.sparse_coo_tensor(torch.stack([rows, cols]), v, (
        nyt * 1024, x.numel())).coalesce().to_sparse_csr()
    got = chain()
    want = (a @ x).reshape(got.shape)
    torch.cuda.synchronize()
    ok, err, line = _agree("gathered chain", got, want)
    if not ok:
        failures.append("the gathered chain disagrees with CSR A_g @ x")
    ms = median_ms(chain)
    busy = device_ms(chain)
    lib_ms = median_ms(lambda: a @ x)
    log(f"  gathered chain [{GATHERED_FIXTURE}, {a._nnz()} nonzeros, "
        f"{gm['T']} tiles]: {line}; chain {ms:.4f} ms (device busy "
        f"{_ms(busy)}), CSR A_g @ x {lib_ms:.4f} ms, "
        f"{'ok' if ok else 'FAIL'}")
    return {"nnz": int(a._nnz()), "tiles": gm["T"], "chain_ms": ms,
            "device_busy_ms": busy, "library_ms": lib_ms,
            "max_abs_err": err}


def b1_b7_cases(handles):
    """B1 on the arrays and x of the main path's TSOPF block and trans5
    ELLX overflow runs, B7 on crystk03's (auto, bh 8; window, bh 64); each
    label names V, the row slices and the CTAs of the launch (B2's and
    B8's grid at one vector)."""
    cases = []
    for label, key, ov in (("TSOPF_RS_b2383 block", "TSOPF_RS_b2383 block",
                            ""),
                           ("trans5 ELLX overflow", "trans5 auto", "o")):
        h, xd = handles[key]
        p = h.plan
        data = h._d[ov + "data"]
        V, slices, ctas = chunked_batched_grid(1, data.shape[0], h._chunk,
                                               p.block_h)
        cases.append(("spmv_chunked",
                      f"{label}, bh {p.block_h}, V {V}, {slices} row slices, "
                      f"{ctas} CTAs",
                      (data, h._d[ov + "meta"], h._pad_x(xd).reshape(-1, 128),
                       (p.overflow if ov else p).num_row_blocks, p.block_h,
                       h._chunk)))
    for label in ("crystk03 auto", "crystk03 window bh64"):
        h, xd = handles[label]
        p = h.plan
        data = h._d["data"]
        V, slices, ctas = windowed_batched_grid(1, data.shape[0], h._wchunk,
                                                p.block_h)
        cases.append(("spmv_windowed",
                      f"{label}, bh {p.block_h}, V {V}, {slices} row slices, "
                      f"{ctas} CTAs",
                      (data, h._d["subidx"], h._d["meta"],
                       h._pad_x(xd).reshape(-1, 128), p.num_row_blocks,
                       p.block_h, h._wchunk)))
    return cases


def batched_cases(handles, linear_x, accel):
    """B2, B8 and B10 on the arrays and batches of the linear runs, and B8
    on the MLP's fc3 at batch 64."""
    cases = b2_cases(handles, linear_x) + b8_cases(handles, linear_x, accel)
    for label in ("trans5 routed", "ford2 routed"):
        for i, (packed, dims, xt, nyt) in enumerate(
                routed_batched_args(handles[label][0], linear_x[label])):
            B = xt.shape[2]
            V = routed_batched_v(B, dims[0] * dims[1])
            cases.append(("spmv_routed_batched",
                          f"{label.split()[0]} stream {i}: {dims[0]} tiles, "
                          f"W {dims[2]}, l1 {dims[3]}, lmax {dims[4]}, B {B}, "
                          f"V {V}, {dims[0] * dims[1] * -(-B // V)} CTAs",
                          (packed, dims, xt, nyt)))
    return cases


def b2_cases(handles, linear_x):
    """B2 on the arrays of the linear runs that take it (TSOPF's block
    handle and trans5's ELLX overflow at B 8) and, as a direct call, on
    TSOPF's arrays at B 64 (past the handle's budget, where its linear runs
    B6); each label names V, the row slices and the CTAs of the launch."""
    x64 = torch.from_numpy(np.random.default_rng(SEED + 7).standard_normal(
        (BATCH, handles["TSOPF_RS_b2383 block"][0].shape[1])).astype(
            np.float32)).cuda()
    cases = []
    for label, key, xd, ov in (
            ("TSOPF_RS_b2383 block", "TSOPF_RS_b2383 block",
             linear_x["TSOPF_RS_b2383 block"], ""),
            ("TSOPF_RS_b2383 block", "TSOPF_RS_b2383 block", x64, ""),
            ("trans5 ELLX overflow", "trans5 auto", linear_x["trans5 auto"],
             "o")):
        h, _ = handles[key]
        xb = h._pad_x(xd)
        B = xb.shape[0]
        bh = h.plan.block_h
        nrb = (h.plan.overflow if ov else h.plan).num_row_blocks
        data, meta = h._d[ov + "data"], h._d[ov + "meta"]
        V, slices, ctas = chunked_batched_grid(B, data.shape[0], h._chunk, bh)
        cases.append(("spmv_chunked_batched",
                      f"{label}, bh {bh}, B {B}, V {V}, {slices} row slices, "
                      f"{ctas} CTAs",
                      (data, meta, xb.T.reshape(-1, 128, B).contiguous(), nrb,
                       bh, h._chunk)))
    return cases


def b8_cases(handles, linear_x, accel):
    """B8 on crystk03's window handle at the batch of its linear run and on
    the MLP's fc3 on its real input, fc2's activations at batch 64, with x
    vector-minor as the handle builds it; each label names V, the row
    slices and the CTAs of the launch."""
    h, _ = handles["crystk03 auto"]
    runs = [("crystk03", h, h._pad_x(linear_x["crystk03 auto"]))]
    (h1, b1), (h2, b2), (h, _) = accel.layers
    x = torch.from_numpy(np.random.default_rng(SEED + 3).standard_normal(
        (BATCH, MLP["input"])).astype(np.float32)).cuda()
    runs.append((f"MLP fc3 {h.shape[0]}x{h.shape[1]}", h, h._pad_x(
        torch.relu(h2.linear(torch.relu(h1.linear(x, b1)), b2)))))
    cases = []
    for label, h, xb in runs:
        p, B = h.plan, xb.shape[0]
        data = h._d["data"]
        V, slices, ctas = windowed_batched_grid(B, data.shape[0], h._wchunk,
                                                p.block_h)
        cases.append(("spmv_windowed_batched",
                      f"{label}, bh {p.block_h}, B {B}, V {V}, {slices} row "
                      f"slices, {ctas} CTAs",
                      (data, h._d["subidx"], h._d["meta"],
                       xb.T.reshape(-1, 128, B).contiguous(),
                       p.num_row_blocks, p.block_h, h._wchunk)))
    return cases


def v_sweep(cases, name, tag, vpts=(4, 8)):
    """The device time of kernel ``name`` (B1, B2, B7 or B8, logged as
    ``tag``) on each of its cases at each V of ``vpts``.  Launches here are
    not counted."""
    wrapper = KERNELS[name]["wrapper"]
    rows = []
    for n, shape, args in cases:
        if n != name:
            continue
        row = {"case": shape}
        for vpt in vpts:
            row[f"V{vpt}_ms"] = device_ms(lambda: wrapper(*args, vpt=vpt))
        log(f"  {tag} [{shape}]: device ms at " + ", ".join(
            f"V {v} {_ms(row[f'V{v}_ms'])}" for v in vpts))
        rows.append(row)
    return rows


def routed_batched_args(h, xd):
    """B10's arguments for each stream of a routed handle's ``linear`` on
    the batch ``xd`` [B, C], as ``_run_routed_batched`` builds them: the
    packed stream and x vector-minor, xt [nwin*8, 128, B]."""
    meta = h._routed_meta
    xb = h._pad_x(xd)
    xt = xb.T.reshape(-1, 128, xb.shape[0]).contiguous()
    out = []
    for i, dims in enumerate(meta["streams"]):
        p = f"s{i}_"
        packed = tuple(h._d[p + n] for n in stream_array_names(dims[4]))
        packed += (h._d[p + "base"], h._d[p + "byt"])
        out.append((packed, dims, xt, meta["nyt"]))
    return out


def b10_v_sweep(handles, linear_x):
    """B10's device time on each stream of the routed ``linear`` runs at
    each V the kernel is built for; at the launcher's V with x = 0 (every
    difference is zero, so no atomic is issued and the rest of the kernel
    runs as before); and the zeroing of its y alone.  Launches here are
    not counted."""
    rows = []
    for label in ("trans5 routed", "ford2 routed"):
        args = routed_batched_args(handles[label][0], linear_x[label])
        row = {"run": label, "batch": args[0][2].shape[2]}
        for vpt in (4, 8):
            row[f"V{vpt}_ms"] = [device_ms(
                lambda a=a: spmv_routed_stream_batched(*a, vpt=vpt))
                for a in args]
        x0 = torch.zeros_like(args[0][2])
        row["x0_ms"] = [device_ms(lambda a=a: spmv_routed_stream_batched(
            a[0], a[1], x0, a[3])) for a in args]
        row["y_fill_ms"] = [device_ms(lambda a=a: torch.zeros(
            (a[2].shape[2] * a[3] * 8, 128), device=a[2].device))
            for a in args]
        for key, what in (("V4_ms", "V 4"), ("V8_ms", "V 8"),
                          ("x0_ms", "launcher's V, x = 0 (no atomics)"),
                          ("y_fill_ms", "zeroing y alone")):
            per = row[key]
            log(f"  B10 {label} B {row['batch']}, {what}: device ms per "
                f"stream {[_ms(t) for t in per]}, sum "
                f"{_ms(sum(per) if None not in per else None)}")
        rows.append(row)
    return rows


def permute_vs_gather(handles, failures):
    """The rank-space x permutation of language through B11 (three stages
    and two transposes) beside one direct ``index_select``."""
    h, xd = handles["language routed rank"]
    meta = h._routed_meta["xperm"][0]
    arrays = [[h._d[f"xp0_a{si}_0"]] for si in range(3)]
    perm = torch.from_numpy(h.plan.col_perms[0]).to(xd.device)
    got = permute_apply(meta, arrays, xd)
    want = xd.index_select(0, perm)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        failures.append("permute_apply differs from x.index_select(0, perm)")
    ms = median_ms(lambda: permute_apply(meta, arrays, xd))
    gather_ms = median_ms(lambda: xd.index_select(0, perm))
    log(f"  language x permutation ({meta['n']} elements): permute_apply "
        f"{ms:.4f} ms, index_select {gather_ms:.4f} ms, "
        f"{'equal' if torch.equal(got, want) else 'DIFFERENT'}")
    return {"n": meta["n"], "permute_apply_ms": ms, "index_select_ms":
            gather_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    gpu = gpu_line()
    log(f"gpu: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase 1: build the kernels from source")
    build_s = cuda_build.build(verbose=True)
    cuda_build.get_lib()
    log(f"  build {build_s:.1f} s ({', '.join(cuda_build.sources())})")

    log("phase 2: fixtures (suite stand-ins at scale 1.0)")
    t0 = time.perf_counter()
    fixtures = {n: suite_matrix(n, 1.0, seed=SEED)
                for n in sorted({r[1] for r in SPARSE_RUNS})}
    for n, coo in fixtures.items():
        log(f"  {n}: {coo.shape[0]}x{coo.shape[1]}, nnz {coo.nnz}")
    log(f"  generated in {time.perf_counter() - t0:.1f} s")

    failures: list = []
    log("phase 3: main path (prepare -> run, Accelerator)")
    handles, runs, counts = main_path(fixtures, failures)
    log(f"  launches on the main path: {counts}")
    log(f"phase 3b: linear on the main path's handles (B {BATCH}, bias)")
    linear_runs, linear_x = linear_path(handles, fixtures, counts, failures)
    log("phase 3c: the three-layer MLP at full width "
        f"({MLP['input']} -> {MLP['hidden']} -> {MLP['hidden']} -> "
        f"{MLP['out']}, density {MLP['density']})")
    accel, mlp_runs = model_path(counts, failures)
    log(f"  launches on the three paths: {counts}")
    meshes = list(SHARD_MESHES)
    ncards = torch.cuda.device_count()
    log("phase 3d: the sharded executors (dist) on meshes "
        f"{[list(m) for m in meshes]}")
    shard_runs, shard_args = sharded_path(handles, fixtures, meshes, counts,
                                          failures)
    zero_launches()
    dry = dryrun_multichip(["cuda:0"] * 4)
    for n, c in launches().items():
        counts[n] += c
    if ncards >= 2:
        cards = tuple(f"cuda:{i}" for i in range(min(ncards, 4)))
        log(f"  {ncards} cards: phase 3d on distinct cards {list(cards)}")
        runs_d, _ = sharded_path(handles, fixtures, [cards], counts,
                                 failures)
        shard_runs += runs_d
        dry_d = dryrun_multichip(list(cards))
        log(f"  dryrun on distinct cards: {dry_d}")
    else:
        log(f"  {ncards} card: phase 3d on distinct cards was not run")
    log(f"phase 3e: the ops entry (spmv_block, B6 at B {BATCH})")
    ops_row, ops_cases = ops_entry(handles, fixtures, counts, failures)
    log("phase 3f: block matrices past the chunked layout's budget")
    large_runs, large = large_block_path(counts, failures)
    log(f"phase 3g: the gathered side-plan of routed ({GATHERED_FIXTURE}, "
        f"modelled costs {GATHERED_COSTS} for this phase)")
    gath_row, gath = gathered_path(counts, failures)
    log(f"  launches on the seven paths: {counts}")
    for n, c in counts.items():
        if c == 0:
            failures.append(f"the paths never launched {n}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f}"
        " MB")

    log("phase 4: each kernel against its plain version, its bound and its "
        "library call")
    extra = (sharded_cases(shard_args, handles) + ops_cases
             + large_block_cases(large))
    if gath is not None:
        extra += gathered_cases(gath)
    extra += routed_part_cases(handles, gath)
    results = kernel_checks(handles, linear_x, accel, extra, failures)
    sweep = b10_v_sweep(handles, linear_x)
    b2_sweep = v_sweep(b2_cases(handles, linear_x), "spmv_chunked_batched",
                       "B2")
    b8_sweep = v_sweep(b8_cases(handles, linear_x, accel),
                       "spmv_windowed_batched", "B8")
    b1_cases = b1_b7_cases(handles)
    b1_sweep = v_sweep(b1_cases, "spmv_chunked", "B1", (1, 4))
    b7_sweep = v_sweep(b1_cases, "spmv_windowed", "B7", (1, 4))
    perm_times = permute_vs_gather(handles, failures)
    chain = None if gath is None else gathered_chain(gath, failures)
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f}"
        " MB")

    kernels = [{
        "name": f"{r['name']} [{r['shape']}]", "route": "cuda",
        "source": KERNELS[r["name"]]["source"],
        "replaces": KERNELS[r["name"]]["replaces"],
        "launches": counts[r["name"]], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "device_busy_ms": r["device_busy_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        **({"packed_bound_ms": r["packed_bound_ms"]}
           if "packed_bound_ms" in r else {}),
    } for r in results]
    log(json.dumps({"runs": runs, "linear": linear_runs, "mlp": mlp_runs,
                    "sharded": shard_runs, "dryrun": dry, "ops": ops_row,
                    "large_block": large_runs, "gathered": gath_row,
                    "gathered_chain": chain, "permutation": perm_times,
                    "b10_v_sweep": sweep, "b2_v_sweep": b2_sweep,
                    "b8_v_sweep": b8_sweep, "b1_v_sweep": b1_sweep,
                    "b7_v_sweep": b7_sweep}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    log(json.dumps({"kernels": kernels}))
    log(gpu)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
