#!/usr/bin/env python3
"""Smoke run of hispmv_tpu_torch on one CUDA card (written for an H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``hispmv_tpu_torch/csrc/``
(B1-B13), then drives eleven paths of the port, each run with the launch
counts zeroed just before it and read just after.  Every handle plans
under the card's device profile (``H100``,
``hispmv_tpu_torch/profiles.py``); the gathered phase takes V5E with its
gathered costs lowered where H100's own costs do not keep a side-plan
beside routed streams, and prints why.

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
  through B3; planned under V5E where H100's budgets tile it, which the
  phase prints);
- the routed format's gathered side-plan on the analytics stand-in beside
  its routed streams, under H100 or, where H100's costs do not give both,
  under V5E with the gathered costs lowered: ``run`` through B12, B11
  twice, B13 and B9, and ``linear`` at B 8 vector by vector.
- the tuned entry: the ``split`` format on trans5 with its routed body
  (``run`` through one B9 launch, ``linear`` at B 64 vector by vector)
  and with an ELLX body (``run`` through the base product and B1,
  ``linear`` at B 8 through B2), each timed beside the routed handle and
  the CSR product; the CLI in process (``@trans5 --format tune --measure
  3``: the shortlist timed on the card, the winner verified and timed
  beside trans5's ``auto`` handle);
- persistence: the plan of every format's handle above (window, ELLX with
  its overflow, chunked, tiled and paneled block, routed in original and
  rank space and with its gathered side-plan, split with a routed and an
  ELLX body) saved with ``save_plan``, loaded with ``load_plan``, rebuilt
  with ``SpmvHandle.from_plan`` and run on the original's inputs: y
  against the golden and the original's y, launches of one run kernel by
  kernel against the original's, file size and seconds beside the
  original ``prepare``; the crystk03 stand-in written with ``save_mtx``
  and read by ``load_mtx`` through the native parser and the numpy branch;
  the Flan_1565-sized matrix packed by the native packer and by the numpy
  branch (plans array-equal); ``profile_trace`` around TSOPF_RS_b2383
  block runs (the trace must name B1's kernel) and ``PowerMonitor`` over
  2.5 s of Flan_1565-sized runs (finite watts within [50 W, the card's
  power limit]; energy a run), all in a ``Tracer``;
- the sharded executors on a ``ProcessMesh``: one NCCL rank a card (one
  rank on a single card, up to four on distinct cards), each a process
  that this script starts (``python3 chip_smoke.py STORE WORLD RANK
  OUT``), runs the block executor with x gathered and the chunked one
  with the x ring on TSOPF_RS_b2383 and the windowed one with x gathered
  on crystk03; every rank's full y is held to the golden and to the
  one-process executor at the same D, its launches of one call (one B5 or
  B7, D B3) and ring sends counted, and its time (CUDA events, median of
  20) logged beside the one-process executor's.  A rank that fails or
  outlives its time fails the run;
- the device profile: model-only ``tune`` under V5E and under H100 on the
  five phase-3 fixtures and analytics, every shortlisted candidate
  prepared under its profile, held to the golden and timed with
  ``bench_spmv`` beside its estimate; the two picks timed in turns; the
  median |log2(estimate / time)| of each profile.

Every result is held to a float64 golden at rtol 1e-3.  Then each kernel
is compared with its plain PyTorch version on the arrays the paths gave it
and both are timed beside the kernel's bound (bytes over the HBM rate or
fp32 operations over the FMA rate, whichever is larger) and, where one
PyTorch call computes the same function (a CSR product, ``index_select``;
for B10 the CSR product of each stream's nonzeros against the batch),
that call (its wall and its device busy time); B11's and B12's lines name
their launch shape; the rank-space permutation is timed beside a direct
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

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

import hispmv_tpu_torch.ops as ops
from hispmv_tpu_torch import Accelerator, SpmvConfig, SpmvHandle, cli, \
    prepare
from hispmv_tpu_torch.api.handle import choose_format
from hispmv_tpu_torch.dist import (
    build_sharded_block_plan,
    build_sharded_chunked_plan,
    build_sharded_window_plan,
    init_distributed,
    make_mesh,
    make_process_mesh,
    spmv_sharded,
    spmv_sharded_chunked,
    spmv_sharded_window,
    to_device,
)
from hispmv_tpu_torch.dist.dryrun import dryrun_multichip
from hispmv_tpu_torch.dist.shard import device_bytes
from hispmv_tpu_torch import native
from hispmv_tpu_torch.formats.mtx import _parse_body_numpy, load_mtx, save_mtx
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
    permute_stage_grid,
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
    s1_gather_grid,
    s1_gather_plain,
    spmv_gathered_grid,
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
from hispmv_tpu_torch.ops.spmv_ellx import EllxPlan
from hispmv_tpu_torch.plan import load_plan, save_plan
from hispmv_tpu_torch.plan.blocks import _pack_blocks_numpy
from hispmv_tpu_torch.plan.routed import RoutedPlan
from hispmv_tpu_torch.plan.split import build_split_plan
from hispmv_tpu_torch.tune import DSE, tune
from hispmv_tpu_torch.tune.dse import measured_shortlist
from hispmv_tpu_torch.tune.cost import H100, V5E
from hispmv_tpu_torch.utils.errors import error_stats
from hispmv_tpu_torch.utils.metrics import read_metrics
from hispmv_tpu_torch.utils.trace import PowerMonitor, Tracer, profile_trace
# the port's timing harness: the median of TIMED_RUNS calls between CUDA
# events recorded around each, after a warm-up
from hispmv_tpu_torch.utils.timing import TIMED_RUNS, bench_spmv, median_ms

SEED = 0
ALPHA, BETA = 1.5, -0.5
RTOL = 1e-3  # the reference's acceptance (utils/errors.py)
KERNEL_RTOL = 1e-5  # kernel vs plain: fp32 both, only the summation order
# linear outputs against the float64 golden: rtol 1e-3 plus an absolute
# floor of 1e-5 of the largest |y|, since an fp32 sum of K terms errs by
# ~eps*sqrt(K) of the output's scale, and among a batch's millions of
# outputs some cancel to near zero
GOLDEN_ATOL = 1e-5

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

# phase 3f: block matrices past the chunked layout's budget, under H100's
# budgets, or under V5E's where H100's give another layout (the phase
# prints which).  (label, rows, cols, nonzeros before dedup, layout, kernel of
# run, linear batch or None); the first is SuiteSparse Janna/Flan_1565's
# size, the second tests/test_api.py's wide shape.
LARGE_BLOCK_RUNS = [
    ("Flan_1565-sized block", 1_564_794, 1_564_794, 114_165_372, "tiled",
     "spmv_chunked_tiled", BATCH),
    ("200000x5120000 block", 200_000, 5_120_000, 14_600_000, "paneled",
     "spmv_chunked_paneled", None),
]
# phase 3g: the gathered side-plan of analytics beside routed streams,
# planned under H100, or, where H100's own costs do not give both, under
# V5E with the gathered tile and stage costs lowered (the plan of two
# streams and a side-plan; the phase prints which and why)
GATHERED_FIXTURE = "analytics"
GATHERED_LOWERED = {"gath_tile_ns": 1.0, "gath_stage_ns": 1.0}
GATHERED_BATCH = 8

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bandwidth and
# the fp32 and fp64 rates outside the tensor cores (an FMA counts as two
# operations).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12

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


def power_limit_w(gpu: str) -> float:
    """The watts of ``gpu_line()``'s power limit ("..., 700.00 W")."""
    return float(gpu.rsplit(",", 1)[1].split()[0])


def launches() -> dict:
    return {n: k["wrapper"].launches for n, k in KERNELS.items()}


def zero_launches() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


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
            if h.format == "block":
                # the handle's profile rules B2 against B6
                kernels = (("spmv_chunked_batched",) if h._block_uses_b2(B)
                           else ("spmv_block_batched",))
                log(f"  {label}: {h.profile.name}'s rule takes "
                    f"{'B2' if kernels[0] == 'spmv_chunked_batched' else 'B6'}"
                    f" at B {B}")

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
    return [n for n in ("chunked", "paneled", "tiled")
            if getattr(h, "_" + n, False)]


def large_block_path(counts, failures):
    """Phase 3f: ``prepare(coo, format="block")`` on matrices past the
    chunked layout's budget, ``run`` against the float64 golden through B4
    or B3, and ``linear`` through B6 where a batch is given; counts zeroed
    before each run and read after.  Returns the rows and, per run, the
    handle and its x, and the matrices."""
    rng = np.random.default_rng(SEED + 7)
    rows_out, handles, coos = [], {}, {}
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
            got = _layout(h)
            del h
            t0 = time.perf_counter()
            h = prepare(coo, SpmvConfig(), "block", profile=V5E)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
            log(f"  {label}: {H100.name}'s budgets lay it out {got}, so the "
                f"phase builds it under {V5E.name}, whose budgets give "
                f"{layout}, to reach {kernel}")
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
        coos[label] = coo
    return rows_out, handles, coos


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


def gathered_prepare(coo):
    """The routed handle of ``coo`` with a gathered side-plan beside
    routed streams: under H100, or, when H100's costs do not give both,
    under V5E with GATHERED_LOWERED; returns (handle, the profile and
    why)."""
    h = prepare(coo, SpmvConfig(), "routed", profile=H100)
    g, n = h.plan.gathered, len(h.plan.streams)
    if g is not None and n:
        return h, (f"{H100.name}: its own costs divert the scattered tiles "
                   f"and keep {n} streams")
    got = (f"{g.num_tiles} gathered tiles" if g is not None
           else "no gathered tile") + f" beside {n} streams"
    prof = dataclasses.replace(V5E, **GATHERED_LOWERED)
    return (prepare(coo, SpmvConfig(), "routed", profile=prof),
            f"{V5E.name} with {GATHERED_LOWERED}: under {H100.name}'s own "
            f"costs the routed plan of this matrix has {got}, so the phase "
            "takes the plan that runs B12, B11 twice, B13 and B9 together")


def gathered_path(counts, failures):
    """Phase 3g: ``prepare(coo, format="routed")`` on the analytics
    stand-in with a gathered side-plan (``gathered_prepare``); ``run``
    against the golden, then ``linear`` at GATHERED_BATCH vector by
    vector.  Counts zeroed before each run and read after.  Returns the
    row, (handle, x) and the matrix."""
    coo = suite_matrix(GATHERED_FIXTURE, 1.0, seed=SEED)
    label = f"{GATHERED_FIXTURE} routed gathered"
    zero_launches()
    t0 = time.perf_counter()
    h, why = gathered_prepare(coo)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    log(f"  {label}: planned under {why}")
    g = h.plan.gathered
    if h.format != "routed" or g is None or not h.plan.streams:
        failures.append(f"{label}: no gathered side-plan beside routed "
                        "streams")
        return None, None, coo
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
    return row, (h, xd), coo


# phase 3h: the tuned entry
SPLIT_FIXTURE = "trans5"
SPLIT_RUNS = [  # (label, body, linear batch)
    ("trans5 split", "routed", BATCH),
    ("trans5 split ellx body", "ellx", 8),
]
SPLIT_ALPHA, SPLIT_BETA = 2.0, 0.5
CLI_MEASURE = 3


def split_launches(h, B=None):
    """The launches of one split ``run`` (B None) or one ``linear`` at
    batch B: a routed body runs B9 once a vector (plus B1 for an ELLX
    residual with overflow, and B12, B11 twice and B13 for a gathered
    side-plan); an ELLX body runs B1 on its overflow, B2 once a batch."""
    want = dict.fromkeys(KERNELS, 0)
    d, v = h._d, 1 if B is None else B
    meta = h._split_body_routed_meta
    if meta is not None:
        want["spmv_routed"] = v if meta["table"] is not None else 0
        want["spmv_chunked"] = v if "b_r_odata" in d else 0
        if meta["gathered"] is not None:
            want.update(s1_gather=v, permute_stage=2 * v, spmv_gathered=v)
    elif "odata" in d:
        want["spmv_chunked" if B is None else "spmv_chunked_batched"] = 1
    return want


def _busy_line(ms, busy):
    return f"{ms:.4f} ms (device busy {_ms(busy)})"


def split_path(fixtures, handles, counts, failures, keep):
    """Phase 3h, part 1: the split format on trans5, with the planner's
    routed body (``prepare(coo, format="split")``) and with an ELLX body
    (``build_split_plan(body_format="ellx")`` then ``from_plan``): ``run``
    at alpha 2, beta 0.5 and ``linear`` with a bias, each held to the
    float64 golden and its launches checked; timed beside trans5's routed
    handle and the CSR product on the same inputs.  Counts zeroed before
    each run and read after.  Each handle is kept in ``keep`` by its
    label, with its prepare seconds."""
    coo = fixtures[SPLIT_FIXTURE]
    a = csr_of(SPLIT_FIXTURE, coo)
    hr, _ = handles["trans5 routed"]
    rng = np.random.default_rng(SEED + 16)
    rows_out = []
    for label, body, B in SPLIT_RUNS:
        zero_launches()
        t0 = time.perf_counter()
        if body == "routed":
            h = prepare(coo, format="split")
        else:
            h = SpmvHandle.from_plan(build_split_plan(
                coo, body_format="ellx", profile=H100))
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        st = h.plan.stats
        want_body = RoutedPlan if body == "routed" else EllxPlan
        if h.format != "split" or not isinstance(h.plan.body, want_body):
            failures.append(f"{label}: format {h.format}, body {st}")
            continue
        x, y_in = inputs(*coo.shape, rng)
        xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y_in).cuda()
        zero_launches()
        y = h.run(xd, yd, SPLIT_ALPHA, SPLIT_BETA)
        torch.cuda.synchronize()
        once = launches()
        want = (SPLIT_ALPHA * coo.matvec(x.astype(np.float64))
                + SPLIT_BETA * y_in)
        # check_run's bound; a handle from a plan has no host matrix for
        # verify()
        es = error_stats(y.cpu().numpy(), want, rtol=RTOL)
        log(f"  {label}: axpby max abs err {es.max_abs_error:.3e}, max rel "
            f"err {es.max_rel_error:.3e} ({es.num_mismatches} past rtol "
            f"{RTOL} + atol 1e-05)")
        if not es.ok or y.shape != want.shape or not torch.isfinite(y).all():
            failures.append(f"{label}: run off the golden")
        if h.coo is not None and not h.verify(rtol=RTOL).ok:
            failures.append(f"{label}: verify() failed")
        key = "spmv_routed" if body == "routed" else "spmv_chunked"
        if once != split_launches(h) or once[key] != 1:
            failures.append(f"{label}: launches of one run {once}, want "
                            f"{split_launches(h)} with one {key}")

        def run():
            return h.run(xd, yd, SPLIT_ALPHA, SPLIT_BETA)
        ms = median_ms(run)
        busy = device_ms(run)
        used = launches()
        for n, c in used.items():
            counts[n] += c
        # beside the routed handle and the CSR product (not counted)
        routed_ms, routed_busy = (median_ms(lambda: hr.run(xd)),
                                  device_ms(lambda: hr.run(xd)))
        csr_ms, csr_busy = median_ms(lambda: a @ xd), device_ms(lambda: a @ xd)
        desc = (f"{st['kc']} hub columns, {st['kr']} hub rows, body "
                f"{st['body_fmt']} of {st['body_nnz']} nonzeros")
        if body == "ellx":
            desc += (f" (k_base {st['body_k']}, overflow "
                     f"{st['body_overflow']} blocks)")
        else:
            desc += f" ({len(h.plan.body.streams)} streams)"
        log(f"  {label}: {desc}; launches of one run {once}")
        row = _row(label, h, coo.nnz, coo.shape[0], prep_s, ms, used, csr_ms)
        log(f"  {label}: run {_busy_line(ms, busy)}; trans5 routed run "
            f"{_busy_line(routed_ms, routed_busy)}; CSR A @ x "
            f"{_busy_line(csr_ms, csr_busy)}")
        row.update(device_busy_ms=busy, routed_ms=routed_ms,
                   routed_busy_ms=routed_busy, csr_ms=csr_ms,
                   csr_busy_ms=csr_busy, stats=st)

        xb = rng.standard_normal((B, coo.shape[1])).astype(np.float32)
        bias = rng.standard_normal(coo.shape[0]).astype(np.float32)
        xbd, bd = torch.from_numpy(xb).cuda(), torch.from_numpy(bias).cuda()
        zero_launches()
        yb = h.linear(xbd, bd)
        torch.cuda.synchronize()
        once = launches()
        wantb = (coo.to_scipy() @ xb.astype(np.float64).T).T + bias
        atol = GOLDEN_ATOL * float(np.abs(wantb).max())
        es = error_stats(yb.cpu().numpy(), wantb, rtol=RTOL, atol=atol)
        if not es.ok or yb.shape != (B, coo.shape[0]) \
                or not torch.isfinite(yb).all():
            failures.append(f"{label} linear B {B}: off the golden")
        key, n = (("spmv_routed", B) if body == "routed"
                  else ("spmv_chunked_batched", 1))
        if once != split_launches(h, B) or once[key] != n:
            failures.append(f"{label} linear B {B}: launches of one call "
                            f"{once}, want {split_launches(h, B)} with {n} "
                            f"of {key}")

        def lin():
            return h.linear(xbd, bd)
        lin_ms, lin_busy = median_ms(lin), device_ms(lin)
        used = launches()
        for n, c in used.items():
            counts[n] += c
        xt = xbd.T.contiguous()
        rl_ms, rl_busy = (median_ms(lambda: hr.linear(xbd, bd)),
                          device_ms(lambda: hr.linear(xbd, bd)))
        csrb_ms, csrb_busy = (median_ms(lambda: a @ xt),
                              device_ms(lambda: a @ xt))
        log(f"  {label} linear B {B}: max abs err {es.max_abs_error:.3e} "
            f"({es.num_mismatches} past rtol {RTOL} + atol {atol:.2e}), "
            f"launches of one call {once}; linear "
            f"{_busy_line(lin_ms, lin_busy)}; trans5 routed linear "
            f"{_busy_line(rl_ms, rl_busy)}; CSR A @ X "
            f"{_busy_line(csrb_ms, csrb_busy)}")
        row["linear"] = {"batch": B, "linear_ms": lin_ms,
                         "device_busy_ms": lin_busy, "launches": used,
                         "routed_linear_ms": rl_ms,
                         "routed_linear_busy_ms": rl_busy,
                         "csr_ms": csrb_ms, "csr_busy_ms": csrb_busy}
        rows_out.append(row)
        keep[label] = (h, prep_s)
    return rows_out


def cli_path(fixtures, handles, runs, counts, failures):
    """Phase 3h, part 2: the CLI in process, ``@trans5 --format tune
    --measure 3`` with a metrics CSV and a tune cache in a temporary
    directory; the model's ranking (the card's profile, H100: estimates,
    not times), the time on the card of each shortlisted candidate, and
    the winner's run beside trans5 auto's (ELLX).  Counts zeroed before,
    read after."""
    coo = fixtures[SPLIT_FIXTURE]
    model = DSE(H100).explore(coo)
    log(f"  model ranking ({H100.name} estimates, not times): "
        f"{[(lbl, round(s * 1e6, 1)) for lbl, s in model.candidates[:6]]}")
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "metrics.csv")
        cache = os.path.join(tmp, "tune.json")
        argv = [f"@{SPLIT_FIXTURE}", "--format", "tune", "--measure",
                str(CLI_MEASURE), "--metrics-csv", csv, "--tune-cache", cache]
        log(f"  cli.main({argv[:5]} ...)")
        zero_launches()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        used = launches()
        (row,) = read_metrics(csv)
        with open(cache) as f:
            (entry,) = json.load(f).values()
        with open(cache + ".measured") as f:
            # keyed fingerprint:profile:label
            measured = {k.rsplit(":", 1)[1]: v
                        for k, v in json.load(f).items()}
    for n, c in used.items():
        counts[n] += c
    if rc != 0 or row["verified"] != "True":
        failures.append(f"cli @{SPLIT_FIXTURE} tune: exit {rc}, verified "
                        f"{row['verified']}")
    if not entry["measured"] or sum(used.values()) == 0:
        failures.append(f"cli @{SPLIT_FIXTURE} tune: nothing measured on the "
                        "card")
    # every candidate the tuner shortlists is built, run and timed on the
    # card and passes its accuracy guard
    short = [lbl for lbl, *_ in measured_shortlist(model, CLI_MEASURE)]
    for lbl in dict.fromkeys(short + list(measured)):
        v = measured.get(lbl)
        if v is None or v.get("t") is None:
            failures.append(f"cli @{SPLIT_FIXTURE} tune: candidate {lbl} "
                            f"has no time on the card: {v}")
    auto_ms = next(r["run_ms"] for r in runs if r["run"] == "trans5 auto")
    ha, xa = handles["trans5 auto"]
    auto_s, _ = bench_spmv(ha, xa)
    times = [(lbl, round(v["t"] * 1e3, 4) if v["t"] else v.get("err"))
             for lbl, v in measured.items()]
    log(f"  shortlist measured on the card (run, ms): {times}")
    log(f"  winner {entry['format']} (block_h {entry['config']['block_h']}, "
        f"rank_sort {entry['config']['rank_sort']}): run "
        f"{float(row['kernel_s']) * 1e3:.4f} ms on the card (bench_spmv), "
        f"{row['format']} handle of {int(row['device_bytes']) / 2**20:.1f} "
        f"MB; trans5 auto (ellx, {ha.device_bytes / 2**20:.1f} MB) "
        f"{auto_s * 1e3:.4f} ms by bench_spmv, {auto_ms:.4f} ms as phase 3 "
        f"ran it (alpha, beta); cli {cli_s:.1f} s, launches {used}")
    return {"rc": rc, "metrics": row, "model_candidates": model.candidates,
            "measured": measured, "winner": entry["format"],
            "winner_config": entry["config"], "cli_s": cli_s,
            "launches": used, "auto_bench_ms": auto_s * 1e3,
            "auto_run_ms": auto_ms}


def tuned_entry(fixtures, handles, runs, counts, failures, keep):
    """Phase 3h: the split format and the CLI's measured tune; the split
    handles are kept in ``keep``."""
    split_rows = split_path(fixtures, handles, counts, failures, keep)
    cli_row = cli_path(fixtures, handles, runs, counts, failures)
    return {"split": split_rows, "cli": cli_row}


# phase 3k: the device profile.  Model-only tune under the JAX package's
# TPU v5e profile and under the card's (H100), on the five phase-3
# fixtures and analytics: each shortlisted candidate (the measured tune's
# shortlist at top 2, bf16 payloads left out: they are not held to rtol
# 1e-3) prepared under its profile, held to the golden and timed with
# bench_spmv beside its estimate.
PROFILE_FIXTURES = sorted({r[1] for r in SPARSE_RUNS}) + [GATHERED_FIXTURE]
PROFILE_TOP = 2
PICK_SLACK = 1.10  # an H100 pick within 10% of the V5E pick's time
PICK_ROUNDS = 10  # the picks timed in turns, the order reversed each round


def profile_fixtures(fixtures=None):
    """name -> matrix of PROFILE_FIXTURES (from ``fixtures`` where it has
    them, else generated at scale 1.0, seed SEED)."""
    fixtures = fixtures or {}
    return {n: fixtures[n] if n in fixtures
            else suite_matrix(n, 1.0, seed=SEED) for n in PROFILE_FIXTURES}


def _candidate(coo, fmt, cfg, profile, x, want, failures, label):
    """Prepare one candidate under ``profile``, hold its run to the
    golden, time it; returns (seconds, handle, prepare seconds)."""
    t0 = time.perf_counter()
    h = prepare(coo, cfg, fmt, profile=profile)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    t, y = bench_spmv(h, x)
    st = error_stats(y, want, rtol=RTOL, atol=GOLDEN_ATOL * float(
        np.abs(want).max()))
    if not st.ok or not np.isfinite(y).all():
        failures.append(f"{label}: off the golden ({st.num_mismatches} "
                        f"past rtol {RTOL})")
    return t, h, prep_s


ROUTED_BUSY_ROUNDS = 3  # the routed plans' device busy, in turns


def routed_busy(name, coo, profiles, x, want, failures):
    """The routed plan of ``coo`` (rank space for language, as phase 3
    runs it) under each profile: verified, then its device busy time a
    run, the median of ROUTED_BUSY_ROUNDS readings taken in turns; logs
    the last profile's over the first's.  Returns name -> (streams,
    tiles, residual nonzeros, busy ms)."""
    cfg = SpmvConfig(rank_sort=name == "language")
    hs, busy = {}, {p.name: [] for p in profiles}
    for p in profiles:
        _, h, _ = _candidate(coo, "routed", cfg, p, x, want, failures,
                             f"{name} {p.name} routed")
        hs[p.name] = (h, h._pad_x(torch.from_numpy(x).cuda()))
    for r in range(ROUTED_BUSY_ROUNDS):
        for p in (profiles if r % 2 == 0 else profiles[::-1]):
            h, xp = hs[p.name]
            busy[p.name].append(device_ms(lambda: h._matvec(xp)))
    out = {}
    for p in profiles:
        plan = hs[p.name][0].plan
        b = [t for t in busy[p.name] if t is not None]
        out[p.name] = {"streams": [(s.num_tiles, s.wmax, s.l1, s.lmax)
                                   for s in plan.streams],
                       "residual": len(plan.residual_vals),
                       "gathered_tiles": (plan.gathered.num_tiles
                                          if plan.gathered else 0),
                       "busy_ms": float(np.median(b)) if b else None}
    hs.clear()
    first, last = profiles[0].name, profiles[-1].name
    b0, b1 = out[first]["busy_ms"], out[last]["busy_ms"]
    ratio = b1 / b0 if b0 and b1 else None
    out["busy_ratio"] = ratio
    each = [f"{n} {_ms(o['busy_ms'])} (streams {o['streams']}, residual "
            f"{o['residual']}, gathered tiles {o['gathered_tiles']})"
            for n, o in ((p.name, out[p.name]) for p in profiles)]
    log(f"  {name} routed plans, device busy a run (median of "
        f"{ROUTED_BUSY_ROUNDS} in turns): " + "; ".join(each)
        + f"; {last} / {first} "
        + ("not measured" if ratio is None else f"{ratio:.3f}"))
    return out


def profile_picks(fixtures, profiles, failures):
    """Phase 3k: for each fixture and profile, the model-only ``tune``
    pick and every shortlisted candidate, verified and timed once; then
    per fixture the picks timed in turns (PICK_ROUNDS, ``bench_spmv``
    each), the last profile's pick time over the first's and each pick's
    device busy time, the routed plans' device busy under each profile
    (``routed_busy``), and per profile the median |log2(estimate / time)|
    over the candidates.  Returns the rows."""
    rng = np.random.default_rng(SEED + 11)
    out = {"fixtures": {}, "median_abs_log2": {}}
    logs = {p.name: [] for p in profiles}
    for name, coo in fixtures.items():
        x = rng.standard_normal(coo.num_cols).astype(np.float32)
        want = coo.matvec(x.astype(np.float64))
        row = {"choose_format": choose_format(coo, SpmvConfig())}
        pick_h = {}
        for prof in profiles:
            t0 = time.perf_counter()
            res = tune(coo, profile=prof)
            tune_s = time.perf_counter() - t0
            if res.measured:
                failures.append(f"{name}: a model-only tune came back "
                                "measured")
            cands = []
            for label, est, fmt, cfg in measured_shortlist(res,
                                                           PROFILE_TOP):
                if label.endswith("-bf16"):
                    continue
                t, h, prep_s = _candidate(
                    coo, fmt, cfg, prof, x, want, failures,
                    f"{name} {prof.name} {label}")
                ratio = est / t
                logs[prof.name].append(abs(np.log2(ratio)))
                cands.append({"label": label, "format": h.format,
                              "est_s": est, "bench_s": t,
                              "est_over_time": ratio, "prepare_s": prep_s})
                if len(cands) == 1:
                    pick_h[prof.name] = h
                del h
            pick = cands[0]
            row[prof.name] = {"pick": pick["label"], "format": res.format,
                              "est_s": res.est_seconds,
                              "bench_s": pick["bench_s"],
                              "candidates": cands, "tune_s": tune_s}
            log(f"  {name} under {prof.name}: pick {pick['label']} "
                f"({res.format}), est {res.est_seconds * 1e3:.4f} ms, "
                f"bench_spmv {pick['bench_s'] * 1e3:.4f} ms; shortlist "
                + ", ".join(f"{c['label']} est/time "
                            f"{c['est_over_time']:.3g} "
                            f"({c['bench_s'] * 1e3:.4f} ms)" for c in cands)
                + f"; tune {tune_s:.1f} s")
        turns = {p.name: [] for p in profiles}
        for r in range(PICK_ROUNDS):
            for p in (profiles if r % 2 == 0 else profiles[::-1]):
                turns[p.name].append(bench_spmv(pick_h[p.name], x)[0])
        for p in profiles:
            h = pick_h[p.name]
            xp = h._pad_x(torch.from_numpy(x).cuda())
            row[p.name]["turns_s"] = turns[p.name]
            row[p.name]["device_busy_ms"] = device_ms(lambda: h._matvec(xp))
        pick_h.clear()
        row["routed"] = routed_busy(name, coo, profiles, x, want, failures)
        first, last = profiles[0].name, profiles[-1].name
        ratio = float(np.median(turns[last]) / np.median(turns[first]))
        row["pick_time_ratio"] = ratio
        log(f"  {name}: picks in turns, {first} "
            f"{[round(t * 1e3, 4) for t in turns[first]]} ms, {last} "
            f"{[round(t * 1e3, 4) for t in turns[last]]} ms: {last} / "
            f"{first} {ratio:.3f} "
            f"({'within' if ratio <= PICK_SLACK else 'past'} "
            f"{PICK_SLACK:.2f}); device busy a run {first} "
            f"{_ms(row[first]['device_busy_ms'])}, {last} "
            f"{_ms(row[last]['device_busy_ms'])}; choose_format -> "
            f"{row['choose_format']}")
        out["fixtures"][name] = row
    for pname, lg in logs.items():
        out["median_abs_log2"][pname] = float(np.median(lg))
    log("  median |log2(est / time)| over the shortlisted candidates: "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    out["median_abs_log2"].items()))
    return out


# phase 3i: persistence, native parse and pack, trace.  (label, where the
# handle was built, its key there, the matrix); every format the earlier
# phases build, at full width
PERSIST_RUNS = [
    ("crystk03 window", "main", "crystk03 auto", "crystk03"),
    ("trans5 ellx with overflow", "main", "trans5 auto", "trans5"),
    ("TSOPF_RS_b2383 chunked block", "main", "TSOPF_RS_b2383 block",
     "TSOPF_RS_b2383"),
    ("trans5 routed", "main", "trans5 routed", "trans5"),
    ("ford2 routed", "main", "ford2 routed", "ford2"),
    ("language routed rank space", "main", "language routed rank",
     "language"),
    ("analytics routed gathered", "gathered", None, None),
    ("trans5 split routed body", "split", "trans5 split", "trans5"),
    ("trans5 split ellx body", "split", "trans5 split ellx body", "trans5"),
    ("Flan_1565-sized tiled block", "large", "Flan_1565-sized block", None),
    ("200000x5120000 paneled block", "large", "200000x5120000 block", None),
]
PERSIST_ALPHA, PERSIST_BETA = 1.25, 0.75
MTX_FIXTURE = "crystk03"
TRACE_RUNS = 20  # runs of the TSOPF block handle under profile_trace
POWER_S = 3.5  # seconds of back-to-back Flan-sized runs under PowerMonitor
# the energy a run takes reads only samples this long after the runs began:
# the first sample is taken before any run, and nvidia-smi's power.draw
# may average over the last second
POWER_SETTLE_S = 1.0
POWER_MIN_W = 50.0


def _prepare_s(label, where, key, runs, large_runs, gath_row, split_keep):
    if where == "main":
        return next(r["prepare_s"] for r in runs if r["run"] == key)
    if where == "large":
        return next(r["prepare_s"] for r in large_runs if r["run"] == key)
    if where == "gathered":
        return gath_row["prepare_s"]
    return split_keep[key][1]


def persist_one(label, h, coo, prep_s, tmp, tracer, failures):
    """save_plan -> load_plan -> from_plan -> run on the inputs the original
    handle runs: y against the golden (check_run's bound) and the original
    y (rtol 1e-5 + 1e-5 max|y|), and the launches of one run kernel by
    kernel.  The file is removed before the next handle's is written."""
    rng = np.random.default_rng(SEED + 19)
    x, y_in = inputs(*coo.shape, rng)
    xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y_in).cuda()
    zero_launches()
    y0 = h.run(xd, yd, PERSIST_ALPHA, PERSIST_BETA)
    torch.cuda.synchronize()
    once0 = launches()
    path = os.path.join(tmp, "plan.npz")
    t0 = time.perf_counter()
    with tracer.span("save_plan"):
        save_plan(path, h.plan, compress=False)
    save_s = time.perf_counter() - t0
    mb = os.path.getsize(path) / 2**20
    t0 = time.perf_counter()
    with tracer.span("load_plan"):
        plan = load_plan(path)
    load_s = time.perf_counter() - t0
    os.remove(path)
    t0 = time.perf_counter()
    with tracer.span("from_plan"):
        # a plan file carries no profile: the original's layouts
        h2 = SpmvHandle.from_plan(plan, device="cuda", profile=h.profile)
        torch.cuda.synchronize()
    from_s = time.perf_counter() - t0
    zero_launches()
    with tracer.span("run"):
        y = h2.run(xd, yd, PERSIST_ALPHA, PERSIST_BETA)
        torch.cuda.synchronize()
    once = launches()
    want = (PERSIST_ALPHA * coo.matvec(x.astype(np.float64))
            + PERSIST_BETA * y_in)
    es = error_stats(y.cpu().numpy(), want, rtol=RTOL)
    diff = float((y - y0).abs().max())
    ymax = float(y0.abs().max())
    same = bool(((y - y0).abs() <= KERNEL_RTOL * y0.abs()
                 + KERNEL_RTOL * ymax).all())
    log(f"  {label}: {h.format} ({'/'.join(_layout(h)) or '-'}), file "
        f"{mb:.1f} MB, save {save_s:.2f} s, load {load_s:.2f} s, from_plan "
        f"{from_s:.2f} s (prepare {prep_s:.2f} s); reloaded run: max rel "
        f"err {es.max_rel_error:.3e} ({es.num_mismatches} past rtol {RTOL}"
        f"), max |y - y original| {diff:.3e} (max |y| {ymax:.3e}), "
        f"launches {'the same' if once == once0 else f'{once} != {once0}'}")
    if not es.ok or y.shape != want.shape or not torch.isfinite(y).all():
        failures.append(f"{label}: the reloaded handle's run is off the "
                        "golden")
    if not same:
        failures.append(f"{label}: the reloaded handle's y differs from the "
                        "original's past rtol 1e-5")
    if once != once0 or sum(once.values()) == 0:
        failures.append(f"{label}: launches of one run {once}, the original "
                        f"handle's {once0}")
    if h2.format != h.format or _layout(h2) != _layout(h):
        failures.append(f"{label}: reloaded as {h2.format} {_layout(h2)}, "
                        f"was {h.format} {_layout(h)}")
    del h2, plan
    return {"run": label, "format": h.format, "file_mb": mb,
            "save_s": save_s, "load_s": load_s, "from_plan_s": from_s,
            "prepare_s": prep_s, "max_rel_err": es.max_rel_error,
            "max_abs_diff_original": diff, "launches": once}


def _mtx_body(path):
    """(body, nnz, has_value) of a MatrixMarket file, as load_mtx reads
    them past the header and the comments."""
    with open(path) as f:
        has_value = "pattern" not in f.readline()
        line = f.readline()
        while line.startswith("%") or not line.strip():
            line = f.readline()
        return f.read(), int(line.split()[2]), has_value


def native_mtx(fixtures, tmp, tracer, counts, failures):
    """The crystk03 stand-in written with save_mtx and read by load_mtx;
    its body parsed by the native parser and by the numpy branch, timed
    and compared; then prepare -> run."""
    coo = fixtures[MTX_FIXTURE]
    path = os.path.join(tmp, f"{MTX_FIXTURE}.mtx")
    t0 = time.perf_counter()
    save_mtx(path, coo)
    write_s = time.perf_counter() - t0
    mb = os.path.getsize(path) / 2**20
    t0 = time.perf_counter()
    with tracer.span("load_mtx native"):
        m = load_mtx(path)
    load_s = time.perf_counter() - t0
    body, nnz, has_value = _mtx_body(path)
    os.remove(path)
    t0 = time.perf_counter()
    got = native.parse_mtx_body(body.encode(), nnz, has_value)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = _parse_body_numpy(body, nnz, "real" if has_value else "pattern")
    numpy_s = time.perf_counter() - t0
    del body
    equal = got is not None and all(np.array_equal(a, b)
                                    for a, b in zip(got, want))
    # values at the fp32 round trip of "%.9g"
    fixture = (m.shape == coo.shape and np.array_equal(m.rows, coo.rows)
               and np.array_equal(m.cols, coo.cols)
               and np.array_equal(m.values, coo.values))
    if not equal:
        failures.append(f"load_mtx {MTX_FIXTURE}: native and numpy differ")
    if not fixture:
        failures.append(f"load_mtx {MTX_FIXTURE}: not the fixture written")
    zero_launches()
    t0 = time.perf_counter()
    with tracer.span("prepare"):
        h = prepare(m)
        torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 20)
    x, y_in = inputs(*m.shape, rng)
    xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y_in).cuda()
    with tracer.span("run"):
        y = h.run(xd, yd, ALPHA, BETA)
        torch.cuda.synchronize()
    used = launches()
    for n, c in used.items():
        counts[n] += c
    want = ALPHA * m.matvec(x.astype(np.float64)) + BETA * y_in
    log(f"  load_mtx {MTX_FIXTURE} ({m.nnz} nonzeros, {mb:.1f} MB written in "
        f"{write_s:.2f} s): {load_s:.2f} s; its body parsed natively "
        f"{native_s:.2f} s, by the numpy branch {numpy_s:.2f} s, "
        f"{'equal' if equal else 'DIFFERENT'}; the load is "
        f"{'the fixture' if fixture else 'NOT the fixture'}; prepare "
        f"{prep_s:.2f} s ({h.format}), launches {used}")
    check_run(f"load_mtx {MTX_FIXTURE} run", y, want, h, failures)
    return {"nnz": m.nnz, "file_mb": mb, "write_s": write_s,
            "load_s": load_s, "native_s": native_s, "numpy_s": numpy_s,
            "equal": equal,
            "prepare_s": prep_s, "format": h.format}


def native_pack(h, coo, prep_s, failures):
    """The native block packer and its numpy branch on the Flan-sized
    matrix's nonzeros, as its handle's prepare packed them: timed and
    compared."""
    plan = h.plan
    cols = coo.cols
    if plan.col_perm is not None:
        inv = np.empty(coo.num_cols, np.int32)
        inv[plan.col_perm] = np.arange(coo.num_cols, dtype=np.int32)
        cols = inv[cols]
    args = (coo.rows, cols, coo.values, plan.block_h, plan.num_col_blocks)
    t0 = time.perf_counter()
    got = native.pack_blocks(*args)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_np = _pack_blocks_numpy(*args)
    numpy_s = time.perf_counter() - t0
    equal = all(a.dtype == b.dtype and np.array_equal(a, b)
                for a, b in zip(got, p_np))
    log(f"  the block pack of the Flan_1565-sized matrix ({coo.nnz} "
        f"nonzeros, {plan.num_blocks} blocks): pack_blocks native "
        f"{native_s:.2f} s, numpy branch {numpy_s:.2f} s, packs "
        f"{'array-equal' if equal else 'DIFFERENT'}; the handle's prepare "
        f"(native) {prep_s:.2f} s")
    if not equal:
        failures.append("pack_blocks: the native and numpy packs differ")
    del got, p_np
    return {"nnz": coo.nnz, "blocks": plan.num_blocks,
            "native_s": native_s, "numpy_s": numpy_s, "equal": equal}


def trace_and_power(handles, large, tmp, power_limit, failures):
    """profile_trace around TRACE_RUNS runs of the TSOPF block handle (the
    trace must name B1's kernel), then PowerMonitor over POWER_S seconds of
    back-to-back runs of the Flan-sized handle (HBM-bound).  Launches here
    are not counted."""
    h, xd = handles["TSOPF_RS_b2383 block"]
    with profile_trace(os.path.join(tmp, "trace"), device="cuda") as tr:
        for _ in range(TRACE_RUNS):
            h.run(xd)
    with open(tr.path) as f:
        text = f.read()
    named = "chunked_vec_kernel" in text
    log(f"  profile_trace of {TRACE_RUNS} TSOPF_RS_b2383 block runs: "
        f"{len(text) / 2**20:.1f} MB Chrome trace, device time "
        f"{tr.device_us / 1e3:.4f} ms, {'names' if named else 'LACKS'} "
        "chunked_vec_kernel")
    if not named:
        failures.append("profile_trace: the trace does not name "
                        "chunked_vec_kernel")
    shutil.rmtree(tr.logdir)

    hf, xf = large["Flan_1565-sized block"]
    run_ms = median_ms(lambda: hf.run(xf))
    pm = PowerMonitor(interval_s=0.1, device="cuda")
    pm.start()
    t0, nruns = time.perf_counter(), 0
    while time.perf_counter() - t0 < POWER_S:
        for _ in range(200):
            hf.run(xf)
        nruns += 200
        torch.cuda.synchronize()
    span_s = time.perf_counter() - t0
    pm.stop()
    watts = [s.watts for s in pm.samples]
    loaded = [s.watts for s in pm.samples if s.t_s >= t0 + POWER_SETTLE_S]
    loaded_w = float(np.mean(loaded)) if loaded else float("nan")
    ok = (all(np.isfinite(watts)) and len(loaded) > 0
          and POWER_MIN_W <= loaded_w <= power_limit
          and pm.max_watts <= power_limit)
    energy_mj = loaded_w * run_ms  # W x ms = mJ
    log(f"  PowerMonitor over {nruns} Flan_1565-sized runs ({span_s:.2f} s, "
        f"{len(pm.samples)} samples): avg {pm.avg_watts:.1f} W, max "
        f"{pm.max_watts:.1f} W, {pm.avg_bytes_in_use / 2**20:.0f} MB in use; "
        f"avg {loaded_w:.1f} W over the {len(loaded)} samples from "
        f"{POWER_SETTLE_S:.1f} s into the runs; median run {run_ms:.4f} ms, "
        f"so {energy_mj:.4f} mJ a run (card power limit {power_limit:.2f} W)")
    if not ok:
        failures.append(f"PowerMonitor: watts {watts} not finite within "
                        f"[{POWER_MIN_W}, {power_limit}]")
    return {"trace_mb": len(text) / 2**20, "trace_device_ms":
            tr.device_us / 1e3, "trace_names_b1": named,
            "power_runs": nruns, "power_s": span_s,
            "samples": len(pm.samples), "avg_watts": pm.avg_watts,
            "loaded_samples": len(loaded), "loaded_avg_watts": loaded_w,
            "max_watts": pm.max_watts,
            "avg_bytes_in_use": pm.avg_bytes_in_use, "run_ms": run_ms,
            "energy_mj_per_run": energy_mj}


def persistence_path(fixtures, handles, runs, large, large_coo, large_runs,
                     gath, gath_coo, gath_row, split_keep, power_limit,
                     counts, failures):
    """Phase 3i: every format's handle saved, loaded and rebuilt with
    ``from_plan`` at full width; the native MatrixMarket parser and block
    packer beside their numpy branches; ``profile_trace`` and
    ``PowerMonitor`` on the card.  Its own steps run in a Tracer."""
    tracer = Tracer()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for label, where, key, name in PERSIST_RUNS:
            if where == "main":
                h, coo = handles[key][0], fixtures[name]
            elif where == "large":
                h, coo = large[key][0], large_coo[key]
            elif where == "gathered":
                if gath is None:
                    failures.append(f"{label}: phase 3g gave no handle")
                    continue
                h, coo = gath[0], gath_coo
            elif key not in split_keep:
                failures.append(f"{label}: phase 3h gave no handle")
                continue
            else:
                h, coo = split_keep[key][0], fixtures[name]
            prep_s = _prepare_s(label, where, key, runs, large_runs,
                                gath_row, split_keep)
            row = persist_one(label, h, coo, prep_s, tmp, tracer, failures)
            for n, c in row["launches"].items():
                counts[n] += c
            rows.append(row)
        mtx = native_mtx(fixtures, tmp, tracer, counts, failures)
        key = "Flan_1565-sized block"
        flan_prep = next(r["prepare_s"] for r in large_runs
                         if r["run"] == key)
        pack = native_pack(large[key][0], large_coo[key], flan_prep,
                           failures)
        power = trace_and_power(handles, large, tmp, power_limit, failures)
    log("  phase 3i's steps (Tracer):")
    for line in tracer.report().splitlines():
        log(f"    {line}")
    return {"persist": rows, "mtx": mtx, "pack": pack, "power": power,
            "tracer": tracer.segments}


# phase 3j: the sharded executors on a ProcessMesh, one rank a card (one
# NCCL rank on the one card, up to four on distinct cards), each rank a
# process of its own: ``python3 chip_smoke.py STORE WORLD RANK OUT``.
# (label, fixture, plan kind, x_mode)
PROCESS_RUNS = [
    ("TSOPF_RS_b2383 block gather", "TSOPF_RS_b2383", "block", "gather"),
    ("TSOPF_RS_b2383 chunked ring", "TSOPF_RS_b2383", "chunked", "ring"),
    ("crystk03 window gather", "crystk03", "window", "gather"),
]
RANK_TIMEOUT_S = 600  # every rank's whole run; collectives time out at 120


def process_world() -> int:
    """Ranks of phase 3j: one a card, at most four; one on a single card."""
    n = torch.cuda.device_count()
    return min(n, 4) if n >= 2 else 1


def process_xs(fixtures):
    rng = np.random.default_rng(SEED + 6)
    return {n: rng.standard_normal(fixtures[n].num_cols).astype(np.float32)
            for n in sorted({r[1] for r in PROCESS_RUNS})}


def host_us(fn, calls: int = 50) -> float:
    """Microseconds of host time a call: ``calls`` calls enqueued back to
    back after a warm-up, the card synchronised before and after."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def rank_main(argv) -> int:
    """One rank of phase 3j: join the NCCL group, make the process mesh
    (``cuda:$LOCAL_RANK``), and for each run build the plan at the world's
    size, call the executor once with the launch counts zeroed (read
    after), then time it (median of 20 by CUDA events after 3 warm-up
    calls, and the device busy time over one profiler window of 20 calls:
    every rank makes the same calls, so that the collectives pair up).
    Writes each full y and its figures to ``OUT`` (``.npz``)."""
    store, world, rank, out = argv[0], int(argv[1]), int(argv[2]), argv[3]
    init_distributed(store, world, rank, backend="nccl")
    mesh = make_process_mesh()
    cuda_build.get_lib()
    fixtures = {n: suite_matrix(n, 1.0, seed=SEED)
                for n in sorted({r[1] for r in PROCESS_RUNS})}
    xs = process_xs(fixtures)
    ys, rows = {}, []
    for label, name, kind, x_mode in PROCESS_RUNS:
        build, run, kernel, _ = SHARD_KINDS[kind]
        t0 = time.perf_counter()
        plan = build(fixtures[name], world)
        plan_s = time.perf_counter() - t0
        xd = torch.from_numpy(xs[name]).to(mesh.device)
        call = lambda: run(plan, xd, mesh, x_mode=x_mode)  # noqa: E731
        zero_launches()
        sent = spmv_sharded_chunked.rotations
        y = call()
        torch.cuda.synchronize()
        once = launches()
        sends = spmv_sharded_chunked.rotations - sent
        ms = median_ms(call, device=mesh.device)
        busy = device_ms(call, tries=1)
        ys[label] = y.cpu().numpy()
        rows.append({"run": label, "rank": mesh.rank, "device":
                     str(mesh.device), "plan_s": plan_s, "device_mb":
                     device_bytes(plan, mesh) / 2**20, "launches_once": once,
                     "launches": launches(), "sends": sends, "ms": ms,
                     "device_busy_ms": busy, "host_us": host_us(call),
                     "y_device": str(y.device)})
    # one collective alone, at the size of TSOPF's x, beside a copy of it
    n = -(-fixtures["TSOPF_RS_b2383"].num_cols // 128) * 128
    src = torch.zeros(n, device=mesh.device)
    dst = torch.empty(world * n, device=mesh.device)
    exchange = {"floats": n}
    for key, fn in (("all_gather_into_tensor", lambda: dist.
                     all_gather_into_tensor(dst, src, group=mesh.group)),
                    ("copy_", lambda: dst[:n].copy_(src))):
        exchange[key] = {"ms": median_ms(fn, device=mesh.device),
                         "host_us": host_us(fn)}
    rows.append(exchange)
    np.savez(out, rows=np.array(json.dumps(rows)), **ys)
    dist.destroy_process_group()
    return 0


def process_mesh_path(fixtures, gpu, counts, failures):
    """Phase 3j: spawn the ranks (each in a session of its own, killed with
    what it started if it outlives RANK_TIMEOUT_S); hold every rank's full
    y to the float64 golden and to the one-process executor on the same
    cards at the same D, check its launches of one call (one B5 or B7, D
    B3) and its D - 1 ring sends, and log its time beside the one-process
    executor's."""
    D = process_world()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        try:
            for r in range(D):
                logs.append(os.path.join(tmp, f"rank{r}.log"))
                with open(logs[-1], "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__),
                         f"file://{tmp}/store", str(D), str(r),
                         os.path.join(tmp, f"rank{r}.npz")],
                        env=dict(os.environ, LOCAL_RANK=str(r)),
                        stdout=f, stderr=subprocess.STDOUT,
                        start_new_session=True))
            deadline = time.perf_counter() + RANK_TIMEOUT_S
            for p in procs:
                try:
                    p.wait(timeout=max(deadline - time.perf_counter(), 1))
                except subprocess.TimeoutExpired:
                    break
        finally:
            killed = [p for p in procs if p.poll() is None]
            for p in killed:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        results = []
        for r, (p, path) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                why = (f"killed after {RANK_TIMEOUT_S} s" if p in killed
                       else f"exit {p.returncode}")
                with open(path) as f:
                    tail = f.read()[-3000:]
                failures.append(f"phase 3j rank {r} of {D}: {why}")
                log(f"  rank {r} of {D} failed ({why}):\n{tail}")
                continue
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as f:
                *runs, exchange = json.loads(str(f["rows"]))
                results.append((runs, {k: f[k] for k in f.files
                                       if k != "rows"}))
            log(f"  rank {r} of {D}, {exchange['floats']} floats: "
                + ", ".join(f"{k} median {v['ms']:.4f} ms, host "
                            f"{v['host_us']:.1f} us a call"
                            for k, v in exchange.items() if k != "floats")
                + f"; card: {gpu}")
            rows.append({"rank": r, "world": D, "exchange": exchange})
    if len(results) < D:
        return rows
    xs = process_xs(fixtures)
    mesh = make_mesh(devices=[f"cuda:{r}" for r in range(D)])
    for i, (label, name, kind, x_mode) in enumerate(PROCESS_RUNS):
        build, run, kernel, per_call = SHARD_KINDS[kind]
        coo, x = fixtures[name], xs[name]
        plan = build(coo, D)
        xd = torch.from_numpy(x).to(mesh.devices[0])
        y1 = run(plan, xd, mesh, x_mode=x_mode)
        want = coo.matvec(x.astype(np.float64))
        ms1 = median_ms(lambda: run(plan, xd, mesh, x_mode=x_mode))
        busy1 = device_ms(lambda: run(plan, xd, mesh, x_mode=x_mode))
        host1 = host_us(lambda: run(plan, xd, mesh, x_mode=x_mode))
        per_rank = per_call(D) // D  # one shard a rank
        for rank_rows, ys in results:
            row = rank_rows[i]
            tag = f"{label}, rank {row['rank']} of {D} on {row['device']}"
            y = torch.from_numpy(ys[label]).to(y1.device)
            st = error_stats(ys[label], want, rtol=RTOL)
            same = _agree(kernel, y, y1)[0]
            once = {n: c for n, c in row["launches_once"].items() if c}
            log(f"  {tag}: plan {row['plan_s']:.2f} s, device "
                f"{row['device_mb']:.1f} MB; max rel err "
                f"{st.max_rel_error:.3e} ({st.num_mismatches} mismatches), "
                f"{'equal to' if same else 'OFF'} the one-process y within "
                f"{KERNEL_RTOL}; launches of one call {once}, ring sends "
                f"{row['sends']}; median {row['ms']:.4f} ms (device busy "
                f"{_ms(row['device_busy_ms'])}, host {row['host_us']:.1f} us"
                f" a call), one-process executor at D {D} {ms1:.4f} ms "
                f"(device busy {_ms(busy1)}, host {host1:.1f} us); card: "
                f"{gpu}")
            if not st.ok or ys[label].shape != want.shape:
                failures.append(f"{tag}: off the golden")
            if not same:
                failures.append(f"{tag}: off the one-process executor's y")
            if row["y_device"] != row["device"]:
                failures.append(f"{tag}: y on {row['y_device']}")
            if once != {kernel: per_rank}:
                failures.append(f"{tag}: launches {once}, want {per_rank} "
                                f"{kernel}")
            want_sends = D - 1 if x_mode == "ring" else 0
            if row["sends"] != want_sends:
                failures.append(f"{tag}: {row['sends']} ring sends, want "
                                f"{want_sends}")
            for n, c in row["launches"].items():
                counts[n] += c
            rows.append({**{k: v for k, v in row.items()
                            if k not in ("launches_once", "y_device")},
                         "world": D, "x_mode": x_mode,
                         "max_rel_error": st.max_rel_error,
                         "one_process_ms": ms1,
                         "one_process_device_busy_ms": busy1,
                         "one_process_host_us": host1})
    return rows


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
                           h.profile.panel_ncb, h._sector_mask)))
        else:
            nch = d["data"].shape[0]
            cases.append(("spmv_chunked_paneled",
                          f"{shape}, x panels of {h.profile.panel_ncb} col "
                          "blocks, "
                          f"{b3_shape(nch, h._chunk, p.block_h)}",
                          (d["data"], d["meta"], d["panels"], x2d,
                           p.num_row_blocks, p.block_h, h._chunk,
                           h.profile.panel_ncb)))
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
    warps, rows, ctas = s1_gather_grid(gm["P"], gm["K"])
    threads, tctas, resident = spmv_gathered_grid(gm["nch"] * gm["tchunk"])
    return [
        ("s1_gather", f"{GATHERED_FIXTURE}: P {gm['P']} x K {gm['K']} "
         f"windows, {rows} rows, {warps} warps a CTA, {ctas} CTAs",
         (d["g_s1"], x2d, gm["P"], gm["K"])),
        ("spmv_gathered", f"{GATHERED_FIXTURE}: {gm['T']} tiles, {nyt} y "
         f"tiles, {threads} threads a CTA, {tctas} CTAs, {resident} "
         "resident an SM", (d["g_vals"], d["g_word"], d["g_byt"], xg, nyt,
                            gm["nch"], gm["tchunk"])),
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
        wins, threads, ctas = permute_stage_grid(dims[0] * dims[1])
        cases.append(("permute_stage",
                      f"language x S{si + 1}: {dims[0] * dims[1]} windows, "
                      f"{wins} a CTA of {threads} threads, {ctas} CTAs",
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
        # more windows than elsewhere: the profiler may miss a short
        # kernel's events in one (B10 on trans5's stream 3 in a past run)
        busy = device_ms(lambda: kern(*args, **kw), tries=6)
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
        lib_ms = lib_busy = None
        if lib is not None:
            lib_ok, _, lib_line = _agree(name, lib().reshape(yp.shape), yp)
            lib_ms = median_ms(lib)
            lib_busy = device_ms(lib)
            line += f"; library {lib_line}"
            if not lib_ok:
                failures.append(f"{name} [{shape}]: the library call "
                                "computes another function")
        log(f"  {name} [{shape}]: {line}, kernel {ms:.4f} ms (device busy "
            f"{_ms(busy)}), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}"
            f"{'' if lib is None else f' (device busy {_ms(lib_busy)})'}, "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} [{shape}] disagrees with its plain "
                            "version")
        results.append({"name": CASE_KERNEL.get(name, name), "shape": shape,
                        "max_abs_err": err,
                        "ms": ms, "device_busy_ms": busy,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": lib_ms,
                        "library_device_busy_ms": lib_busy, **extra})
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
# the kernels whose products and prefix run in fp64 (B9, B13); the others'
# operations are fp32
_FP64_WORK = {"spmv_routed", "spmv_routed_part", "spmv_gathered"}


def kernel_bound(name, args, kw, y):
    """(ms, "bytes" or "operations"): the least time of the call on an H100
    SXM, the larger of its inputs' and output's bytes (as packed, each read
    or written once) over the HBM rate and its operations over the FMA
    rate of their type."""
    nbytes = sum(t.nbytes for t in _tensors_in((args, tuple(kw.values()))))
    nbytes += y.nbytes
    payload, vectors = _WORK[name](args)
    flops = 0.0
    if payload is not None:
        flops = 2.0 * int(torch.count_nonzero(payload)) * vectors
    rate = FP64_FLOPS if name in _FP64_WORK else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
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
    its fp64 operations over the FMA rate."""
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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2.0 * nnz / FP64_FLOPS
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
    ``index_select`` for B11 and B12, the CSR product of the nonzeros that
    a B9 or B10 stream or a routed part covers, against the batch for
    B10), or None where none does."""
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
    if name == "spmv_routed_batched":  # y vector-major [B*nyt*8, 128]
        packed, dims, xt, nyt = args
        table = routed_table([(packed, dims, None)], nyt)
        rows, cols, v = routed_tile_coo(table, xt.shape[0])
        a = torch.sparse_coo_tensor(torch.stack([rows, cols]), v, (
            nyt * 1024, xt.shape[0] * 128)).coalesce().to_sparse_csr()
        xs = xt.reshape(-1, xt.shape[2])
        return lambda: (a @ xs).T
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
    large_runs, large, large_coo = large_block_path(counts, failures)
    log(f"phase 3g: the gathered side-plan of routed ({GATHERED_FIXTURE})")
    gath_row, gath, gath_coo = gathered_path(counts, failures)
    log("phase 3h: the tuned entry (split on trans5, the CLI's measured tune, "
        "model-only tune picks)")
    split_handles = {}
    tuned = tuned_entry(fixtures, handles, runs, counts, failures,
                        split_handles)
    log("phase 3i: persistence (save_plan -> load_plan -> from_plan -> run "
        "on every format), the native MatrixMarket parser and block packer, "
        f"profile_trace and PowerMonitor; card: {gpu}")
    persisted = persistence_path(
        fixtures, handles, runs, large, large_coo, large_runs, gath,
        gath_coo, gath_row, split_handles, power_limit_w(gpu), counts,
        failures)
    log(f"phase 3j: the sharded executors on a ProcessMesh "
        f"({process_world()} NCCL rank(s), one a card, a process each); "
        f"card: {gpu}")
    proc_runs = process_mesh_path(fixtures, gpu, counts, failures)
    log(f"phase 3k: model-only tune under {V5E.name} and {H100.name} on "
        f"{PROFILE_FIXTURES}, each shortlisted candidate verified and timed "
        f"with bench_spmv; card: {gpu}")
    picks = profile_picks(profile_fixtures(
        dict(fixtures, **({GATHERED_FIXTURE: gath_coo} if gath_coo is not None
                          else {}))), [V5E, H100], failures)
    log(f"  launches on the eleven paths: {counts}")
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
        "library_device_busy_ms": r["library_device_busy_ms"],
        **({"packed_bound_ms": r["packed_bound_ms"]}
           if "packed_bound_ms" in r else {}),
    } for r in results]
    log(json.dumps({"runs": runs, "linear": linear_runs, "mlp": mlp_runs,
                    "sharded": shard_runs, "dryrun": dry, "ops": ops_row,
                    "large_block": large_runs, "gathered": gath_row,
                    "tuned": tuned, "persistence": persisted,
                    "process_mesh": proc_runs, "profile_picks": picks,
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
    # with arguments: one rank of phase 3j, started by the phase itself
    sys.exit(rank_main(sys.argv[1:]) if len(sys.argv) > 1 else main())
