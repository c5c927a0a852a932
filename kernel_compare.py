#!/usr/bin/env python3
"""Times the block streams on the vec kernel (``csrc/block_vec.cuh``): B1
(``spmv_chunked``), B7 (``spmv_windowed``), B3 (``spmv_chunked_paneled``),
B4 (``spmv_chunked_tiled``), B2 (``spmv_chunked_batched``) and B8
(``spmv_windowed_batched``), and B6 (``spmv_block_batched``), on their
cases of ``chip_smoke.py`` in the checkout it runs from, so that two trees
can be compared on one card in one run: copy this file to the root of each
checkout and run it there, the trees in turns (parent, change, change,
parent).

    python3 kernel_compare.py LABEL [GROUP ...]
    python3 kernel_compare.py calibrate

``calibrate`` measures the card's device profile
(``hispmv_tpu_torch/profiles.py``): per-unit costs as device-time slopes,
per-call costs on the wall clock, the layout, B2/B6 and banding budgets
from wall medians taken in turns (section "calibrate" below); it prints
the ``H100 = DeviceProfile(...)`` literal beside the card's name and power
limit, writes its readings to ``chiprun_out/calibrate.json``, and then
runs ``chip_smoke.py``'s phase 3k under V5E and the measured profile (~10
min on one card).

GROUPs (all when none is named): b1b7, b3, b2, b8, b6, b4, b9, b12, b11,
b13, dist, trace, b10.

``b10`` runs B10 on the benchmark's ``pokec`` matrix at B 64 (its
generator at seed 1; the plan made once and kept at $KC_B10_PLAN, default
``b10_pokec_plan.npz``, for the other checkouts of the call): each of its
streams' kernel device time, with x = 0 (no atomic: what is left when y
moves nothing) and, for a vector-major B10 (the parent's), at B 8 (one
vector group), beside the byte bound and cuSPARSE's ``A_s @ X``; then the
whole ``linear`` against a float64 CSR product.  Then the routed handles
of trans5 and ford2 (``chip_smoke.py``'s, scale 1.0) at B 1, 3, 8 and 64:
each stream's kernel device time and the whole ``linear``'s device busy
and wall, held to a float64 CSR product.

``trace`` times the host side of ``run`` and ``linear`` (B 64) on
TSOPF_RS_b2383's block handle and trans5's routed handle: host
microseconds a call (the enqueue, each call timed alone, batches of 50
synchronised between them, median of 21 batches), with the program's
tracing off and, where the checkout has ``utils.trace.tracing``, on (in
turns, batch by batch); the spans and kernel spans a call; and the
off-path's own cost, a no-op ``span`` and a ``traced`` wrapper's extra
frame, timed alone, times their number a call.

B1's cases, at one vector: TSOPF_RS_b2383's block handle and trans5's ELLX
overflow.  B7's: crystk03's window handle (format auto, bh 8), crystk03 as
window at bh 64, and TSOPF_RS_b2383 as window at bh 8 (its stream is
larger than the card's 50 MB L2, so repeated calls read it from HBM).  For
each of these the handle's ``run`` (alpha 1.5, beta -0.5) is timed too.
B3's: ring shard 0 step 0 of TSOPF_RS_b2383's sharded chunked plan at D 4
(with the D 4 ring call, on a mesh that repeats the card, as its ``run``),
TSOPF_RS_b2383 packed in x panels of 64 col blocks, and the x-paneled
200,000 x 5,120,000 block matrix of phase 3f (with its handle's ``run``);
then the sharded chunked calls on TSOPF_RS_b2383 (ring and replicated at
D 4, ring at D 1).
B2's cases: TSOPF_RS_b2383's block handle at B 8 and 64 and trans5's ELLX
overflow at B 8.  B8's: crystk03's window handle (format auto) at B 64 and
the MLP's fc3 (the full-width model of ``chip_smoke.py``, seed 0) on fc2's
activations at B 64 and on the first of them alone (B 1).  Suite stand-ins
at scale 1.0, seed 0; x from a seeded generator.  B6's: TSOPF_RS_b2383 at
B 64 on ``upload_block_plan`` arrays and the Flan_1565-sized block matrix
of phase 3f (generated here, tiled) at B 64 on its handle's per-block
arrays, each beside the handle's ``linear``; its lines name the runs, the
longest run and, where the checkout has ``block_batched_grid``, the launch
shape (warps a CTA, row slices, CTAs).  B4's: the Flan_1565-sized
matrix's tiled handle (beside its ``run``) and TSOPF_RS_b2383 packed tiled
in 5 x panels of 64 col blocks and 5 y panels of 1,024 row blocks; each
passes the sector mask (the handle's, or ``tiled_sector_mask`` of the
payload) only where the checkout's wrapper takes one, and its line gives
the payload's shares of nonzero lanes and of 32-, 64- and 128-byte
granules with a nonzero, the must-read bound (the live 32-byte sectors,
the mask, meta, x and y over 3.35 TB/s) and the launch shape from
``chunked_tiled_grid`` where the checkout has it.  With the mask the
Flan-sized case is also timed under three masks that do not fit the
payload (all sectors; every other 32-byte sector; every other 64-byte
pair), whose times tell the granularity at which the card reads HBM; and
the registers of ``csrc/spmv_chunked_tiled.cu``'s kernels are read from
``nvcc -Xptxas -v``.  B2 also runs on the Flan-sized
matrix's chunked arrays (``pack_chunks``) at B 64.  B8 takes x vector-minor,
``xt [nwin*8, 128, B]``, or in a checkout that still has ``pack_batch_x``,
x packed [nwin*8, B*128]; the script passes whichever the checkout's
wrapper takes.  Per case it prints the kernel's device busy time
(torch.profiler, over 20 calls), its bound, its agreement with the plain
version and the library call's (cuSPARSE) wall and device busy time on the
same arrays; where the wrapper takes ``vpt``, also the time at each V
(B1, B7: 1 and 4; B2, B8: 4 and 8; five readings each, the V values
alternating: median [min-max]) and the launch shape (V, row slices,
CTAs; B3's from ``chunked_paneled_grid`` where the checkout has it).
B9's group (``b9``): routed handles of trans5, ford2, language in rank
space and analytics with its gathered side-plan (planned under
``chip_smoke.py``'s lowered gathered costs): each stream of trans5 and
ford2 alone (``spmv_routed_stream``); the whole routed part, as the
checkout's ``run`` launches it (one launch on the handle's stream table,
or one a stream with the y tiles summed), with its launches a call, its
device busy time and B9's own (the profiler's ``routed_tile_kernel``
events), its must-read bound (each tile's live boundary rows, by the
plan's lt) and packed bound, its agreement with the sum of the plain
versions and, where the checkout's ``chip_smoke.py`` has
``routed_csr_call``, cuSPARSE's CSR product of the nonzeros it covers;
each handle's ``run``; language's rank-space ``linear`` at B 64 (wall over
5 calls); and the ``-Xptxas -v`` registers of ``csrc/spmv_routed.cu`` and
``csrc/spmv_gathered.cu``.
B12's group (``b12``): B12 on analytics' gathered side-plan (P 8 x K 512
windows) and B11's (``b11``): language's rank-space x S1-S3 (random
values) and the gathered chain's S2 and S3 on the arrays
``gathered_gather_apply`` hands them.  Each line gives equality with the
plain version and with ``index_select`` on the same composed indices
(``chip_smoke.library_call``), the byte bound, the launch shape (from
``s1_gather_grid`` / ``permute_stage_grid`` where the checkout has them)
and the kernel's and ``index_select``'s device times (torch.profiler),
warm (repeated calls) and cold (128 MB of scratch written, or read,
before each call, its time left out), taken in turns, and their walls, after one
reading of each as ``chip_smoke.py``'s phase 4 takes it;
B11 also at two windows a CTA
(``permute.cu`` built alone with ``-DHISPMV_PERMUTE_WINDOWS=2``, where
the source has that parameter) in turns with the built instance.  Then
the handles the kernels sit in (analytics' gathered ``run`` and its
chain alone; language's rank-space ``run``, and ``linear`` at B 64 over
5 calls), wall and device busy, and the ``-Xptxas -v`` registers of
``csrc/spmv_gathered.cu`` / ``csrc/permute.cu``.
B13's group (``b13``): B13 on analytics' gathered side-plan (2,077 tiles,
xg from the chain's gather): agreement with the plain version and with
the CSR product over the tile slots (``chip_smoke.library_call``), the
byte bound, the launch shape (``spmv_gathered_grid`` where the checkout
has it), device times warm and cold in turns with CSR (the wrapper's,
its y fill included, and the kernel's events alone); then analytics'
gathered chain and ``run``, and the ``-Xptxas -v`` registers of
``csrc/spmv_gathered.cu`` and ``csrc/spmv_routed.cu``.
The ``dist`` group: the process mesh of one NCCL rank (this process)
beside the one-process executor on phase 3j's runs, and one
``all_gather_into_tensor`` beside a ``copy_``, each call's wall, host time
a call and device busy time, alone on the card and while a second, idle
process holds a context on it; with two or more cards, also phase 3j of
``chip_smoke.py`` at one NCCL rank a card (``dist_report``).
Exits 1 when a case disagrees, 2 without a CUDA card."""

import contextlib
import dataclasses
import importlib
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from hispmv_tpu_torch import Accelerator, SpmvConfig, SpmvHandle, prepare
from hispmv_tpu_torch.dist import make_mesh, spmv_sharded_chunked, to_device
from hispmv_tpu_torch.formats.synth import blocked_coo, random_coo, suite_matrix
from hispmv_tpu_torch.models import AcceleratorLayerManager, ThreeLayerFCModel
from hispmv_tpu_torch.ops import cuda_build
from hispmv_tpu_torch.ops import spmv_chunked as sc
from hispmv_tpu_torch.ops import spmv_routed as sr
from hispmv_tpu_torch.ops import spmv_windowed as sw
from hispmv_tpu_torch.ops.permute import (
    panel_permute_apply_from,
    permute_stage,
)
from hispmv_tpu_torch.ops.spmv_chunked import chunk_for
from hispmv_tpu_torch.ops.spmv_ellx import build_ellx_plan
from hispmv_tpu_torch.ops.spmv_gathered import (
    gathered_gather_apply,
    spmv_gathered_tiles,
)
from hispmv_tpu_torch.ops.spmv_routed import (
    spmv_routed_stream,
    spmv_routed_streams,
)
from hispmv_tpu_torch.plan.blocks import BlockPlan, build_block_plan
from hispmv_tpu_torch.tune.cost import V5E, DeviceProfile
from hispmv_tpu_torch.utils.timing import bench_spmv

# the module: the ops package's function spmv_block shadows its name
sb = importlib.import_module("hispmv_tpu_torch.ops.spmv_block")


def _takes_vpt(fn):
    return "vpt" in inspect.signature(fn).parameters


_HANDLES = {}


def _panel_ncb(h):
    """The handle's x panel width in col blocks (its profile's, or the
    class constant of a checkout from before the profiles)."""
    return h.profile.panel_ncb if hasattr(h, "profile") else h._PANEL_NCB


def handle(name, block_h, fmt):
    """The handle of suite stand-in ``name`` (scale 1.0, seed 0), prepared
    once per (name, block_h, format)."""
    key = (name, block_h, fmt)
    if key not in _HANDLES:
        _HANDLES[key] = prepare(suite_matrix(name, 1.0, seed=cs.SEED),
                                SpmvConfig(block_h=block_h), fmt)
    return _HANDLES[key]


_FLAN = {}


def flan_handle():
    """The Flan_1565-sized matrix of phase 3f (generated here, ~1 min) and
    its tiled handle, prepared once."""
    if not _FLAN:
        label, R, C, nnz, layout, *_ = cs.LARGE_BLOCK_RUNS[0]
        coo = blocked_coo(R, C, nnz, seed=cs.SEED, spread_frac=0.4)
        h = prepare(coo, SpmvConfig(), "block")
        if not getattr(h, "_" + layout):
            raise SystemExit(f"kernel_compare: {label} is not {layout}")
        _FLAN.update(label=label, handle=h)
    return _FLAN["label"], _FLAN["handle"]


def b1_b7_cases(rng):
    """(label, kernel name, args, run) of B1's two cases and B7's three;
    ``run`` times the handle's ``run`` on the same x."""
    runs = [("TSOPF_RS_b2383 block", "TSOPF_RS_b2383", 8, "block", ""),
            ("trans5 ELLX overflow", "trans5", 8, "auto", "o"),
            ("crystk03 auto", "crystk03", 8, "auto", ""),
            ("crystk03 window", "crystk03", 64, "window", ""),
            ("TSOPF_RS_b2383 window", "TSOPF_RS_b2383", 8, "window", "")]
    cases = []
    for label, name, bh, fmt, ov in runs:
        h = handle(name, bh, fmt)
        x = torch.from_numpy(rng.standard_normal(h.shape[1]).astype(
            np.float32)).cuda()
        y_in = torch.from_numpy(rng.standard_normal(h.shape[0]).astype(
            np.float32)).cuda()
        x2d = h._pad_x(x).reshape(-1, 128)
        p, bh = h.plan, h.plan.block_h
        if h.format == "window":
            kern, grid = "spmv_windowed", getattr(sw, "windowed_batched_grid",
                                                  None)
            args = (h._d["data"], h._d["subidx"], h._d["meta"], x2d,
                    p.num_row_blocks, bh, h._wchunk)
            chunk = h._wchunk
        elif h.format in ("block", "ellx"):
            kern, grid = "spmv_chunked", getattr(sc, "chunked_batched_grid",
                                                 None)
            args = (h._d[ov + "data"], h._d[ov + "meta"], x2d,
                    (p.overflow if ov else p).num_row_blocks, bh, h._chunk)
            chunk = h._chunk
        else:
            raise SystemExit(f"kernel_compare: {label} runs as {h.format}")
        tag = f"{label}, bh {bh}"
        if _takes_vpt(cs.KERNELS[kern]["wrapper"]):
            V, slices, ctas = grid(1, args[0].shape[0], chunk, bh)
            tag += f", V {V}, {slices} row slices, {ctas} CTAs"
        cases.append((f"{'B7' if kern == 'spmv_windowed' else 'B1'} [{tag}]",
                      kern, args,
                      lambda h=h, x=x, y=y_in: h.run(x, y, 1.5, -0.5)))
    return cases


def b3_cases(rng):
    """(label, kernel name, args, run) of B3's three cases, and the
    sharded chunked calls on TSOPF_RS_b2383 as (label, call)."""
    coo = suite_matrix("TSOPF_RS_b2383", 1.0, seed=cs.SEED)
    xd = torch.from_numpy(rng.standard_normal(coo.num_cols).astype(
        np.float32)).cuda()
    grid = getattr(sc, "chunked_paneled_grid", None)

    def tag(label, nch, chunk, bh):
        t = f"{label}, bh {bh}, {nch} chunks of {chunk}"
        if grid is not None:
            V, slices, ctas = grid(nch, chunk, bh)
            t += f", V {V}, {slices} row slices, {ctas} CTAs"
        return f"B3 [{t}]"

    cases, calls = [], []
    for D in (4, 1):
        plan = cs.SHARD_KINDS["chunked"][0](coo, D)
        mesh = make_mesh(devices=["cuda:0"] * D)
        modes = ("ring", "replicated") if D == 4 else ("ring",)
        calls += [(f"TSOPF_RS_b2383 chunked {m}, D {D} on one card",
                   lambda p=plan, m=m, mesh=mesh: spmv_sharded_chunked(
                       p, xd, mesh, x_mode=m)) for m in modes]
        if D == 4:
            sh = to_device(plan, mesh)[0]
            per = plan.ncb_per_shard * 128
            x0 = torch.nn.functional.pad(xd, (0, 4 * per - xd.shape[0]))
            nch = plan.data5.shape[2]
            cases.append((
                tag("TSOPF_RS_b2383 ring shard 0 step 0", nch, plan.chunk,
                    plan.block_h), "spmv_chunked_paneled",
                (sh["data"][0], sh["meta"][0], sh["panels"],
                 x0[:per].reshape(-1, 128), plan.nrb_max, plan.block_h,
                 plan.chunk, plan.ncb_per_shard), calls[0][1]))
    h = handle("TSOPF_RS_b2383", 8, "block")
    p = h.plan
    data3d, meta, panels, nch = sc.pack_chunks_paneled(p, h._chunk,
                                                       cs.PANEL_NCB)
    npanels = -(-p.num_col_blocks // cs.PANEL_NCB)
    x = torch.nn.functional.pad(xd, (0, npanels * cs.PANEL_NCB * 128
                                     - xd.shape[0]))
    cases.append((
        tag(f"TSOPF_RS_b2383 in {npanels} x panels of {cs.PANEL_NCB}", nch,
            h._chunk, p.block_h), "spmv_chunked_paneled",
        (torch.from_numpy(data3d).cuda(), torch.from_numpy(meta).cuda(),
         torch.from_numpy(panels).cuda(), x.reshape(-1, 128),
         p.num_row_blocks, p.block_h, h._chunk, cs.PANEL_NCB), None))
    label, R, C, nnz, layout, *_ = cs.LARGE_BLOCK_RUNS[1]
    h = prepare(blocked_coo(R, C, nnz, seed=cs.SEED, spread_frac=0.4),
                SpmvConfig(), "block")
    if not h._paneled:
        raise SystemExit(f"kernel_compare: {label} is not {layout}")
    x = torch.from_numpy(rng.standard_normal(C).astype(np.float32)).cuda()
    y_in = torch.from_numpy(rng.standard_normal(R).astype(np.float32)).cuda()
    d = h._d
    cases.append((
        tag(label, d["data"].shape[0], h._chunk, h.plan.block_h),
        "spmv_chunked_paneled",
        (d["data"], d["meta"], d["panels"], h._pad_x(x).reshape(-1, 128),
         h.plan.num_row_blocks, h.plan.block_h, h._chunk, _panel_ncb(h)),
        lambda: h.run(x, y_in, 1.5, -0.5)))
    return cases, calls


def b2_cases(rng):
    """(label, kernel name, args) of B2's three cases."""
    handles = {"TSOPF_RS_b2383": handle("TSOPF_RS_b2383", 8, "block"),
               "trans5": handle("trans5", 8, "auto")}
    cases = []
    for name, B, ov in (("TSOPF_RS_b2383", 8, ""), ("TSOPF_RS_b2383", 64, ""),
                        ("trans5", 8, "o")):
        h = handles[name]
        xb = h._pad_x(torch.from_numpy(rng.standard_normal(
            (B, h.shape[1])).astype(np.float32)).cuda())
        nrb = (h.plan.overflow if ov else h.plan).num_row_blocks
        cases.append((
            f"B2 [{name}{' ELLX overflow' if ov else ''}, B {B}]",
            "spmv_chunked_batched",
            (h._d[ov + "data"], h._d[ov + "meta"],
             xb.T.reshape(-1, 128, B).contiguous(), nrb, h.plan.block_h,
             h._chunk), None))
    return cases


def b6_cases(rng):
    """(label, kernel name, args, run, kwargs) of B6's two cases at B 64,
    TSOPF_RS_b2383 on ``upload_block_plan`` arrays and the Flan_1565-sized
    matrix of phase 3f on the handle's own per-block arrays, each with its
    handle's ``linear``; and B2 on the Flan-sized matrix's chunked arrays
    at B 64 (``pack_chunks``), which the handle's ``linear`` never runs."""
    B = cs.BATCH
    grid = getattr(sb, "block_batched_grid", None)
    h = handle("TSOPF_RS_b2383", 8, "block")
    xb = torch.from_numpy(rng.standard_normal((B, h.shape[1])).astype(
        np.float32)).cuda()
    d = sb.upload_block_plan(h.plan, "cuda")
    runs = [("TSOPF_RS_b2383", h, d, xb)]
    label, fh = flan_handle()
    fxb = torch.from_numpy(rng.standard_normal((B, fh.shape[1])).astype(
        np.float32)).cuda()
    fh.linear(fxb)  # uploads the per-block arrays
    runs.append((label, fh, fh._batch_d, fxb))
    cases = []
    for label, h, d, xb in runs:
        p = h.plan
        starts = d["starts"]
        ends = torch.cat([starts[1:].long(),
                          starts.new_tensor([p.num_blocks]).long()])
        tag = (f"{label}, bh {p.block_h}, B {B}, {starts.numel()} runs, "
               f"longest {int((ends - starts.long()).max())} blocks")
        if grid is not None:
            warps, slices, ctas = grid(starts.numel(), p.block_h, B)
            tag += f", {warps} warps a CTA, {slices} row slices, {ctas} CTAs"
        cases.append((
            f"B6 [{tag}]", "spmv_block_batched",
            (d["data"], d["rows"], d["cols"], d["firsts"], d["lasts"],
             h._pad_x(xb).T.reshape(-1, 128, B).contiguous(),
             p.num_row_blocks),
            lambda h=h, xb=xb: h.linear(xb), {"starts": starts}))
    data3d, meta, nch = sc.pack_chunks(fh.plan, fh._chunk)
    xt = fh._pad_x(fxb).T.reshape(-1, 128, B).contiguous()
    V, slices, ctas = sc.chunked_batched_grid(B, nch, fh._chunk,
                                              fh.plan.block_h)
    cases.append((
        f"B2 [{label} chunked, bh {fh.plan.block_h}, B {B}, {nch} chunks of "
        f"{fh._chunk}, V {V}, {slices} row slices, {ctas} CTAs]",
        "spmv_chunked_batched",
        (torch.from_numpy(data3d).cuda(), torch.from_numpy(meta).cuda(), xt,
         fh.plan.num_row_blocks, fh.plan.block_h, fh._chunk), None))
    return cases


def _takes_mask():
    return "sector_mask" in inspect.signature(sc.spmv_chunked_tiled).parameters


def sector_shares(data3d):
    """The shares of the payload's lanes that are nonzero and of its 32-,
    64- and 128-byte granules (8, 16 and 32 f32 lanes) that hold a
    nonzero, padding included."""
    nz = data3d != 0
    out = [f"lanes {float(nz.float().mean()):.3f}"]
    for lanes in (8, 16, 32):
        g = nz.reshape(-1, lanes).any(1).float().mean()
        out.append(f"{lanes * 4} B {float(g):.3f}")
    return ", ".join(out)


def must_read_ms(args, y):
    """B4's must-read bound: the payload's live 32-byte sectors (8 lanes:
    32 B at f32, 16 B at bf16), its sector mask (2 B a row), meta, the
    panel ids, x and y over the HBM rate; (ms, MB)."""
    data3d = args[0]
    live = int((data3d != 0).reshape(-1, 8).any(1).sum())
    nbytes = (live * 8 * data3d.element_size() + data3d.shape[0]
              * data3d.shape[1] * 2 + y.nbytes
              + sum(t.nbytes for t in args[1:5]))
    return 1e3 * nbytes / cs.HBM_BYTES_PER_S, nbytes / 1e6


def b4_cases(rng):
    """(label, kernel name, args, run) of B4's two cases: the Flan-sized
    tiled handle (beside its ``run``) and TSOPF_RS_b2383 packed tiled in
    small panels; the sector mask last where the wrapper takes one."""
    grid = getattr(sc, "chunked_tiled_grid", None)
    mask = _takes_mask()
    cases = []
    label, h = flan_handle()
    p, d = h.plan, h._d
    x = torch.from_numpy(rng.standard_normal(h.shape[1]).astype(
        np.float32)).cuda()
    y_in = torch.from_numpy(rng.standard_normal(h.shape[0]).astype(
        np.float32)).cuda()
    pnrb = h._panel_nrb(p.block_h)
    args = (d["data"], d["meta"], d["xpanels"], d["ypanels"],
            h._pad_x(x).reshape(-1, 128), -(-p.num_row_blocks // pnrb),
            pnrb, p.block_h, h._chunk, _panel_ncb(h))
    runs = [(label, args + ((h._sector_mask,) if mask else ()),
             lambda: h.run(x, y_in, 1.5, -0.5))]
    th = handle("TSOPF_RS_b2383", 8, "block")
    tp = th.plan
    pnrb = 1024
    data3d, meta, xp, yp, _, nch = sc.pack_chunks_tiled(
        tp, th._chunk, cs.PANEL_NCB, pnrb)
    npx = -(-tp.num_col_blocks // cs.PANEL_NCB)
    tx = torch.from_numpy(rng.standard_normal(npx * cs.PANEL_NCB * 128)
                          .astype(np.float32)).cuda()
    data = torch.from_numpy(data3d).cuda()
    args = (data, torch.from_numpy(meta).cuda(), torch.from_numpy(xp).cuda(),
            torch.from_numpy(yp).cuda(), tx.reshape(-1, 128),
            -(-tp.num_row_blocks // pnrb), pnrb, tp.block_h, th._chunk,
            cs.PANEL_NCB)
    runs.append((f"TSOPF_RS_b2383 in {npx} x panels of {cs.PANEL_NCB} and "
                 f"{args[5]} y panels of {pnrb}",
                 args + ((sc.tiled_sector_mask(data, 8),) if mask else ()),
                 None))
    for label, args, run in runs:
        nch, chunk, bh = args[0].shape[0], args[8], args[7]
        tag = f"{label}, bh {bh}, {nch} chunks of {chunk}"
        if grid is not None:
            V, slices, ctas = grid(nch, chunk, bh)
            tag += f", V {V}, {slices} row slices, {ctas} CTAs"
        tag += f"; payload shares: {sector_shares(args[0])}"
        cases.append((f"B4 [{tag}]", "spmv_chunked_tiled", args, run))
    return cases


def granularity_probe(args):
    """Device busy of B4 on the Flan-sized arrays under three masks that do
    not fit the payload: every sector, every other 32-byte sector, every
    other pair of sectors (the answers are not checked)."""
    kern = sc.spmv_chunked_tiled
    out = []
    for name, word in (("all sectors", 0xFFFF), ("every other 32 B", 0x5555),
                       ("every other 64 B", 0x3333)):
        m = torch.full_like(args[10], word - (1 << 16) if word >> 15 else
                            word)
        out.append(f"{name} "
                   f"{cs._ms(cs.device_ms(lambda: kern(*args[:10], m)))}")
    return "; ".join(out)


def ptxas_registers(src="spmv_chunked_tiled.cu"):
    """The registers and spills of the kernels of ``src`` (``nvcc -Xptxas
    -v``, the build's flags), one "name: N registers, S B spilled" each."""
    tmp = tempfile.mkdtemp()
    try:
        proc = subprocess.run(
            [cuda_build._nvcc(), "-Xptxas", "-v", *cuda_build.NVCC_FLAGS,
             "-c", "-o", os.path.join(tmp, "k.o"),
             os.path.join(cuda_build.CSRC_DIR, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    finally:
        shutil.rmtree(tmp)
    entry, spill, out = None, 0, []
    for line in proc.stdout.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.append((entry, int(m.group(1)), spill))
            entry = None
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    names = [e for e, _, _ in out]
    if names and os.path.exists(filt):
        names = subprocess.run([filt, *names], stdout=subprocess.PIPE,
                               text=True).stdout.splitlines()
    return [f"{n}: {r} registers, {sp} B spilled"
            for n, (_, r, sp) in zip(names, out)]


def b8_x(xb, num_windows):
    """The checkout's B8 x for the padded batch ``xb`` [B, nwin*1024]."""
    if hasattr(sw, "pack_batch_x"):  # x packed [nwin*8, B*128]
        return sw.pack_batch_x(xb, num_windows)
    return xb.T.reshape(-1, 128, xb.shape[0]).contiguous()


def b8_cases(rng):
    """(label, kernel name, args) of B8's three cases."""
    h = handle("crystk03", 8, "auto")
    runs = [("crystk03", h, h._pad_x(torch.from_numpy(rng.standard_normal(
        (cs.BATCH, h.shape[1])).astype(np.float32)).cuda()))]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    model = ThreeLayerFCModel(cs.MLP["input"], hidden=cs.MLP["hidden"],
                              out=cs.MLP["out"], density=cs.MLP["density"],
                              generator=gen, device="cuda")
    accel = AcceleratorLayerManager(Accelerator()).replace_layers(model)
    (h1, b1), (h2, b2), (h3, _) = accel.layers
    x = torch.from_numpy(np.random.default_rng(cs.SEED + 3).standard_normal(
        (cs.BATCH, cs.MLP["input"])).astype(np.float32)).cuda()
    xb = h3._pad_x(torch.relu(h2.linear(torch.relu(h1.linear(x, b1)), b2)))
    label = f"MLP fc3 {h3.shape[0]}x{h3.shape[1]}"
    runs += [(label, h3, xb), (label, h3, xb[:1].contiguous())]
    cases = []
    for label, h, xb in runs:
        if h.format != "window":
            raise SystemExit(f"kernel_compare: {label} runs as {h.format}, "
                             "not window")
        p = h.plan
        cases.append((
            f"B8 [{label}, bh {p.block_h}, B {xb.shape[0]}]",
            "spmv_windowed_batched",
            (h._d["data"], h._d["subidx"], h._d["meta"],
             b8_x(xb, p.num_windows), p.num_row_blocks, p.block_h,
             h._wchunk), None))
    return cases


SWEEP = {"spmv_chunked": (1, 4), "spmv_windowed": (1, 4),
         "spmv_chunked_batched": (4, 8), "spmv_windowed_batched": (4, 8)}
SWEEP_ROUNDS = 5  # the V values of a sweep alternate, round by round


def v_sweep(kern, args, vpts):
    """Device busy per call at each V of ``vpts``, ``SWEEP_ROUNDS`` readings
    each, the V values alternating: "V v median [min-max]" per V."""
    got = {v: [] for v in vpts}
    for _ in range(SWEEP_ROUNDS):
        for v in vpts:
            got[v].append(cs.device_ms(lambda: kern(*args, vpt=v)))
    out = []
    for v, ts in got.items():
        ts = [t for t in ts if t is not None]
        out.append(f"V {v} " + (f"{np.median(ts):.4f} [{min(ts):.4f}-"
                                f"{max(ts):.4f}] ms" if ts else
                                "not measured"))
    return "; ".join(out)


# the routed runs of B9's group: (label, fixture, rank space, gathered)
B9_RUNS = [("trans5", "trans5", False, False),
           ("ford2", "ford2", False, False),
           ("language rank", "language", True, False),
           ("analytics gathered", cs.GATHERED_FIXTURE, False, True)]


def routed_handle(name, rank, gathered):
    """A routed handle of suite stand-in ``name`` (scale 1.0, seed 0); with
    ``gathered``, planned as ``chip_smoke.py``'s phase 3g plans it
    (``gathered_prepare``), so that it diverts tiles to the side-plan.
    Planned once a run."""
    key = ("routed", name, rank, gathered)
    if key in _HANDLES:
        return _HANDLES[key]
    coo = suite_matrix(name, 1.0, seed=cs.SEED)
    if gathered:
        h = cs.gathered_prepare(coo)[0]
    else:
        h = prepare(coo, SpmvConfig(rank_sort=rank), "routed")
    _HANDLES[key] = h
    return h


def b9_part(h, xd):
    """(x2d, [(packed, dims)], call) of a routed handle's B9 work on x
    ``xd``, as its ``run`` makes x2d: ``call`` is one launch over every
    stream where the checkout's handle has a stream table, else one launch
    a stream with the y tiles summed (the parent's executor)."""
    meta, d = h._routed_meta, h._d
    x = h._pad_x(xd)
    if meta["xperm"] is not None:
        x = panel_permute_apply_from(d, meta["xperm"], "xp", x)
    x = torch.nn.functional.pad(x, (0, max(meta["nwin"] * 1024
                                           - x.shape[0], 0)))
    x2d, nyt = x.reshape(-1, 128), meta["nyt"]
    streams = [(tuple(d[f"s{i}_" + n] for n in sr.stream_array_names(
        dims[4])) + (d[f"s{i}_base"], d[f"s{i}_byt"]), dims)
        for i, dims in enumerate(meta["streams"])]
    if meta.get("table") is not None:
        table = meta["table"]
        return x2d, streams, lambda: sr.spmv_routed_streams(table, x2d)

    def call():
        y = None
        for packed, dims in streams:
            ys = sr.spmv_routed_stream(packed, dims, x2d, nyt)
            y = ys if y is None else y + ys
        return y
    return x2d, streams, call


def b9_bounds(h, x2d):
    """(must-read ms, packed ms): B9's bytes over 3.35 TB/s on the whole
    part, x and y once; must-read counts each tile's live bl / bs rows
    (the plan's lt) and lt, packed every row."""
    nyt = h._routed_meta["nyt"]
    must = packed = x2d.nbytes + nyt * 4096
    for s in h.plan.streams:
        T, lmax = s.num_tiles, s.lmax
        fixed = T * (3 * 4096 + 4 + 4 * lmax)
        lt = s.lt.astype(np.int64)
        live = ((lt > 0) if lmax == 1 else (lt + 1) // 2 + (lt + 3) // 4)
        rows = 1 if lmax == 1 else -(-lmax // 2) + -(-lmax // 4)
        must += fixed + 4 * T + int(live.sum()) * 4096
        packed += fixed + T * rows * 4096
    return 1e3 * must / cs.HBM_BYTES_PER_S, 1e3 * packed / cs.HBM_BYTES_PER_S


def kernel_ms(fn, key="routed_tile_kernel", runs=cs.TIMED_RUNS):
    """Device time per call of the kernels whose name holds ``key``
    (torch.profiler, over ``runs`` calls), or None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if key in e.key)
    return us / runs / 1e3 if us > 0 else None


def b9_report(label, rng):
    """B9's lines: each stream of trans5 and ford2 alone, the whole routed
    part of every B9_RUNS handle (launches a call, device busy, B9's own
    device time, bounds, agreement with the plain sum, cuSPARSE on the
    nonzeros the part covers where the checkout's chip_smoke.py builds
    it), the handles' ``run`` and language's rank-space ``linear`` at B
    64, wall and device busy.  Returns False when a case disagrees."""
    ok = True
    b9 = cs.KERNELS["spmv_routed"]["wrapper"]
    csr = getattr(cs, "routed_csr_call", None)
    for tag, name, rank, gathered in B9_RUNS:
        h = routed_handle(name, rank, gathered)
        R, C = h.shape
        xd = torch.from_numpy(rng.standard_normal(C).astype(np.float32)).cuda()
        y_in = torch.from_numpy(rng.standard_normal(R).astype(
            np.float32)).cuda()
        x2d, streams, call = b9_part(h, xd)
        nyt = h._routed_meta["nyt"]
        if tag in ("trans5", "ford2"):
            for i, (packed, dims) in enumerate(streams):
                args = (packed, dims, x2d, nyt)
                agree, _, line = cs._agree(
                    "spmv_routed", sr.spmv_routed_stream(*args),
                    sr.spmv_routed_stream_plain(*args))
                ok &= agree
                bound, _ = cs.kernel_bound("spmv_routed", args, {},
                                           sr.spmv_routed_stream_plain(*args))
                print(f"{label} B9 stream [{tag} s{i}: {dims[0]} tiles, W "
                      f"{dims[2]}, l1 {dims[3]}, lmax {dims[4]}]: device busy "
                      f"{cs._ms(cs.device_ms(lambda a=args: sr.spmv_routed_stream(*a)))}"
                      f", B9 {cs._ms(kernel_ms(lambda a=args: sr.spmv_routed_stream(*a)))}"
                      f", bound {bound:.4f} ms, {line}, "
                      f"{'ok' if agree else 'FAIL'}", flush=True)
        want = None
        for packed, dims in streams:
            yp = sr.spmv_routed_stream_plain(packed, dims, x2d, nyt)
            want = yp if want is None else want + yp
        before = b9.launches
        y = call()
        torch.cuda.synchronize()
        n = b9.launches - before
        agree, _, line = cs._agree("spmv_routed", y, want)
        ok &= agree
        must, packed_ms = b9_bounds(h, x2d)
        msg = (f"{label} B9 part [{tag}: {len(streams)} streams, "
               f"{sum(d[0] for _, d in streams)} tiles, lmax "
               f"{[d[4] for _, d in streams]}]: {n} launches a call, device "
               f"busy {cs._ms(cs.device_ms(call))}, B9 "
               f"{cs._ms(kernel_ms(call))}, must-read bound {must:.4f} ms, "
               f"packed bound {packed_ms:.4f} ms, {line}, "
               f"{'ok' if agree else 'FAIL'}")
        if csr is not None and h._routed_meta.get("table") is not None:
            lib = csr(h._routed_meta["table"], x2d)
            lib_ok, _, _ = cs._agree("spmv_routed", lib().reshape(y.shape),
                                     want)
            ok &= lib_ok
            msg += (f"; CSR of its nonzeros wall {cs.median_ms(lib):.4f} ms, "
                    f"device busy {cs._ms(cs.device_ms(lib))}"
                    f"{'' if lib_ok else ' (FAIL: another function)'}")
        run = lambda h=h, x=xd, y=y_in: h.run(x, y, 1.5, -0.5)  # noqa: E731
        msg += (f"; handle run wall {cs.median_ms(run):.4f} ms, device busy "
                f"{cs._ms(cs.device_ms(run))}")
        print(msg, flush=True)
        if rank:
            xb = torch.from_numpy(rng.standard_normal(
                (cs.BATCH, C)).astype(np.float32)).cuda()
            lin = lambda h=h, xb=xb: h.linear(xb)  # noqa: E731
            before = b9.launches
            lin()
            torch.cuda.synchronize()
            n = b9.launches - before
            print(f"{label} routed linear [{tag}, B {cs.BATCH}]: {n} B9 "
                  f"launches a call, wall {cs.median_ms(lin, runs=5, warmup=1):.4f} "
                  f"ms, device busy {cs._ms(cs.device_ms(lin, runs=5))}",
                  flush=True)
    for src in ("spmv_routed.cu", "spmv_gathered.cu"):
        for line in ptxas_registers(src):
            print(f"{label} ptxas {src} {line}", flush=True)
    return ok


FLUSH_BYTES = 128 * 2**20  # a pass this large evicts the card's 50 MB L2
GATHER_TURNS = 2  # kernel, index_select, index_select, kernel per reading
_SCRATCH = []


def flush_l2(how):
    """Pass over FLUSH_BYTES of scratch, so that what a gather reads next
    comes from HBM (a cold L2): ``"write"`` fills it (the L2 is left
    holding dirty lines, which the next kernel's misses write back),
    ``"read"`` sums it (clean lines)."""
    if not _SCRATCH:
        _SCRATCH.append(torch.ones(FLUSH_BYTES // 4, device="cuda"))
    if how == "write":
        _SCRATCH[0].fill_(1.0)
    else:
        _SCRATCH[0].sum()


_FLUSH_KEYS = {}


def _flush_keys(how):
    """The profiler's keys of :func:`flush_l2`'s own device events, taken
    once a run (again while a window records none)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        if how in _FLUSH_KEYS:
            break
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flush_l2(how)
            torch.cuda.synchronize()
        keys = {e.key for e in prof.key_averages()
                if e.self_device_time_total > 0}
        if keys:
            _FLUSH_KEYS[how] = keys
    return _FLUSH_KEYS[how]


def own_events(fn, cold=None, runs=cs.TIMED_RUNS, tries=3):
    """Device time per call of ``fn`` by the profiler's key, in us
    (torch.profiler over ``runs`` calls, every kernel, copy and fill it
    runs); with ``cold`` ("write" or "read"), :func:`flush_l2` runs
    before each call and its events are left out.  A window without
    device time, or (cold) without the flush's events, is taken again, up
    to ``tries`` windows, then None."""
    from torch.profiler import ProfilerActivity, profile

    skip = _flush_keys(cold) if cold else set()
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                if cold:
                    flush_l2(cold)
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if skip and not skip <= {e.key for e in events}:
            continue  # the flush went unrecorded: its time is unknown
        got = {e.key: e.self_device_time_total / runs for e in events
               if e.key not in skip and e.self_device_time_total > 0}
        if got:
            return got
    return None


def own_ms(fn, cold=None, runs=cs.TIMED_RUNS, tries=3):
    """Device time per call of ``fn`` (:func:`own_events` summed), ms, or
    None."""
    got = own_events(fn, cold, runs, tries)
    return None if got is None else sum(got.values()) / 1e3


COLD = (None, "write", "read")  # warm, cold after a write, after a read


def _turns(kern, lib, names=("kernel", "index_select"), key=None):
    """Device times of ``kern`` and ``lib``, warm and cold after a write
    and after a read of scratch, taken in turns (kernel, library,
    library, kernel), GATHER_TURNS times; with ``key``, also the time of
    ``kern``'s events whose name holds it, from the same windows; then
    each one's wall (median of CUDA events): a text."""
    fns = dict(zip(names, (kern, lib)))
    got = {(n, c): [] for n in names for c in COLD}
    if key:
        got.update({(f"{names[0]} {key} alone", c): [] for c in COLD})
    for _ in range(GATHER_TURNS):
        for n in (names[0], names[1], names[1], names[0]):
            for cold in COLD:
                ev = own_events(fns[n], cold)
                got[n, cold].append(
                    None if ev is None else sum(ev.values()) / 1e3)
                if key and n == names[0]:
                    us = sum(v for k, v in (ev or {}).items() if key in k)
                    got[f"{n} {key} alone", cold].append(
                        us / 1e3 if us > 0 else None)
    out = [f"{n} {'warm' if cold is None else 'cold ' + cold} "
           + " / ".join("-" if t is None else f"{t:.4f}" for t in ts) + " ms"
           for (n, cold), ts in got.items()]
    out += [f"{n} wall {cs.median_ms(fn):.4f} ms" for n, fn in fns.items()]
    return "; ".join(out)


def gather_line(label, tag, name, args, shape):
    """One B11 or B12 case: equality with the plain version, the bound,
    the launch shape and the device times in turns with ``index_select``
    on the same composed indices.  Returns whether the kernel agreed."""
    kern = cs.KERNELS[name]["wrapper"]
    y = kern(*args)
    agree, _, line = cs._agree(name, y, cs.PLAIN[name](*args))
    lib = cs.library_call(name, args)
    lib_ok = torch.equal(lib().reshape(y.shape), y)
    bound, by = cs.kernel_bound(name, args, {}, y)
    # as phase 4 reads them: wall, then device busy, the kernel first
    phase4 = []
    for fn in (lambda: kern(*args), lib):
        cs.median_ms(fn)
        phase4.append(cs._ms(cs.device_ms(fn)))
    print(f"{label} {tag} [{shape}]: {line}, "
          f"{'equal' if agree else 'FAIL'}, index_select "
          f"{'equal' if lib_ok else 'DIFFERENT'}; bound {bound:.4f} ms "
          f"({by}); as phase 4: kernel {phase4[0]}, index_select "
          f"{phase4[1]}; {_turns(lambda: kern(*args), lib)}", flush=True)
    return agree and lib_ok


def gathered_handle(rng):
    """Analytics' routed handle with its gathered side-plan, x and y_in."""
    h = routed_handle(cs.GATHERED_FIXTURE, False, True)
    R, C = h.shape
    xd = torch.from_numpy(rng.standard_normal(C).astype(np.float32)).cuda()
    y_in = torch.from_numpy(rng.standard_normal(R).astype(np.float32)).cuda()
    return h, xd, y_in


def gathered_stage_args(h, xd):
    """(arrays, dims, a) of the two B11 stages of analytics' gathered x
    gather, as ``gathered_gather_apply`` hands them over (its
    ``permute_stage`` wrapped for one call)."""
    sg = importlib.import_module("hispmv_tpu_torch.ops.spmv_gathered")
    seen, real = [], sg.permute_stage

    def spy(arrays, dims, a):
        seen.append((arrays, dims, a))
        return real(arrays, dims, a)

    sg.permute_stage = spy
    try:
        sg.gathered_gather_apply(h._d, h._routed_meta["gathered"], "g_",
                                 cs._gathered_x(h, xd).reshape(-1, 128))
    finally:
        sg.permute_stage = real
    return seen


def _handle_lines(label, tag, h, xd, y_in, chain=None):
    """The handle's ``run`` (and the gathered chain alone): wall and
    device busy."""
    run = lambda: h.run(xd, y_in, 1.5, -0.5)  # noqa: E731
    calls = [("run", run)] + ([("chain", chain)] if chain else [])
    for what, fn in calls:
        print(f"{label} {tag} {what}: wall {cs.median_ms(fn):.4f} ms, device "
              f"busy {cs._ms(cs.device_ms(fn))}", flush=True)


def b12_report(label, rng):
    """B12 on analytics' side-plan (P 8 x K 512), then the gathered chain
    alone and the handle's ``run`` and B12's registers."""
    sg = importlib.import_module("hispmv_tpu_torch.ops.spmv_gathered")
    h, xd, y_in = gathered_handle(rng)
    d, gm, nyt = h._d, h._routed_meta["gathered"], h._routed_meta["nyt"]
    x2d = cs._gathered_x(h, xd).reshape(-1, 128)
    P, K = gm["P"], gm["K"]
    shape = f"P {P} x K {K} windows"
    if hasattr(sg, "s1_gather_grid"):
        w, rows, ctas = sg.s1_gather_grid(P, K)
        shape += f", {w} warps a CTA, {rows} rows, {ctas} CTAs"
    else:
        shape += f", {P * K} CTAs of 1024 threads"
    ok = gather_line(label, "B12", "s1_gather", (d["g_s1"], x2d, P, K), shape)

    def chain():
        xg = sg.gathered_gather_apply(d, gm, "g_", x2d)
        return sg.spmv_gathered_tiles(d["g_vals"], d["g_word"], d["g_byt"],
                                      xg, nyt, gm["nch"], gm["tchunk"])

    _handle_lines(label, "analytics gathered", h, xd, y_in, chain)
    for line in ptxas_registers("spmv_gathered.cu"):
        print(f"{label} ptxas spmv_gathered.cu {line}", flush=True)
    return ok


def b13_report(label, rng):
    """B13 on analytics' side-plan (2,077 tiles): agreement with the plain
    version and with CSR over the tile slots, the byte bound, the launch
    shape, device times warm and cold in turns with CSR (the wrapper's,
    its y fill included, and the kernel's alone); then the gathered chain
    alone and the handle's ``run``, and the registers of
    ``spmv_gathered.cu`` and ``spmv_routed.cu``."""
    sg = importlib.import_module("hispmv_tpu_torch.ops.spmv_gathered")
    h, xd, y_in = gathered_handle(rng)
    d, gm, nyt = h._d, h._routed_meta["gathered"], h._routed_meta["nyt"]
    x2d = cs._gathered_x(h, xd).reshape(-1, 128)
    xg = sg.gathered_gather_apply(d, gm, "g_", x2d)
    args = (d["g_vals"], d["g_word"], d["g_byt"], xg, nyt, gm["nch"],
            gm["tchunk"])
    Tp = gm["nch"] * gm["tchunk"]
    shape = f"{gm['T']} tiles, {nyt} y tiles"
    if hasattr(sg, "spmv_gathered_grid"):
        threads, ctas, resident = sg.spmv_gathered_grid(Tp)
        shape += (f", {threads} threads a CTA, {ctas} CTAs, {resident} "
                  "resident an SM")
    else:
        shape += f", {Tp} CTAs of 1024 threads"
    kern = lambda: sg.spmv_gathered_tiles(*args)  # noqa: E731
    y = kern()
    agree, _, line = cs._agree("spmv_gathered", y, cs.PLAIN["spmv_gathered"](
        *args))
    lib = cs.library_call("spmv_gathered", args)
    lib_ok, _, _ = cs._agree("spmv_gathered", lib().reshape(y.shape), y)
    bound, by = cs.kernel_bound("spmv_gathered", args, {}, y)
    phase4 = []
    for fn in (kern, lib):
        cs.median_ms(fn)
        phase4.append(cs._ms(cs.device_ms(fn)))
    ok = agree and lib_ok
    print(f"{label} B13 [{shape}]: {line}, {'ok' if agree else 'FAIL'}, "
          f"CSR {'agrees' if lib_ok else 'DISAGREES'}; bound {bound:.4f} ms "
          f"({by}); as phase 4: kernel {phase4[0]}, CSR {phase4[1]}; "
          f"{_turns(kern, lib, ('B13', 'CSR'), 'gathered_tile_kernel')}",
          flush=True)

    def chain():
        g = sg.gathered_gather_apply(d, gm, "g_", x2d)
        return sg.spmv_gathered_tiles(d["g_vals"], d["g_word"], d["g_byt"],
                                      g, nyt, gm["nch"], gm["tchunk"])

    _handle_lines(label, "analytics gathered", h, xd, y_in, chain)
    for src in ("spmv_gathered.cu", "spmv_routed.cu"):
        for line in ptxas_registers(src):
            print(f"{label} ptxas {src} {line}", flush=True)
    return ok


def permute_variant(windows):
    """``csrc/permute.cu`` built alone at HISPMV_PERMUTE_WINDOWS =
    ``windows`` into a temporary library: its stage call on (route, a,
    nwin), or None where the source has no such parameter."""
    import ctypes

    src = os.path.join(cuda_build.CSRC_DIR, "permute.cu")
    with open(src) as f:
        if "HISPMV_PERMUTE_WINDOWS" not in f.read():
            return None
    lib = cuda_build.build_alone(
        "permute.cu", {"HISPMV_PERMUTE_WINDOWS": windows},
        os.path.join(tempfile.mkdtemp(), "libpermute.so"))
    ptr = ctypes.c_void_p
    lib.hispmv_permute_stage.restype = ctypes.c_int
    lib.hispmv_permute_stage.argtypes = [ptr, ptr, ptr, ctypes.c_int, ptr]

    def call(route, a, nwin):
        out = torch.empty_like(a)
        rc = lib.hispmv_permute_stage(
            route.data_ptr(), a.data_ptr(), out.data_ptr(), nwin,
            torch.cuda.current_stream().cuda_stream)
        cuda_build.check(rc, "permute_stage variant")
        return out
    return call


def b11_report(label, rng):
    """B11 on language's rank-space x S1-S3 (random values, as phase 4)
    and on the gathered chain's S2 and S3, each also at two windows a
    CTA where the source takes that parameter; then language's rank-space
    ``run`` and ``linear`` at B 64 (5 calls), and B11's registers."""
    pm = importlib.import_module("hispmv_tpu_torch.ops.permute")
    lang = routed_handle("language", True, False)
    xmeta = lang._routed_meta["xperm"][0]
    cases = []
    for si, dims in enumerate(xmeta["dims"]):
        a = torch.from_numpy(rng.standard_normal(
            (dims[0] * dims[1] * 8, 128)).astype(np.float32)).cuda()
        cases.append((f"language x S{si + 1}",
                      ((lang._d[f"xp0_a{si}_0"],), dims, a)))
    gh, gx, _ = gathered_handle(rng)
    for si, args in zip((2, 3), gathered_stage_args(gh, gx)):
        cases.append((f"gathered S{si}", args))
    variant = permute_variant(2)
    ok = True
    for tag, (arrays, dims, a) in cases:
        nwin = dims[0] * dims[1]
        shape = f"{nwin} windows"
        if hasattr(pm, "permute_stage_grid"):
            w, threads, ctas = pm.permute_stage_grid(nwin)
            shape += f", {w} a CTA of {threads} threads, {ctas} CTAs"
        else:
            shape += f", {nwin} CTAs of 1024 threads"
        ok &= gather_line(label, f"B11 {tag}", "permute_stage",
                          (arrays, dims, a), shape)
        if variant is not None:
            want = pm.permute_stage(arrays, dims, a)
            got = variant(arrays[0], a, nwin)
            same = torch.equal(got, want)
            ok &= same
            print(f"{label} B11 {tag} at 2 windows a CTA ({-(-nwin // 2)} "
                  f"CTAs of 512 threads): {'equal' if same else 'FAIL'}; "
                  + _turns(lambda: variant(arrays[0], a, nwin),
                           lambda: pm.permute_stage(arrays, dims, a),
                           ("2 a CTA", "built")), flush=True)
    R, C = lang.shape
    xd = torch.from_numpy(rng.standard_normal(C).astype(np.float32)).cuda()
    y_in = torch.from_numpy(rng.standard_normal(R).astype(np.float32)).cuda()
    _handle_lines(label, "language rank", lang, xd, y_in)
    xb = torch.from_numpy(rng.standard_normal(
        (cs.BATCH, C)).astype(np.float32)).cuda()
    lin = lambda: lang.linear(xb)  # noqa: E731
    print(f"{label} language rank linear [B {cs.BATCH}]: wall "
          f"{cs.median_ms(lin, runs=5, warmup=1):.4f} ms, device busy "
          f"{cs._ms(cs.device_ms(lin, runs=5))}", flush=True)
    for line in ptxas_registers("permute.cu"):
        print(f"{label} ptxas permute.cu {line}", flush=True)
    return ok


def _dist_readings(label, tag, calls):
    """Each call's median wall (CUDA events), host time a call and, last,
    device busy time, the calls in turns (first, second, second, first
    for a pair); prints one line a call."""
    order = list(calls) + list(calls)[::-1]
    got = {k: [] for k in calls}
    for k in order:
        got[k].append((cs.median_ms(calls[k]), cs.host_us(calls[k])))
    for k, fn in calls.items():
        walls = ", ".join(f"{w:.4f}" for w, _ in got[k])
        hosts = ", ".join(f"{h:.1f}" for _, h in got[k])
        print(f"{label} dist {tag} {k}: wall {walls} ms, host {hosts} us a "
              f"call, device busy {cs._ms(cs.device_ms(fn))}", flush=True)


def dist_report(label, rng):
    """The process mesh at D 1 (one NCCL rank, this process) beside the
    one-process executor on ["cuda:0"], on phase 3j's runs, in turns; one
    ``all_gather_into_tensor`` and one ``copy_`` at the size of TSOPF's x;
    then the same again while a second, idle process holds a context on
    the card (as the smoke's own process does while its rank runs), and
    the process mesh's host time once more after the profiler has run in
    this process.  Holds every y to the one-process y.  With two or more
    cards, then ``chip_smoke.py``'s phase 3j: one NCCL rank a card (up to
    four), each a process, beside the one-process executor on the same
    cards."""
    import torch.distributed as dist

    from hispmv_tpu_torch.dist import init_distributed, make_process_mesh

    tmp = tempfile.mkdtemp()
    init_distributed(f"file://{tmp}/store", 1, 0, backend="nccl")
    pm, one = make_process_mesh("cuda:0"), make_mesh(devices=["cuda:0"])
    fixtures = {n: suite_matrix(n, 1.0, seed=cs.SEED)
                for n in sorted({r[1] for r in cs.PROCESS_RUNS})}
    xs = cs.process_xs(fixtures)
    calls, ok = {}, True
    for label_run, name, kind, x_mode in cs.PROCESS_RUNS:
        build, run, kernel, _ = cs.SHARD_KINDS[kind]
        plan = build(fixtures[name], 1)
        xd = torch.from_numpy(xs[name]).cuda()
        pair = {"process mesh": (lambda p=plan, r=run, x=xd, m=x_mode:
                                 r(p, x, pm, x_mode=m)),
                "one-process": (lambda p=plan, r=run, x=xd, m=x_mode:
                                r(p, x, one, x_mode=m))}
        ok &= cs._agree(kernel, pair["process mesh"](),
                        pair["one-process"]())[0]
        calls[label_run] = pair
    n = -(-fixtures["TSOPF_RS_b2383"].num_cols // 128) * 128
    src, dst = torch.zeros(n, device="cuda"), torch.empty(n, device="cuda")
    calls[f"{n} floats"] = {
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(dst,
                                                                     src),
        "copy_": lambda: dst.copy_(src)}
    for tag, pair in calls.items():
        _dist_readings(label, f"{tag}, alone on the card", pair)
    other = subprocess.Popen(
        [sys.executable, "-c", "import sys, time, torch; "
         "torch.zeros(1, device='cuda'); print('up', flush=True); "
         "time.sleep(3600)"], stdout=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        other.stdout.readline()
        for tag, pair in calls.items():
            _dist_readings(label, f"{tag}, a second context on the card",
                           pair)
    finally:
        other.kill()
        other.wait()
    for tag, pair in calls.items():
        fn = pair.get("process mesh", pair.get("all_gather_into_tensor"))
        print(f"{label} dist {tag}, after the profiler: host "
              f"{cs.host_us(fn):.1f} us a call", flush=True)
    dist.destroy_process_group()
    shutil.rmtree(tmp, ignore_errors=True)
    if torch.cuda.device_count() >= 2:  # phase 3j: a rank a card, NCCL
        failures = []
        cs.process_mesh_path(fixtures, cs.gpu_line(),
                             {n: 0 for n in cs.KERNELS}, failures)
        for f in failures:
            print(f"{label} dist FAIL {f}", flush=True)
        ok &= not failures
    return ok


# ---------------------------------------------------------------------------
# calibrate: the H100 profile's values, measured on the card
# ---------------------------------------------------------------------------
#
# Two clocks.  A per-unit cost (a block, a byte, a tile, a window) is the
# slope of a least-squares fit of DEVICE time (torch.profiler, every
# kernel, copy and fill of the call: chip_smoke.device_ms) on the units'
# counts, non-negative, each reading weighted by its inverse; B9's tiles
# and the gathered chain are fitted over synthetic inputs built to vary
# each term apart, so that no two columns of a fit move together, each
# reading the median of three profiler windows.
# hbm_gbps is the fastest streaming read measured (the 512 MiB sum, B1
# and B7 at bh 64, the dense GEMV), each efficiency a rate's share of it.
# A per-call cost (a launch, a fixed cost) is taken against the clock
# the measured tune compares with, utils/timing (CUDA events around each
# call, host gaps included; bench_spmv where a handle runs): the median,
# over the readings, of the wall time less the fitted device work.  On the card a
# call is mostly host time (PERF.md section 5), which the device clock
# cannot see and which would drown a per-unit slope on the wall clock.
# Sizes: CAL_SIZES, or CAL_SMALL for a CPU rehearsal of the flow
# (calibrate(device="cpu", sizes=CAL_SMALL); the CPU has no device clock,
# so its readings are wall times twice).

CAL_SIZES = {
    "hbm_floats": 2**27,  # a 512 MiB read
    # (block_h, row blocks, blocks a row block): B1 on synthetic streams
    "block": [(1, 250_000, k) for k in (1, 2, 4, 8)]
    + [(8, 31_250, k) for k in (1, 4, 16)]
    + [(64, 3_907, k) for k in (1, 4, 8)],
    "block_ncb": 1024,
    # (block_h, rows): B7 on blocked_coo(rows, rows, 30*rows), past L2
    "window": [(bh, r) for bh in (8, 64) for r in (150_000, 450_000, 900_000)],
    "dense": (8192, 12288, 16384),  # 256 MiB and up: past L2
    "stream": (50_000, 200_000, 800_000),
    "ellx_ks": (1, 2, 4, 8, 16, 32),
    "ellx_synth": [(500_000, 4), (250_000, 16)],  # (row blocks, k), bh 1
    "row_gather": (1 << 20, 1 << 22, 1 << 24),
    "routed": ["trans5", "ford2", "analytics", "crystk03", "TSOPF_RS_b2383",
               "language", "poli_large"],
    "routed_strips": (0, 32),
    # B9's synthetic streams: (rows, nonzeros a row, strip windows, l1
    # cap, lmax cap) on random_coo, so that W, l1 and lmax vary apart
    "routed_synth": [(131_072, f, sw, l1, lc)
                     for f, sws in ((4, (8, 32)), (16, (2, 8)))
                     for sw in sws for l1 in (1, 3, 5) for lc in (4, 32)],
    "scatter": (100_000, 1_000_000, 8_000_000),
    "res_ellx": [(r, f) for r in (300_000, 1_200_000) for f in (0.5, 2.0)],
    # (K, nonzeros a row, column span divisor): the divisor packs the
    # columns into fewer windows, more panels for the same tiles
    "gathered": [(k, f, div) for k in (128, 256, 512) for f in (2, 5)
                 for div in (1, 8)],
    "permute": (1 << 17, 1 << 19, 1 << 20),
    "layouts": True,
    "batches": (8, 16, 64),
    "band": "soc-Pokec",
    "suite_scale": 1.0,
}
CAL_SMALL = {
    "hbm_floats": 2**20,
    "block": [(1, 2_000, k) for k in (1, 2, 4)]
    + [(8, 500, k) for k in (1, 4)] + [(64, 60, k) for k in (1, 4)],
    "block_ncb": 64,
    "window": [(bh, r) for bh in (8, 64) for r in (2_000, 6_000)],
    "dense": (256, 512),
    "stream": (2_000, 8_000),
    "ellx_ks": (1, 2, 4),
    "ellx_synth": [(4_000, 2), (2_000, 4)],
    "row_gather": (1 << 12, 1 << 14),
    "routed": ["trans5", "analytics"],
    "routed_strips": (0,),
    "routed_synth": [(16_384, 4, sw, l1, 32) for sw in (8, 32)
                     for l1 in (1, 5)],
    "scatter": (1_000, 10_000),
    "res_ellx": [(r, f) for r in (3_000, 12_000) for f in (0.5, 2.0)],
    "gathered": [(k, f, div) for k in (4, 8) for f in (2, 5)
                 for div in (1, 2)],
    "permute": (1 << 12, 1 << 14),
    "layouts": False,
    "batches": (8, 64),
    "band": None,
    "suite_scale": 0.02,
}


def _nnls_fit(X, t, relative=True):
    """Non-negative least squares of ``t`` on the columns of ``X``, each
    row weighted by 1/t (``relative``) or not; returns the
    coefficients."""
    from scipy.optimize import nnls

    X = np.asarray(X, np.float64)
    t = np.asarray(t, np.float64)
    w = 1.0 / t if relative else np.ones_like(t)
    coef, _ = nnls(X * w[:, None], t * w)
    return coef


def _fixed(wall, work):
    """The per-call cost on the wall clock: median of wall - work."""
    return float(np.median(np.asarray(wall) - np.asarray(work)))


class _Cal:
    """Readings and fitted values of one calibration run."""

    def __init__(self, device, sizes):
        self.dev = torch.device(device)
        self.sizes = sizes
        self.rng = np.random.default_rng(cs.SEED)
        self.raw = {}
        self.val = {}
        self.rate = {}  # streaming rates, bytes a second

    def log(self, msg):
        print(f"calibrate {msg}", flush=True)

    def both(self, fn, windows=1):
        """(wall seconds, device seconds) of one call of ``fn``; the
        device time the median of ``windows`` profiler windows that saw
        device time, out of ``windows + 2`` at most (a window can miss
        most or all of a short kernel's time)."""
        wall = cs.median_ms(fn, device=self.dev) * 1e-3
        if self.dev.type != "cuda":
            return wall, wall
        busy = []
        for _ in range(windows + 2):
            b = cs.device_ms(fn)
            busy += [] if b is None else [b]
            if len(busy) == windows:
                break
        if not busy:
            raise SystemExit("calibrate: the profiler saw no device time")
        return wall, float(np.median(busy)) * 1e-3

    def run(self, h):
        """(wall, device) seconds of the handle's ``run`` as bench_spmv
        times it: x padded once, the product alone."""
        x = torch.from_numpy(self.rng.standard_normal(h.shape[1]).astype(
            np.float32)).to(self.dev)
        xp = h._pad_x(x)
        return self.both(lambda: h._matvec(xp))

    def x(self, n):
        return torch.from_numpy(
            self.rng.standard_normal(n).astype(np.float32)).to(self.dev)


def _open_profile():
    """V5E with every layout budget open: chunked, B2."""
    return dataclasses.replace(V5E, chunked_budget_bytes=1 << 50,
                               batched_budget_bytes=1 << 50)


def _block_plan(bh, nrb, k, ncb, rng):
    """A synthetic block plan: ``nrb`` row blocks of ``k`` distinct col
    blocks each (spread over ``ncb``), every payload slot 0.5."""
    start = rng.integers(0, ncb, nrb)
    step = max(ncb // k, 1)
    cols = (start[:, None] + np.arange(k)[None, :] * step) % ncb
    cols.sort(axis=1)
    nb = nrb * k
    firsts = np.zeros(nb, np.int32)
    firsts[::k] = 1
    lasts = np.zeros(nb, np.int32)
    lasts[k - 1::k] = 1
    return BlockPlan(
        shape=(nrb * bh, ncb * 128), nnz=nb * bh * 128, block_h=bh,
        data=np.full((nb, bh, 128), 0.5, np.float32),
        block_rows=np.repeat(np.arange(nrb, dtype=np.int32), k),
        block_cols=cols.reshape(-1).astype(np.int32),
        block_firsts=firsts, block_lasts=lasts,
        num_row_blocks=nrb, num_col_blocks=ncb)


def _slope_fit(pts):
    """pts (count, wall, device): the device slope a unit."""
    n, _, dev = np.array(pts, np.float64).T
    return _nnls_fit(np.stack([np.ones_like(n), n], 1), dev)[1]


def cal_hbm_and_blocks(c):
    """The 512 MiB read's rate; B1's device slope a block at bh 1, 8 and
    64: block_step_overhead_s (bh 1) and the streaming rate at bh 64."""
    a = torch.rand(c.sizes["hbm_floats"], device=c.dev)
    wall, dev = c.both(lambda: a.sum())
    c.rate["sum"] = a.numel() * 4 / dev
    c.raw["hbm_read_s"] = [wall, dev]
    del a
    c.log(f"hbm: {c.sizes['hbm_floats'] * 4 / 2**20:.0f} MiB read in "
          f"{dev * 1e3:.4f} ms of device time: {c.rate['sum'] / 1e9:.1f} "
          "GB/s")
    per_bh = {}
    for bh, nrb, k in c.sizes["block"]:
        plan = _block_plan(bh, nrb, k, c.sizes["block_ncb"], c.rng)
        h = SpmvHandle.from_plan(plan, device=c.dev, profile=_open_profile())
        assert h._chunked
        wall, dev = c.run(h)
        per_bh.setdefault(bh, []).append((plan.num_blocks, wall, dev))
        c.log(f"B1 bh {bh}: {plan.num_blocks} blocks, wall "
              f"{wall * 1e6:.2f} us, device {dev * 1e6:.2f} us")
        del h, plan
    c.raw["block"] = {str(k): v for k, v in per_bh.items()}
    s = {bh: _slope_fit(pts) for bh, pts in per_bh.items()}
    for bh in s:
        c.log(f"B1 bh {bh}: {s[bh] * 1e9:.4f} ns a block (device)")
    c.val["block_step_overhead_s"] = s[1]
    c.rate["block"] = 64 * 128 * 4 / s[64]


def cal_windows(c):
    """B7's device slope a block at bh 8 (window_step_extra_s, over
    block_step_overhead_s) and 64 (the streaming rate)."""
    per_bh = {}
    for bh, r in c.sizes["window"]:
        coo = blocked_coo(r, r, 30 * r, seed=cs.SEED, group=8, density=0.3,
                          spread_frac=0.2)
        h = prepare(coo, SpmvConfig(block_h=bh), "window", device=c.dev,
                    profile=V5E)
        nb = h.plan.num_blocks
        wall, dev = c.run(h)
        per_bh.setdefault(bh, []).append((nb, wall, dev))
        c.log(f"B7 bh {bh}: {nb} blocks, wall {wall * 1e6:.2f} us, device "
              f"{dev * 1e6:.2f} us")
        del h, coo
    c.raw["window"] = {str(k): v for k, v in per_bh.items()}
    s = {bh: _slope_fit(pts) for bh, pts in per_bh.items()}
    for bh in s:
        c.log(f"B7 bh {bh}: {s[bh] * 1e9:.4f} ns a block (device)")
    c.val["window_step_extra_s"] = s[8] - c.val["block_step_overhead_s"]
    c.rate["window"] = (64 * 128 + 128) * 4 / s[64]


def cal_dense_stream_gather(c):
    """The streaming rates of the dense handle's GEMV and the stream
    format's run, row_gather_s (index_select of rows): device slopes on
    bytes or rows."""
    pts = []
    for n in c.sizes["dense"]:
        w = c.rng.random((n, n), np.float32)
        h = SpmvHandle(w, device=c.dev)
        pts.append((n * n * 4 + 2 * n * 4, *c.run(h)))
        c.log(f"dense {n}x{n}: wall {pts[-1][1] * 1e6:.2f} us, device "
              f"{pts[-1][2] * 1e6:.2f} us")
        del h, w
    c.raw["dense"] = pts
    c.rate["dense"] = 1.0 / _slope_fit(pts)
    pts = []
    for r in c.sizes["stream"]:
        coo = random_coo(r, r, 10 * r, seed=cs.SEED)
        h = prepare(coo, SpmvConfig(), "stream", device=c.dev, profile=V5E)
        plan = h._stream_plan_meta
        b = plan.num_steps * h.config.num_pes * 8 + 8 * r
        pts.append((b, *c.run(h)))
        c.log(f"stream {r} rows: {b} bytes, wall {pts[-1][1] * 1e6:.2f} us, "
              f"device {pts[-1][2] * 1e6:.2f} us")
        del h
    c.raw["stream"] = pts
    c.rate["stream"] = 1.0 / _slope_fit(pts)
    pts = []
    for n in c.sizes["row_gather"]:
        a = torch.rand((n, 8), device=c.dev)
        idx = torch.from_numpy(
            c.rng.integers(0, n, n).astype(np.int64)).to(c.dev)
        pts.append((n, *c.both(lambda: a.index_select(0, idx))))
        del a, idx
    c.raw["row_gather"] = pts
    c.val["row_gather_s"] = _slope_fit(pts)


def cal_rates(c):
    """hbm_gbps: the fastest streaming read measured (the sum, B1 and B7
    at bh 64, the dense GEMV); each family's efficiency is its rate over
    that.  An efficiency above 1, or a rate a zero slope made infinite,
    fails the calibration on the card (a CPU rehearsal's noisy slopes
    take the sum's rate)."""
    c.raw["rates_gbps"] = {k: v / 1e9 for k, v in c.rate.items()}
    bad = sorted(k for k, v in c.rate.items() if not np.isfinite(v))
    if bad and c.dev.type == "cuda":
        raise SystemExit(f"calibrate: zero slopes, infinite rates: {bad}")
    rate = {k: c.rate["sum"] if k in bad else v for k, v in c.rate.items()}
    hbm = max(v for k, v in rate.items() if k != "stream")
    c.val["hbm_gbps"] = hbm / 1e9
    for field, key in (("block_dma_efficiency", "block"),
                       ("window_dma_efficiency", "window"),
                       ("dense_efficiency", "dense"),
                       ("stream_efficiency", "stream")):
        c.val[field] = rate[key] / hbm
    c.log("streaming rates (GB/s): " + ", ".join(
        f"{k} {v / 1e9:.1f}" for k, v in c.rate.items())
        + f": hbm_gbps {hbm / 1e9:.1f}")
    over = {k: v for k, v in c.val.items()
            if k.endswith("_efficiency") and v > 1.0}
    if over:
        raise SystemExit(f"calibrate: efficiencies above 1: {over}")


def _ellx_handle(c, eplan):
    return SpmvHandle.from_plan(eplan, device=c.dev, profile=V5E)


def cal_ellx(c):
    """The ELLX run on trans5 at k_base 1..32 and on two synthetic plans
    without overflow.  Device time = base bytes / rate + overflow blocks
    * a block (ellx_gbps, ellx_choose_bytes_per_s, overflow_block_s); the
    wall time less that = fixed + [overflow] * its launch
    (overflow_launch_s)."""
    coo = suite_matrix("trans5", c.sizes["suite_scale"], seed=cs.SEED)
    bp = build_block_plan(coo, block_h=1)
    rows = []
    for k in c.sizes["ellx_ks"]:
        ep = build_ellx_plan(bp, k_base=k)
        wall, dev = c.run(_ellx_handle(c, ep))
        rows.append((ep.base_bytes, ep.overflow_blocks, wall, dev))
        c.log(f"ELLX trans5 k {k}: base {ep.base_bytes} B, overflow "
              f"{ep.overflow_blocks} blocks, wall {wall * 1e6:.2f} us, "
              f"device {dev * 1e6:.2f} us")
    for nrb, k in c.sizes["ellx_synth"]:
        ep = build_ellx_plan(_block_plan(1, nrb, k, c.sizes["block_ncb"],
                                         c.rng), k_base=k)
        wall, dev = c.run(_ellx_handle(c, ep))
        rows.append((ep.base_bytes, ep.overflow_blocks, wall, dev))
        c.log(f"ELLX synthetic {nrb} x k {k}: base {ep.base_bytes} B, wall "
              f"{wall * 1e6:.2f} us, device {dev * 1e6:.2f} us")
    c.raw["ellx"] = rows
    base, ov, wall, dev = np.array(rows, np.float64).T
    has = (ov > 0) * 1.0
    _, inv_rate, _, per_block = _nnls_fit(
        np.stack([np.ones_like(base), base, has, ov], 1), dev)
    rate = 1.0 / inv_rate
    rest = wall - base * inv_rate - ov * per_block
    f0, launch = _nnls_fit(np.stack([np.ones_like(base), has], 1), rest)
    c.val["ellx_gbps"] = rate / 1e9
    c.val["ellx_choose_bytes_per_s"] = rate
    c.val["overflow_launch_s"] = launch
    c.val["overflow_block_s"] = per_block
    c.log(f"ELLX fit: {rate / 1e9:.1f} GB/s, {per_block * 1e9:.4f} ns an "
          f"overflow block (device); wall {f0 * 1e6:.2f} us fixed + "
          f"{launch * 1e6:.2f} us with an overflow")
    return coo


def _routed_points(c, label, plan, feats, devs, parts):
    """B9 on each stream of ``plan`` alone (device time, the fit's
    features) and on the whole part in one launch."""
    from hispmv_tpu_torch.api.handle import _stream_packed

    h = SpmvHandle.from_plan(plan, device=c.dev, profile=V5E)
    meta, d = h._routed_meta, h._d
    x2d = c.x(meta["nwin"] * 1024).reshape(-1, 128)
    alone = []
    for i, (s, dims) in enumerate(zip(plan.streams, meta["streams"])):
        packed = _stream_packed(d, "", i, dims)
        _, dev = c.both(lambda: spmv_routed_stream(packed, dims, x2d,
                                                   meta["nyt"]), windows=3)
        T, W, l1, L = s.num_tiles, s.wmax, s.l1, s.lmax
        feats.append([1.0, T, T * (W - 1), T * (l1 - 1), T * W * (l1 - 1),
                      T * L])
        devs.append(dev)
        alone.append(dev)
    wall, dev = c.both(lambda: spmv_routed_streams(meta["table"], x2d),
                       windows=3)
    parts.append((len(alone), alone, wall, dev))
    c.log(f"B9 {label}: "
          f"{[(s.num_tiles, s.wmax, s.l1, s.lmax) for s in plan.streams]}"
          f" alone device {[round(t * 1e6, 2) for t in alone]} us; one "
          f"launch wall {wall * 1e6:.2f} us, device {dev * 1e6:.2f} us")


def cal_routed(c):
    """B9: each stream alone over the routed plans of CAL_SIZES['routed']
    (strip widths auto and 32) and of the synthetic matrices of
    CAL_SIZES['routed_synth'] (strip width, l1 and lmax caps set apart):
    device time = c0 + T*(base + w*(W-1) + (ov + wl*W)*(l1-1) + bnd*lmax),
    each stream weighted by its inverse time.  Each part in one launch
    beside its streams alone gives what a stream costs inside one launch
    (launch_ns).  residual_ns: the element scatter's wall time a nonzero
    at the smallest size (its per-call cost folded in); res_ellx_*: the
    row-granular ELLX residual's device slopes a row and a nonzero."""
    from hispmv_tpu_torch.plan.routed import (
        build_ranked_routed_plan, build_routed_plan)

    feats, devs, parts = [], [], []
    for name in c.sizes["routed"]:
        coo = suite_matrix(name, c.sizes["suite_scale"], seed=cs.SEED)
        for sw in c.sizes["routed_strips"]:
            build = (build_ranked_routed_plan if name == "language"
                     else build_routed_plan)
            plan = build(coo, strip_windows=sw)
            if plan.streams:
                _routed_points(c, f"{name} strips {sw or 'auto'}", plan,
                               feats, devs, parts)
    n_suite = len(devs)
    for R, f, sw, l1, lc in c.sizes["routed_synth"]:
        coo = random_coo(R, R, f * R, seed=cs.SEED)
        plan = build_routed_plan(coo, strip_windows=sw, l1_cap=l1,
                                 l_cap=lc)
        if plan.streams:
            _routed_points(c, f"random {R} x {f} a row, strips {sw}, l1 "
                           f"cap {l1}, lmax cap {lc}", plan, feats, devs,
                           parts)
    c.raw["routed_streams"] = [f + [d] for f, d in zip(feats, devs)]
    c.raw["routed_parts"] = parts
    coef = _nnls_fit(feats, devs)
    c0, base, w, ov, wl, bnd = coef
    for k, v in zip(("tile_base_ns", "tile_w_ns", "tile_ov_ns",
                     "tile_wl_ns", "tile_bnd_ns"), (base, w, ov, wl, bnd)):
        c.val[k] = v * 1e9
    err = np.abs(np.log2(np.asarray(feats) @ coef / np.asarray(devs)))
    c.raw["routed_fit_abs_log2"] = err.tolist()
    # inside one launch a stream adds its tiles and this
    per_stream = [(dev - sum(t - c0 for t in alone)) / n
                  for n, alone, _, dev in parts]
    c.val["launch_ns"] = max(float(np.median(per_stream)), 0.0) * 1e9
    c.log(f"B9 fit (device, {len(devs)} streams, {n_suite} of suite "
          f"plans): {c0 * 1e6:.2f} us a launch; tile {base * 1e9:.3f} + "
          f"{w * 1e9:.4f}*(W-1) + ({ov * 1e9:.4f} + {wl * 1e9:.4f}*W)*"
          f"(l1-1) + {bnd * 1e9:.3f}*lmax ns; a stream inside one launch "
          f"{c.val['launch_ns']:.1f} ns; |log2(fit / time)| median "
          f"{np.median(err):.3f}, 90th {np.quantile(err, 0.9):.3f}, max "
          f"{err.max():.3f} (suite streams median "
          f"{np.median(err[:n_suite]):.3f}, synthetic "
          f"{np.median(err[n_suite:]) if len(err) > n_suite else 0:.3f})")
    # the residual executors
    pts = []
    R = max(c.sizes["scatter"])
    x = c.x(R)
    for n in c.sizes["scatter"]:
        rows = torch.from_numpy(c.rng.integers(0, R, n)).to(c.dev)
        cols = torch.from_numpy(c.rng.integers(0, R, n)).to(c.dev)
        vals = c.x(n)
        y = torch.zeros(R, device=c.dev)
        pts.append((n, *c.both(lambda: y.index_add(
            0, rows, vals * x.index_select(0, cols)))))
    c.raw["scatter"] = pts
    n0, wall0, _ = min(pts)
    c.val["residual_ns"] = wall0 / n0 * 1e9
    c.log(f"scatter residual: {[(n, round(w * 1e6, 2), round(d * 1e6, 2)) for n, w, d in pts]}"
          f" (n, wall us, device us): {c.val['residual_ns']:.4f} ns a "
          f"nonzero at {n0}")
    pts = []
    for r, f in c.sizes["res_ellx"]:
        coo = random_coo(r, r, int(f * r), seed=cs.SEED)
        ep = build_ellx_plan(build_block_plan(coo, block_h=1),
                             max_base_bytes=2 << 30)
        pts.append((r, coo.nnz, *c.run(_ellx_handle(c, ep))))
    c.raw["res_ellx"] = pts
    r, n, wall, dev = np.array(pts, np.float64).T
    _, row, nz = _nnls_fit(np.stack([np.ones_like(r), r, n], 1), dev)
    c.val["res_ellx_row_ns"] = row * 1e9
    c.val["res_ellx_nnz_ns"] = nz * 1e9


def cal_gathered(c):
    """The gathered chain (B12, B11 twice, B13) on scattered short rows at
    three K, the columns spread over all K windows or packed into K/div
    (more panels for the same tiles, so that T and 2*P*K + T vary apart):
    device time = c0 + T*tile + (2*P*K + T)*stage, each reading weighted
    by its inverse; the wall time less T*tile + (2*P*K + T)*stage,
    gath_launch_ns."""
    from hispmv_tpu_torch.ops.spmv_gathered import pack_gathered
    from hispmv_tpu_torch.plan.gathered import build_gathered_plan

    rows_out = []
    for K, f, div in c.sizes["gathered"]:
        n = K * 1024
        nnz = f * n
        r = c.rng.integers(1, n, nnz)
        cc = c.rng.integers(0, n // div, nnz)
        key = np.unique(r.astype(np.int64) * n + cc)
        r, cc = key // n, key % n
        v = c.rng.standard_normal(len(r)).astype(np.float32)
        plan, *_ = build_gathered_plan(r, cc, v, (n, n), K)
        arrays, gm = pack_gathered(plan)
        d = {"g_" + k: torch.from_numpy(a).to(c.dev)
             for k, a in arrays.items()}
        x2d = c.x(K * 1024).reshape(-1, 128)
        nyt = -(-n // 1024)

        def chain():
            xg = gathered_gather_apply(d, gm, "g_", x2d)
            return spmv_gathered_tiles(d["g_vals"], d["g_word"], d["g_byt"],
                                       xg, nyt, gm["nch"], gm["tchunk"])

        wall, dev = c.both(chain, windows=3)
        T, P = plan.num_tiles, plan.num_panels
        rows_out.append((T, 2 * P * K + T, wall, dev))
        c.log(f"gathered K {K}, columns over K/{div}: {T} tiles, P {P}, "
              f"wall {wall * 1e6:.2f} us, device {dev * 1e6:.2f} us")
    c.raw["gathered"] = rows_out
    T, st, wall, dev = np.array(rows_out, np.float64).T
    X = np.stack([np.ones_like(T), T, st], 1)
    coef = _nnls_fit(X, dev)
    _, tile, stage = coef
    c.val["gath_tile_ns"] = tile * 1e9
    c.val["gath_stage_ns"] = stage * 1e9
    c.val["gath_launch_ns"] = _fixed(wall, T * tile + st * stage) * 1e9
    err = np.abs(np.log2(X @ coef / dev))
    c.log(f"gathered fit (device): {coef[0] * 1e6:.2f} us + "
          f"{tile * 1e9:.3f} ns a tile + {stage * 1e9:.3f} ns a stage "
          f"window, |log2(fit / time)| max {err.max():.3f}; "
          f"{c.val['gath_launch_ns'] / 1e3:.2f} us a chain on the wall")


def cal_permute(c):
    """B11 on a random permutation: S1 alone (permute_window_ns, device
    slope a window) and the whole apply (its device slope less two stages
    a window is the two transposes; the wall time less the device work
    the fixed cost)."""
    from hispmv_tpu_torch.ops.permute import pack_permute_plan, permute_apply
    from hispmv_tpu_torch.plan.permute import build_permute_plan

    st, ap = [], []
    for n in c.sizes["permute"]:
        meta = pack_permute_plan(build_permute_plan(c.rng.permutation(n)),
                                 c.dev)
        arrs, dims = meta["arrays"], meta["dims"]
        x = c.x(n)
        W = dims[0][0] * dims[0][1]
        x2 = torch.nn.functional.pad(x, (0, W * 1024 - n)).reshape(-1, 128)
        st.append((W, *c.both(lambda: permute_stage(arrs[0], dims[0], x2))))
        ap.append((W, *c.both(lambda: permute_apply(meta, arrs, x))))
        c.log(f"permute n {n}: W {W}, S1 wall/device {st[-1][1] * 1e6:.2f} / "
              f"{st[-1][2] * 1e6:.2f} us, apply {ap[-1][1] * 1e6:.2f} / "
              f"{ap[-1][2] * 1e6:.2f} us")
    c.raw["permute"] = {"stage": st, "apply": ap}
    W, _, dev = np.array(st).T
    s = _nnls_fit(np.stack([np.ones_like(W), W], 1), dev)[1]
    W, wall, dev = np.array(ap).T
    a, b = _nnls_fit(np.stack([np.ones_like(W), W], 1), dev)
    c.val["permute_window_ns"] = s * 1e9
    # two transposes of W*4 KiB: 2 * 1024 * W * 4 / 1e6 MB
    mb_a_window = 2 * 1024 * 4 / 1e6
    c.val["transpose_ns_per_mb"] = max(b - 2 * s, 0.0) * 1e9 / mb_a_window
    work = (2 * W + 1024) * s + W * max(b - 2 * s, 0.0)
    c.val["permute_fixed_ns"] = max(_fixed(wall, work), 0.0) * 1e9


def _layout_needs(h, plan):
    """(chunked need, paneled need) of the handle's budget rule for
    ``plan`` under ``h.profile``'s panel sizes."""
    xy = (plan.num_col_blocks * 128 + plan.num_row_blocks * plan.block_h) * 4
    ch = 2 * chunk_for(plan.block_h) * plan.block_h * 128 * 4
    pan = (plan.num_row_blocks * plan.block_h * 4
           + h.profile.panel_ncb * 128 * 8 + ch)
    return xy + ch, pan


def _pick_budget(cases, pick, top):
    """The budget among the cases' needs (and 0, and ``top``, the card's
    memory for plans) whose rule ``pick(budget, case)`` gives the least
    total time, each case's time over its best; ties to the larger
    budget."""
    cands = sorted({0, top} | {n for case in cases for n in case[0]
                               if n <= top})
    best = None
    for b in cands:
        cost = sum(case[1][pick(b, case)] / min(case[1].values())
                   for case in cases)
        if best is None or cost <= best[0] + 1e-9:
            best = (cost, b)
    return best[1]


LAYOUT_ROUNDS = 5  # layouts and kernels timed in turns, order reversed


def _turns(c, calls):
    """Median wall seconds of each call of ``calls`` (name -> fn), each
    reading a ``median_ms``, taken in turns over LAYOUT_ROUNDS rounds."""
    names = list(calls)
    got = {n: [] for n in names}
    for r in range(LAYOUT_ROUNDS):
        for n in (names if r % 2 == 0 else names[::-1]):
            got[n].append(cs.median_ms(calls[n], device=c.dev) * 1e-3)
    return {n: float(np.median(v)) for n, v in got.items()}


def cal_layouts(c):
    """B1, B3 and B4 on TSOPF_RS_b2383 and chip_smoke.py's two large
    block matrices; B2 and B6 at each batch on TSOPF_RS_b2383 and the
    Flan-sized matrix, both chunked.  Wall time of a call, the median of
    LAYOUT_ROUNDS readings taken in turns (the host's share of a call
    spreads 2x between readings); device time beside it.  The budgets are
    those whose rule gives the least wall time over these cases."""
    mats = [("TSOPF_RS_b2383", lambda: suite_matrix(
        "TSOPF_RS_b2383", c.sizes["suite_scale"], seed=cs.SEED))]
    if c.sizes["layouts"]:
        for label, R, C, nnz, *_ in cs.LARGE_BLOCK_RUNS:
            mats.append((label, lambda R=R, C=C, nnz=nnz: blocked_coo(
                R, C, nnz, seed=cs.SEED, spread_frac=0.4)))
    lay_cases, b_cases = [], []
    c.raw["layouts"], c.raw["batches"] = {}, {}
    for label, make in mats:
        coo = make()
        plan = build_block_plan(coo, block_h=8)
        probe = SpmvHandle.__new__(SpmvHandle)
        probe.profile = V5E
        needs = _layout_needs(probe, plan)
        xp = c.x(coo.num_cols)
        hs = {}
        for layout in ("chunked", "paneled", "tiled"):
            budget = {"chunked": 1 << 50, "paneled": needs[1], "tiled": 0}
            prof = dataclasses.replace(
                V5E, chunked_budget_bytes=budget[layout],
                batched_budget_bytes=1 << 50)
            h = SpmvHandle.from_plan(plan, device=c.dev, profile=prof)
            if cs._layout(h) == [layout]:
                hs[layout] = (h, h._pad_x(xp))
            else:
                c.log(f"layouts {label}: {layout} not reachable "
                      f"({cs._layout(h)})")
        times = _turns(c, {k: (lambda h=h, x=x: h._matvec(x))
                           for k, (h, x) in hs.items()})
        for k, (h, x) in hs.items():
            dev = c.both(lambda: h._matvec(x))[1]
            c.log(f"layouts {label}: {k} wall {times[k] * 1e3:.4f} ms "
                  f"(median of {LAYOUT_ROUNDS} in turns), device "
                  f"{dev * 1e3:.4f} ms")
        if "chunked" in hs and label != cs.LARGE_BLOCK_RUNS[-1][0]:
            h = hs["chunked"][0]
            for B in c.sizes["batches"]:
                xb = torch.from_numpy(c.rng.standard_normal(
                    (B, coo.num_cols)).astype(np.float32)).to(c.dev)
                profs = {rule: dataclasses.replace(
                    h.profile, batched_budget_bytes=bud)
                    for rule, bud in (("B2", 1 << 50), ("B6", 0))}

                def call(rule, h=h, xb=xb, profs=profs):
                    h.profile = profs[rule]
                    return h.linear(xb)

                bt = _turns(c, {rule: (lambda rule=rule: call(rule))
                                for rule in profs})
                need_b = ((plan.num_col_blocks * 128
                           + plan.num_row_blocks * 8) * B * 4
                          + 2 * h._chunk * 8 * 128 * 4)
                b_cases.append(((need_b,), bt, need_b))
                c.raw["batches"][f"{label} B {B}"] = [need_b, bt]
                c.log(f"linear {label} B {B}: B2 {bt['B2'] * 1e3:.4f} ms, "
                      f"B6 {bt['B6'] * 1e3:.4f} ms (medians in turns)")
                del xb
            h._batch_d = None
        del hs
        lay_cases.append((needs, times))
        c.raw["layouts"][label] = [needs, times]
        del coo, plan

    def layout_of(b, case):
        (need_c, need_p), times = case
        want = ("chunked" if need_c <= b else "paneled" if need_p <= b
                else "tiled")
        return want if want in times else min(times, key=times.get)

    top = c.val["hbm_bytes"]
    c.val["chunked_budget_bytes"] = _pick_budget(lay_cases, layout_of, top)
    c.val["batched_budget_bytes"] = _pick_budget(
        b_cases, lambda b, case: "B2" if case[2] <= b else "B6", top)


def cal_band(c):
    """B9 on the soc-Pokec stand-in in rank space, one plan against the
    banded cell grid (wall and device time of a run each): the banding
    budget is the card's memory for plans when the one plan is faster on
    both clocks, else the JAX package's."""
    name = c.sizes["band"]
    if not name:
        return
    from hispmv_tpu_torch.plan.routed import (
        build_banded_routed_plan, build_ranked_routed_plan)

    coo = suite_matrix(name, 1.0, seed=cs.SEED)
    t = {}
    for kind, build in (("one plan", build_ranked_routed_plan),
                        ("banded", lambda m: build_banded_routed_plan(
                            m, rank_sort=True))):
        t0 = time.perf_counter()
        plan = build(coo)
        plan_s = time.perf_counter() - t0
        h = SpmvHandle.from_plan(plan, device=c.dev, profile=V5E)
        x = c.rng.standard_normal(coo.num_cols).astype(np.float32)
        wall, y = bench_spmv(h, x)
        t[kind] = [wall, c.run(h)[1]]
        err = float(np.abs(y - coo.matvec(x.astype(np.float64))).max())
        c.log(f"band {name}: {kind} planned in {plan_s:.1f} s, wall "
              f"{wall * 1e3:.4f} ms, device {t[kind][1] * 1e3:.4f} ms a "
              f"run, max abs err {err:.3e}")
        del h, plan
    c.raw["band"] = t
    c.val["routed_band_budget_bytes"] = (
        c.val["hbm_bytes"] if t["one plan"][0] <= t["banded"][0]
        and t["one plan"][1] <= t["banded"][1]
        else V5E.routed_band_budget_bytes)


PER_CALL_FORMATS = ("block", "window", "ellx", "routed", "stream", "split",
                    "dense")


def cal_per_call(c):
    """launch_overhead_s: what one call of a handle costs on the wall
    clock beyond its device work, where the device work is too small to
    hide it (a 4096 x 4096 matrix of 20,000 nonzeros): the median over the
    formats of PER_CALL_FORMATS of bench-clock time less device time."""
    coo = random_coo(4096, 4096, 20_000, seed=cs.SEED)
    per = {}
    for fmt in PER_CALL_FORMATS:
        h = SpmvHandle(coo, format=fmt, device=c.dev, profile=V5E)
        wall, dev = c.run(h)
        per[fmt] = (wall, dev)
        del h
    c.raw["per_call"] = per
    c.val["launch_overhead_s"] = float(np.median(
        [w - d for w, d in per.values()]))
    c.log("a call beyond its device work, 4096^2 with 20,000 nonzeros "
          "(wall / device us): " + ", ".join(
              f"{k} {w * 1e6:.2f} / {d * 1e6:.2f}" for k, (w, d) in
              per.items())
          + f": {c.val['launch_overhead_s'] * 1e6:.2f} us")


def cal_body_bytes(c, trans5):
    """split's body_bytes_per_nnz, derived as the JAX package derived its
    own: trans5's ELLX body cost a nonzero (base bytes, plus the overflow's
    time as bytes at the ELLX rate), k_base chosen under the fitted
    costs."""
    from hispmv_tpu_torch.ops.spmv_ellx import choose_k_base

    prof = dataclasses.replace(V5E, **{
        k: c.val[k] for k in ("ellx_choose_bytes_per_s", "overflow_block_s",
                              "overflow_launch_s")})
    bp = build_block_plan(trans5, block_h=1)
    counts = np.bincount(bp.block_rows, minlength=bp.num_row_blocks)
    k = choose_k_base(counts, 1, prof)
    base = bp.num_row_blocks * k * (128 * 4 + 4)
    ov = int(np.maximum(counts - k, 0).sum())
    rate = c.val["ellx_choose_bytes_per_s"]
    c.val["body_bytes_per_nnz"] = (
        base + ov * c.val["overflow_block_s"] * rate) / trans5.nnz
    c.log(f"split: trans5 ELLX k_base {k} under the fit, {ov} overflow "
          f"blocks: {c.val['body_bytes_per_nnz']:.1f} B a body nonzero")


def calibrate(device="cuda", sizes=None, picks=True) -> int:
    """Measure every field of the H100 profile on ``device``; print the
    ``H100 = DeviceProfile(...)`` literal and the card's name and power
    limit, then the picks of chip_smoke.py's phase 3k under V5E and the
    calibrated profile.  Readings and values go to
    chiprun_out/calibrate.json (calibrate_cpu.json for a CPU
    rehearsal)."""
    c = _Cal(device, sizes or CAL_SIZES)
    t0 = time.perf_counter()
    total = (torch.cuda.mem_get_info(c.dev)[1] if c.dev.type == "cuda"
             else 80 * 10**9)
    # read by nothing in the port: the field stays so that the profile's
    # first fields are the JAX tuner's
    c.val["vmem_bytes"] = 0
    # what a resident plan may take: 4/5 of the card, the rest for x, y
    # and the prepare's copies
    c.val["hbm_bytes"] = int(total * 4 // 5)
    cal_hbm_and_blocks(c)
    cal_windows(c)
    cal_dense_stream_gather(c)
    cal_rates(c)
    trans5 = cal_ellx(c)
    cal_body_bytes(c, trans5)
    cal_routed(c)
    cal_gathered(c)
    cal_permute(c)
    cal_layouts(c)
    c.val.setdefault("routed_band_budget_bytes",
                     V5E.routed_band_budget_bytes)
    cal_band(c)
    cal_per_call(c)
    gpu = cs.gpu_line() if c.dev.type == "cuda" else "cpu rehearsal"
    name = "nvidia-h100-80gb-hbm3"
    fields = [f.name for f in dataclasses.fields(DeviceProfile)]
    vals = {k: c.val[k] for k in fields if k in c.val}
    for k in ("panel_ncb", "panel_y_bytes"):
        vals.setdefault(k, getattr(V5E, k))
    missing = [k for k in fields if k != "name" and k not in vals]
    if missing:
        raise SystemExit(f"calibrate: no value for {missing}")
    ints = {f.name for f in dataclasses.fields(DeviceProfile)
            if f.type in ("int", int)}
    vals = {k: int(v) if k in ints else float(f"{v:.4g}")
            for k, v in vals.items()}
    lines = [f"# {gpu}; python3 kernel_compare.py calibrate",
             "H100 = DeviceProfile(", f'    name="{name}",']
    lines += [f"    {k}={vals[k]!r}," for k in fields[1:]]
    lines.append(")")
    print("\n".join(lines), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    out = "calibrate.json" if c.dev.type == "cuda" else "calibrate_cpu.json"
    with open(os.path.join("chiprun_out", out), "w") as f:
        json.dump({"gpu": gpu, "values": vals,
                   "raw": c.raw, "seconds": time.perf_counter() - t0}, f,
                  indent=1, default=float)
    c.log(f"took {time.perf_counter() - t0:.1f} s")
    rc = 0
    if picks:
        prof = DeviceProfile(name=name, **{k: vals[k] for k in fields[1:]})
        failures = []
        cs.profile_picks(cs.profile_fixtures(), [V5E, prof], failures)
        for f in failures:
            print(f"calibrate picks FAIL {f}", flush=True)
        rc = 1 if failures else 0
    print(gpu, flush=True)
    return rc


# the case groups, in the order they run (and draw from the generator)
GROUPS = {"b1b7": b1_b7_cases, "b3": b3_cases, "b2": b2_cases,
          "b8": b8_cases, "b6": b6_cases, "b4": b4_cases}
# groups that print their own lines, last
def _host_us(call, contexts, n=50, batches=21):
    """For each of ``contexts`` (context factories), the median over
    ``batches`` of the host microseconds a ``call``, each call timed alone
    inside the context, the contexts in turns batch by batch, the device
    synchronised between batches."""
    per = [[] for _ in contexts]
    call()
    torch.cuda.synchronize()
    for _ in range(batches):
        for i, context in enumerate(contexts):
            t = 0
            with context():
                for _ in range(n):
                    t0 = time.perf_counter_ns()
                    call()
                    t += time.perf_counter_ns() - t0
            torch.cuda.synchronize()
            per[i].append(t / n / 1e3)
    return [float(np.median(p)) for p in per]


def _off_path_ns(tmod, n=200_000):
    """(ns of a no-op ``span`` with tracing off, ns a ``traced`` wrapper
    adds to a call): each the median of 5 loops of ``n``."""
    def loop(fn):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        return (time.perf_counter_ns() - t0) / n

    def with_span():
        with tmod.span("x"):
            pass

    def bare():
        return None
    wrapped = tmod.traced("x")(bare)
    sp = [loop(with_span) - loop(bare) for _ in range(5)]
    wr = [loop(wrapped) - loop(bare) for _ in range(5)]
    return float(np.median(sp)), float(np.median(wr))


def trace_report(label, rng):
    """The program's tracing on the host: see the module's docstring."""
    from hispmv_tpu_torch.utils import trace as tmod

    tracing = getattr(tmod, "tracing", None)
    if tracing is not None:
        span_ns, wrap_ns = _off_path_ns(tmod)
        print(f"{label} trace off-path: no-op span {span_ns:.1f} ns, traced "
              f"wrapper {wrap_ns:.1f} ns", flush=True)
    for tag, h in (("TSOPF_RS_b2383 block", handle("TSOPF_RS_b2383", 8,
                                                   "block")),
                   ("trans5 routed", routed_handle("trans5", False, False))):
        R, C = h.shape
        x = torch.from_numpy(rng.standard_normal(C).astype(np.float32)).cuda()
        xb = torch.from_numpy(rng.standard_normal((64, C)).astype(
            np.float32)).cuda()
        y_in = torch.from_numpy(rng.standard_normal(R).astype(
            np.float32)).cuda()
        for call, fn in (("run", lambda: h.run(x, y_in=y_in, alpha=0.85,
                                               beta=0.15)),
                         ("linear", lambda: h.linear(xb))):
            if tracing is None:
                off, = _host_us(fn, [contextlib.nullcontext])
                print(f"{label} trace [{tag} {call}]: host {off:.2f} us a "
                      f"call, no tracing in this checkout", flush=True)
                continue
            off, traced_us = _host_us(fn, [contextlib.nullcontext, tracing])
            with tracing() as tr:
                fn()
            spans = len(tr.spans)
            kernels = sum(s.name.startswith("kernel.") for s in tr.spans)
            est = ((spans - kernels) * span_ns + kernels * wrap_ns) / 1e3
            print(f"{label} trace [{tag} {call}]: host {off:.2f} us a call "
                  f"off, {traced_us:.2f} on; {spans} spans a call, "
                  f"{kernels} of them kernels; off-path {est:.3f} us a "
                  f"call", flush=True)
    return True


B10_BATCH = 64
B10_SEED = 1  # the pokec matrix of the benchmark's generator at this seed
B10_SMALL = ("trans5", "ford2")  # chip_smoke.py's routed linear handles
B10_SMALL_BATCHES = (1, 3, 8, 64)


def b10_stream_args(h, xt, adds):
    """(dims, arguments of the checkout's B10 call) for each stream of a
    routed handle on x ``xt`` [nwin*8, 128, B]: with ``adds`` (a kernel
    that adds into the y it is given) chip_smoke.py's ``b10_call`` form,
    else the parent's wrapper form."""
    meta = h._routed_meta
    out = []
    for i, dims in enumerate(meta["streams"]):
        p = f"s{i}_"
        packed = tuple(h._d[p + n] for n in sr.stream_array_names(dims[4]))
        packed += (h._d[p + "base"], h._d[p + "byt"])
        if adds:
            out.append((dims, (packed, dims, xt, meta["nyt"],
                               meta["lts"][i], meta["runs"][i])))
        else:
            out.append((dims, (packed, dims, xt, meta["nyt"])))
    return out


def b10_small_report(label, name, call, adds):
    """B10 on trans5's or ford2's routed handle at each batch of
    ``B10_SMALL_BATCHES``: each stream's kernel device time, the whole
    ``linear``'s device busy and wall, and its l1 error against a float64
    CSR product.  Returns False when the linear misses it."""
    h = routed_handle(name, False, False)
    coo = suite_matrix(name, 1.0, seed=cs.SEED)
    csr = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([coo.rows, coo.cols]).astype(np.int64)),
        torch.from_numpy(coo.values.astype(np.float64)), coo.shape,
    ).coalesce().to_sparse_csr().cuda()
    R, C = h.shape
    gen = np.random.default_rng(B10_SEED)
    ok = True
    for B in B10_SMALL_BATCHES:
        xd = torch.from_numpy(gen.standard_normal((B, C)).astype(
            np.float32)).cuda()
        xt = h._pad_x(xd).T.reshape(-1, 128, B).contiguous()
        per = [kernel_ms(lambda a=a: call(*a), key="batched_kernel")
               for _, a in b10_stream_args(h, xt, adds)]
        tiles = [d[0] * d[1] for d in h._routed_meta["streams"]]
        wall = cs.median_ms(lambda: h.linear(xd))
        busy = cs.device_ms(lambda: h.linear(xd))
        want = (csr @ xd.double().T).T
        err = float((h.linear(xd).double() - want).abs().sum()
                    / want.abs().sum())
        ok &= err < 1e-5
        print(f"{label} B10 {name} B {B}: streams of {tiles} tiles, kernel "
              f"{', '.join(cs._ms(m) for m in per)}, summed "
              f"{sum(m or 0.0 for m in per):.4f} ms; linear device busy "
              f"{cs._ms(busy)}, wall {wall:.4f} ms; l1 rel err {err:.3e}",
              flush=True)
    return ok


def b10_pokec_handle():
    """The routed handle of the benchmark's ``pokec`` matrix (its
    generator at ``B10_SEED``, on the card): loaded from the plan file at
    $KC_B10_PLAN (default ``b10_pokec_plan.npz`` here) where it exists,
    else planned (~100 s) and saved there, so that two checkouts in one
    call time the same plan.  Returns (handle, the matrix as a float64 CSR
    tensor on the card, seconds to make the handle)."""
    from hispmv_tpu_torch.plan import load_plan, save_plan
    from spmvbench.core import Matrix

    with open(os.path.join("spmvbench", "configs", "pokec.json")) as f:
        config = json.load(f)
    m = Matrix(config, B10_SEED, "cuda")
    rows, cols, vals = m.ref
    csr = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([rows, cols]).astype(np.int64)),
        torch.from_numpy(vals.astype(np.float64)), m.shape,
    ).coalesce().to_sparse_csr().cuda()
    path = os.environ.get("KC_B10_PLAN", "b10_pokec_plan.npz")
    t0 = time.perf_counter()
    if os.path.exists(path):
        h = SpmvHandle.from_plan(load_plan(path), device="cuda")
    else:
        h = prepare(m.coo(), format="routed", device="cuda")
        save_plan(path, h.plan, compress=False)
    torch.cuda.synchronize()
    return h, csr, time.perf_counter() - t0


def b10_report(label, rng):
    """B10 on the benchmark's pokec matrix at B 64 (``pokec.ppr64``'s
    batch), stream by stream, in the checkout's own contract: the kernel's
    device time alone (the profiler's events whose name holds
    ``batched_kernel``), with x = 0 (every sum zero: no atomic, no y
    traffic; the rest of the kernel as before), and, for a kernel that runs
    one CTA a group of 8 vectors (a vector-major y), at B 8 (one group: the
    stream words read once), beside its byte bound (the stream's arrays,
    x and y each once) and cuSPARSE's CSR product of the stream's nonzeros
    against the batch; then the handle's whole ``linear`` at B 64 (wall,
    device busy, B10's share) against a float64 CSR product.  Returns
    False when the linear misses the golden."""
    h, csr, made_s = b10_pokec_handle()
    meta = h._routed_meta
    R, C = h.shape
    wrapper = sr.spmv_routed_stream_batched
    adds = "y" in inspect.signature(wrapper).parameters
    # the checkout's chip_smoke.py call of B10: into a fresh y, or the
    # parent's wrapper, which makes its own
    call = cs.CALL.get("spmv_routed_batched", wrapper)
    print(f"{label} B10 pokec: {R} x {C}, {h.nnz} nonzeros, "
          f"{len(meta['streams'])} streams, {meta['nyt']} y tiles, handle "
          f"in {made_s:.1f} s; B10 {'adds into a vector-minor y' if adds else 'vector-major y, V groups'}",
          flush=True)
    gen = np.random.default_rng(B10_SEED)
    xd = torch.from_numpy(gen.random((B10_BATCH, C), dtype=np.float32)).cuda()
    xt = h._pad_x(xd).T.reshape(-1, 128, B10_BATCH).contiguous()
    nyt = meta["nyt"]
    key = "batched_kernel"
    tot = {"ms": 0.0, "x0": 0.0, "b8": 0.0, "bound": 0.0, "csr": 0.0}
    x0 = torch.zeros_like(xt)
    x8 = xt[:, :, :8].contiguous()
    for i, ((dims, a64), (_, a0), (_, a8)) in enumerate(zip(
            *(b10_stream_args(h, x, adds) for x in (xt, x0, x8)))):
        packed = a64[0]
        ms = kernel_ms(lambda a=a64: call(*a), key=key)
        ms0 = kernel_ms(lambda a=a0: call(*a), key=key)
        line = (f"{label} B10 pokec s{i} [{dims[0]} tiles, W {dims[2]}, l1 "
                f"{dims[3]}, lmax {dims[4]}"
                + (f", {meta['runs'][i]} runs" if adds else "")
                + f"]: kernel {cs._ms(ms)}, x = 0 {cs._ms(ms0)}")
        tot["ms"] += ms or 0.0
        tot["x0"] += ms0 or 0.0
        if not adds:
            ms8 = kernel_ms(lambda a=a8: call(*a), key=key)
            line += f", B 8 (one vector group) {cs._ms(ms8)}"
            tot["b8"] += ms8 or 0.0
        nbytes = sum(t.nbytes for t in packed) + xt.nbytes \
            + nyt * 1024 * B10_BATCH * 4
        bound = 1e3 * nbytes / cs.HBM_BYTES_PER_S
        tot["bound"] += bound
        lib = cs.library_call("spmv_routed_batched", a64)
        lib_ms = cs.device_ms(lib) if lib is not None else None
        tot["csr"] += lib_ms or 0.0
        print(f"{line}, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB), CSR "
              f"A_s @ X device busy {cs._ms(lib_ms)}", flush=True)
        del lib
        torch.cuda.empty_cache()
    print(f"{label} B10 pokec all streams: kernel {tot['ms']:.4f} ms, x = 0 "
          f"{tot['x0']:.4f} ms" + ("" if adds else
                                   f", B 8 {tot['b8']:.4f} ms")
          + f", bound {tot['bound']:.4f} ms, CSR {tot['csr']:.4f} ms",
          flush=True)
    # the whole linear at B 64, held to a float64 CSR product
    wall = cs.median_ms(lambda: h.linear(xd))
    busy = cs.device_ms(lambda: h.linear(xd))
    own = kernel_ms(lambda: h.linear(xd), key=key)
    want = (csr @ xd.double().T).T
    got = h.linear(xd).double()
    err = float((got - want).abs().sum() / want.abs().sum())
    worst = float((got - want).abs().max() / want.abs().max())
    print(f"{label} B10 pokec linear B {B10_BATCH}: wall {wall:.4f} ms, "
          f"device busy {cs._ms(busy)}, B10 {cs._ms(own)}; against float64 "
          f"CSR: l1 rel err {err:.3e}, max err / max |y| {worst:.3e}",
          flush=True)
    ok = err < 1e-5
    del h, csr
    torch.cuda.empty_cache()
    for name in B10_SMALL:
        ok &= b10_small_report(label, name, call, adds)
    return ok


REPORTS = {"b9": b9_report, "b12": b12_report, "b11": b11_report,
           "b13": b13_report, "dist": dist_report, "trace": trace_report,
           "b10": b10_report}


def main(label: str, groups=()) -> int:
    if not torch.cuda.is_available():
        print("kernel_compare: needs a CUDA card", file=sys.stderr)
        return 2
    rng = np.random.default_rng(cs.SEED)
    ok = True
    known = list(GROUPS) + list(REPORTS)
    groups = set(groups) or set(known)
    if groups - set(known):
        raise SystemExit(f"kernel_compare: groups are {known}, not "
                         f"{sorted(groups - set(known))}")
    cases, calls = [], []
    for g in GROUPS:  # in this order, each group's rng draws as before
        if g in groups:
            got = GROUPS[g](rng)
            if g == "b3":
                got, calls = got
            cases += got
    for tag, name, args, run, *kw in cases:
        kw = kw[0] if kw else {}
        kern, plain = cs.KERNELS[name]["wrapper"], cs.PLAIN[name]
        y = kern(*args, **kw)
        agree, _, line = cs._agree(name, y, plain(*args))
        ok &= agree
        bound, by = cs.kernel_bound(name, args, kw, y)
        busy = cs.device_ms(lambda: kern(*args, **kw))
        msg = (f"{label} {tag}: device busy {cs._ms(busy)}, bound "
               f"{bound:.4f} ms ({by}), {line}, {'ok' if agree else 'FAIL'}")
        lib = cs.library_call(name, args)
        if lib is not None:
            msg += (f"; CSR wall {cs.median_ms(lib):.4f} ms, device busy "
                    f"{cs._ms(cs.device_ms(lib))}")
        if _takes_vpt(kern):
            msg += "; " + v_sweep(kern, args, SWEEP[name])
        if name == "spmv_chunked_tiled":
            mr, mb = must_read_ms(args, y)
            msg += f"; must-read bound {mr:.4f} ms ({mb:.1f} MB)"
            if len(args) > 10 and run is not None:
                msg += f"; granularity probe: {granularity_probe(args)}"
        if run is not None:
            msg += (f"; handle run wall {cs.median_ms(run):.4f} ms, device "
                    f"busy {cs._ms(cs.device_ms(run))}")
        print(msg, flush=True)
    for tag, call in calls:
        print(f"{label} {tag}: wall {cs.median_ms(call):.4f} ms, device busy "
              f"{cs._ms(cs.device_ms(call))}", flush=True)
    if "b4" in groups:
        for line in ptxas_registers():
            print(f"{label} ptxas {line}", flush=True)
    for g, report in REPORTS.items():
        if g in groups:
            ok &= report(label, rng)
    print(f"{label} {cs.gpu_line()}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["calibrate"]:
        if not torch.cuda.is_available():
            print("kernel_compare: needs a CUDA card", file=sys.stderr)
            sys.exit(2)
        sys.exit(calibrate())
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "tree",
                  sys.argv[2:]))
