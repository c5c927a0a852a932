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

GROUPs (all when none is named): b1b7, b3, b2, b8, b6, b4, b9.

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
Exits 1 when a case disagrees, 2 without a CUDA card."""

import importlib
import inspect
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from hispmv_tpu_torch import Accelerator, SpmvConfig, prepare
from hispmv_tpu_torch.dist import make_mesh, spmv_sharded_chunked, to_device
from hispmv_tpu_torch.formats.synth import blocked_coo, suite_matrix
from hispmv_tpu_torch.models import AcceleratorLayerManager, ThreeLayerFCModel
from hispmv_tpu_torch.ops import cuda_build
from hispmv_tpu_torch.ops import spmv_chunked as sc
from hispmv_tpu_torch.ops import spmv_routed as sr
from hispmv_tpu_torch.ops import spmv_windowed as sw
from hispmv_tpu_torch.ops.permute import panel_permute_apply_from
from hispmv_tpu_torch.plan import gathered as gp

# the module: the ops package's function spmv_block shadows its name
sb = importlib.import_module("hispmv_tpu_torch.ops.spmv_block")


def _takes_vpt(fn):
    return "vpt" in inspect.signature(fn).parameters


_HANDLES = {}


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
         h.plan.num_row_blocks, h.plan.block_h, h._chunk, h._PANEL_NCB),
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
            pnrb, p.block_h, h._chunk, h._PANEL_NCB)
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
    ``gathered``, planned under ``chip_smoke.py``'s lowered gathered
    costs, so that it diverts tiles to the side-plan as phase 3g does."""
    saved = {k: getattr(gp, k) for k in cs.GATHERED_COSTS}
    try:
        if gathered:
            for k, v in cs.GATHERED_COSTS.items():
                setattr(gp, k, v)
        return prepare(suite_matrix(name, 1.0, seed=cs.SEED),
                       SpmvConfig(rank_sort=rank), "routed")
    finally:
        for k, v in saved.items():
            setattr(gp, k, v)


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


# the case groups, in the order they run (and draw from the generator)
GROUPS = {"b1b7": b1_b7_cases, "b3": b3_cases, "b2": b2_cases,
          "b8": b8_cases, "b6": b6_cases, "b4": b4_cases}
REPORTS = {"b9": b9_report}  # groups that print their own lines, last


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
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "tree",
                  sys.argv[2:]))
