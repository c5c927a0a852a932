#!/usr/bin/env python3
"""Times the block streams on the vec kernel (``csrc/block_vec.cuh``): B1
(``spmv_chunked``), B7 (``spmv_windowed``), B3 (``spmv_chunked_paneled``),
B2 (``spmv_chunked_batched``) and B8 (``spmv_windowed_batched``), and B6
(``spmv_block_batched``), on their cases of ``chip_smoke.py`` in the
checkout it runs from, so that two trees can be compared on one card in
one run: copy this file to the root of each checkout and run it there, the
trees in turns (parent, change, change, parent).

    python3 kernel_compare.py LABEL

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
shape (warps a CTA, row slices, CTAs).  B2 also runs on the Flan-sized
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
Exits 1 when a case disagrees, 2 without a CUDA card."""

import importlib
import inspect
import sys

import numpy as np
import torch

import chip_smoke as cs
from hispmv_tpu_torch import Accelerator, SpmvConfig, prepare
from hispmv_tpu_torch.dist import make_mesh, spmv_sharded_chunked, to_device
from hispmv_tpu_torch.formats.synth import blocked_coo, suite_matrix
from hispmv_tpu_torch.models import AcceleratorLayerManager, ThreeLayerFCModel
from hispmv_tpu_torch.ops import spmv_chunked as sc
from hispmv_tpu_torch.ops import spmv_windowed as sw

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
    label, R, C, nnz, layout, *_ = cs.LARGE_BLOCK_RUNS[0]
    fh = prepare(blocked_coo(R, C, nnz, seed=cs.SEED, spread_frac=0.4),
                 SpmvConfig(), "block")
    if not getattr(fh, "_" + layout):
        raise SystemExit(f"kernel_compare: {label} is not {layout}")
    fxb = torch.from_numpy(rng.standard_normal((B, C)).astype(
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


def main(label: str) -> int:
    if not torch.cuda.is_available():
        print("kernel_compare: needs a CUDA card", file=sys.stderr)
        return 2
    rng = np.random.default_rng(cs.SEED)
    ok = True
    b3, calls = b3_cases(rng)
    for tag, name, args, run, *kw in (b1_b7_cases(rng) + b3 + b2_cases(rng)
                                      + b8_cases(rng) + b6_cases(rng)):
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
        if run is not None:
            msg += (f"; handle run wall {cs.median_ms(run):.4f} ms, device "
                    f"busy {cs._ms(cs.device_ms(run))}")
        print(msg, flush=True)
    for tag, call in calls:
        print(f"{label} {tag}: wall {cs.median_ms(call):.4f} ms, device busy "
              f"{cs._ms(cs.device_ms(call))}", flush=True)
    print(f"{label} {cs.gpu_line()}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "tree"))
