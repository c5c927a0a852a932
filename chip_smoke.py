#!/usr/bin/env python3
"""Smoke run of hispmv_tpu_torch on one CUDA card (written for an H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``hispmv_tpu_torch/csrc/``
(B1, B2, B7, B8, B9, B10, B11), then drives three paths of the port, each
run with the launch counts zeroed just before it and read just after:

- ``prepare`` -> ``SpmvHandle.run`` and ``Accelerator`` (formats window,
  ellx, block, dense and routed, the latter in original and rank space) on
  full-scale suite stand-ins;
- ``SpmvHandle.linear`` / ``Accelerator.linear`` on those handles at a
  batch of 64 (8 for the ELLX base), with a bias;
- the three-layer MLP at full width (4096 -> 8192 -> 8192 -> 1024, density
  0.1) swapped onto the card by ``AcceleratorLayerManager``, at batches of
  64 and 1.

Every result is held to a float64 golden at rtol 1e-3.  Then each kernel
is compared with its plain PyTorch version on the arrays the paths gave it
and both are timed, and the rank-space permutation is timed beside a
direct ``index_select``.  It exits nonzero, without a result line, when
there is no CUDA card or any check fails.  The last line of standard
output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from hispmv_tpu_torch import Accelerator, SpmvConfig, prepare
from hispmv_tpu_torch.formats.synth import suite_matrix
from hispmv_tpu_torch.models import (
    AcceleratorLayerManager,
    ThreeLayerFCModel,
    compare_model_outputs,
)
from hispmv_tpu_torch.ops import cuda_build
from hispmv_tpu_torch.ops.permute import (
    permute_apply,
    permute_stage,
    permute_stage_plain,
)
from hispmv_tpu_torch.ops.spmv_chunked import (
    spmv_chunked,
    spmv_chunked_batched,
    spmv_chunked_batched_plain,
    spmv_chunked_plain,
)
from hispmv_tpu_torch.ops.spmv_routed import (
    spmv_routed_stream,
    spmv_routed_stream_batched,
    spmv_routed_stream_batched_plain,
    spmv_routed_stream_plain,
    stream_array_names,
)
from hispmv_tpu_torch.ops.spmv_windowed import (
    pack_batch_x,
    spmv_windowed,
    spmv_windowed_batched,
    spmv_windowed_batched_plain,
    spmv_windowed_plain,
)
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
    "spmv_routed": {
        "wrapper": spmv_routed_stream,
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
}


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
    if once["spmv_routed"] != nstreams:
        failures.append(f"{label}: {once['spmv_routed']} B9 launches for "
                        f"{nstreams} streams")
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
        rows_out.append(_row(label, h, coo.nnz, coo.num_rows, prep_s, ms,
                             used))
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


def _row(label, h, nnz, rows, prep_s, ms, used):
    gflops = 2.0 * (nnz + rows) / (ms * 1e-3) / 1e9
    row = {
        "run": label, "format": h.format, "nnz": int(nnz),
        "prepare_s": prep_s, "device_mb": h.device_bytes / 2**20,
        "launches": used, "run_ms": ms, "gflops": gflops,
    }
    log(f"  {label}: format {h.format}, nnz {nnz}, prepare {prep_s:.2f} s, "
        f"device {row['device_mb']:.1f} MB, launches {used}, "
        f"median run {ms:.4f} ms, {gflops:.2f} GFLOP/s")
    return row


def linear_checks(label, h, B, once, failures):
    """Launch counts of ONE linear call: B10 once per stream for the whole
    batch; B9 per stream and B11 six times per vector in rank space."""
    if h.format != "routed":
        return
    nstreams = len(h.plan.streams)
    want = {"spmv_routed_batched": nstreams, "spmv_routed": 0,
            "permute_stage": 0}
    if h.config.rank_sort:
        want = {"spmv_routed_batched": 0, "spmv_routed": B * nstreams,
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
        log(f"  {label}: launches {used}, median linear {ms:.4f} ms, "
            f"{gflops:.2f} GFLOP/s")
        rows_out.append({"run": label, "format": h.format, "batch": B,
                         "launches": used, "linear_ms": ms,
                         "gflops": gflops,
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


def kernel_checks(handles, linear_x, accel, failures):
    """Each kernel against its plain PyTorch version on the arrays and x
    that the paths gave it (the batched kernels on the batches of the
    linear runs and on the MLP's fc3 activations); launches here are not
    counted."""
    cases = []
    h, xd = handles["TSOPF_RS_b2383 block"]
    p = h.plan
    cases.append(("spmv_chunked", "TSOPF_RS_b2383 block, bh 8",
                  (h._d["data"], h._d["meta"], h._pad_x(xd).reshape(-1, 128),
                   p.num_row_blocks, p.block_h, h._chunk)))
    h, xd = handles["trans5 auto"]
    p = h.plan
    cases.append(("spmv_chunked", "trans5 ELLX overflow, bh 8",
                  (h._d["odata"], h._d["ometa"],
                   h._pad_x(xd).reshape(-1, 128),
                   p.overflow.num_row_blocks, p.block_h, h._chunk)))
    for label in ("crystk03 auto", "crystk03 window bh64"):
        h, xd = handles[label]
        p = h.plan
        cases.append(("spmv_windowed", f"{label}, bh {p.block_h}",
                      (h._d["data"], h._d["subidx"], h._d["meta"],
                       h._pad_x(xd).reshape(-1, 128), p.num_row_blocks,
                       p.block_h, h._wchunk)))
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
    plain = {"spmv_chunked": spmv_chunked_plain,
             "spmv_windowed": spmv_windowed_plain,
             "spmv_routed": spmv_routed_stream_plain,
             "permute_stage": permute_stage_plain,
             "spmv_chunked_batched": spmv_chunked_batched_plain,
             "spmv_windowed_batched": spmv_windowed_batched_plain,
             "spmv_routed_batched": spmv_routed_stream_batched_plain}
    results = []
    for name, shape, args in cases:
        kern = KERNELS[name]["wrapper"]
        yk = kern(*args)
        yp = plain[name](*args)
        torch.cuda.synchronize()
        diff = (yk - yp).abs()
        ymax = float(yp.abs().max())
        bound = KERNEL_RTOL * yp.abs() + KERNEL_RTOL * max(ymax, 1e-30)
        if name == "permute_stage":  # a permutation does no arithmetic
            bound = torch.zeros_like(bound)
        worst = float((diff / bound.clamp_min(1e-30)).max())
        err = float(diff.max())
        ms = median_ms(lambda: kern(*args))
        plain_ms = median_ms(lambda: plain[name](*args))
        ok = bool((diff <= bound).all()) and bool(torch.isfinite(yk).all())
        log(f"  {name} [{shape}]: max abs err {err:.3e} (max |y| "
            f"{ymax:.3e}, max rel diff {err / max(ymax, 1e-30):.3e}, "
            f"worst err/bound {worst:.3f}), kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} [{shape}] disagrees with its plain "
                            "version")
        results.append((name, shape, err, ms, plain_ms))
    return results


def batched_cases(handles, linear_x, accel):
    """B2, B8 and B10 on the arrays and batches of the linear runs, and B8
    on the MLP's fc3 at batch 64."""
    cases = []
    h, _ = handles["TSOPF_RS_b2383 block"]
    xb = h._pad_x(linear_x["TSOPF_RS_b2383 block"])
    p = h.plan
    cases.append(("spmv_chunked_batched",
                  f"TSOPF_RS_b2383 block, bh 8, B {xb.shape[0]}",
                  (h._d["data"], h._d["meta"],
                   xb.T.reshape(-1, 128, xb.shape[0]).contiguous(),
                   p.num_row_blocks, p.block_h, h._chunk)))
    h, _ = handles["trans5 auto"]
    xb = h._pad_x(linear_x["trans5 auto"])
    p = h.plan
    cases.append(("spmv_chunked_batched",
                  f"trans5 ELLX overflow, bh 8, B {xb.shape[0]}",
                  (h._d["odata"], h._d["ometa"],
                   xb.T.reshape(-1, 128, xb.shape[0]).contiguous(),
                   p.overflow.num_row_blocks, p.block_h, h._chunk)))
    h, _ = handles["crystk03 auto"]
    xb = h._pad_x(linear_x["crystk03 auto"])
    p = h.plan
    cases.append(("spmv_windowed_batched",
                  f"crystk03, bh {p.block_h}, B {xb.shape[0]}",
                  (h._d["data"], h._d["subidx"], h._d["meta"],
                   pack_batch_x(xb, p.num_windows), p.num_row_blocks,
                   p.block_h, h._wchunk)))
    # fc3 of the MLP on its real input: fc2's activations at batch 64
    (h1, b1), (h2, b2), (h, _) = accel.layers
    x = torch.from_numpy(np.random.default_rng(SEED + 3).standard_normal(
        (BATCH, MLP["input"])).astype(np.float32)).cuda()
    xb = h._pad_x(torch.relu(h2.linear(torch.relu(h1.linear(x, b1)), b2)))
    p = h.plan
    cases.append(("spmv_windowed_batched",
                  f"MLP fc3 {p.shape[0]}x{p.shape[1]}, bh {p.block_h}, "
                  f"B {BATCH}",
                  (h._d["data"], h._d["subidx"], h._d["meta"],
                   pack_batch_x(xb, p.num_windows), p.num_row_blocks,
                   p.block_h, h._wchunk)))
    for label in ("trans5 routed", "ford2 routed"):
        h, _ = handles[label]
        meta = h._routed_meta
        xb = h._pad_x(linear_x[label])
        B = xb.shape[0]
        for i, dims in enumerate(meta["streams"]):
            p = f"s{i}_"
            packed = tuple(h._d[p + n] for n in stream_array_names(dims[4]))
            packed += (h._d[p + "base"], h._d[p + "byt"])
            cases.append(("spmv_routed_batched",
                          f"{label.split()[0]} stream {i}: {dims[0]} tiles, "
                          f"W {dims[2]}, l1 {dims[3]}, lmax {dims[4]}, B {B}",
                          (packed, dims, xb.reshape(-1, 128), meta["nyt"],
                           B)))
    return cases


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
    for n, c in counts.items():
        if c == 0:
            failures.append(f"the paths never launched {n}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f}"
        " MB")

    log("phase 4: each kernel against its plain version")
    results = kernel_checks(handles, linear_x, accel, failures)
    perm_times = permute_vs_gather(handles, failures)

    kernels = [{
        "name": f"{name} [{shape}]", "route": "cuda",
        "source": KERNELS[name]["source"],
        "replaces": KERNELS[name]["replaces"],
        "launches": counts[name], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
    } for name, shape, err, ms, plain_ms in results]
    log(json.dumps({"runs": runs, "linear": linear_runs, "mlp": mlp_runs,
                    "permutation": perm_times}))
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
