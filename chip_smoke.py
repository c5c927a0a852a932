#!/usr/bin/env python3
"""Smoke run of hispmv_tpu_torch on one CUDA card (written for an H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``hispmv_tpu_torch/csrc/``,
drives the port's main path (``prepare`` -> ``SpmvHandle.run`` and
``Accelerator``) on full-scale suite stand-ins, holds every result to the
float64 golden at rtol 1e-3, checks that the path went through the kernels,
then compares each kernel with its plain PyTorch version on the same arrays
and times both.  It exits nonzero, without a result line, when there is no
CUDA card or any check fails.  The last line of standard output is
``{"ok": true, "device": {...}}``.
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
from hispmv_tpu_torch.ops import cuda_build
from hispmv_tpu_torch.ops.spmv_chunked import (
    spmv_chunked,
    spmv_chunked_plain,
)
from hispmv_tpu_torch.ops.spmv_windowed import (
    spmv_windowed,
    spmv_windowed_plain,
)
from hispmv_tpu_torch.utils.errors import error_stats

SEED = 0
ALPHA, BETA = 1.5, -0.5
RTOL = 1e-3  # the reference's acceptance (utils/errors.py)
KERNEL_RTOL = 1e-5  # kernel vs plain: fp32 both, only the summation order
TIMED_RUNS = 20

# (label, fixture, config, format asked, format expected, kernel expected)
SPARSE_RUNS = [
    ("crystk03 auto", "crystk03", SpmvConfig(), "auto", "window",
     "spmv_windowed"),
    ("crystk03 window bh64", "crystk03", SpmvConfig(block_h=64), "window",
     "window", "spmv_windowed"),
    ("trans5 auto", "trans5", SpmvConfig(), "auto", "ellx", "spmv_chunked"),
    ("TSOPF_RS_b2383 block", "TSOPF_RS_b2383", SpmvConfig(), "block",
     "block", "spmv_chunked"),
]
DENSE_N = 4096

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


def main_path(fixtures, failures):
    """Drive prepare -> run (and Accelerator) once per configuration; the
    kernels' launch counts are zeroed just before and read just after."""
    for k in KERNELS.values():
        k["wrapper"].launches = 0
    rng = np.random.default_rng(SEED)
    handles, rows_out = {}, []
    for label, name, cfg, fmt, want_fmt, kernel in SPARSE_RUNS:
        coo = fixtures[name]
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
        before = launches()
        y = h.run(xd, yd, ALPHA, BETA)
        torch.cuda.synchronize()
        want = ALPHA * coo.matvec(x.astype(np.float64)) + BETA * y_in
        check_run(label, y, want, h, failures)
        ms = median_ms(lambda: h.run(xd, yd, ALPHA, BETA))
        used = {n: c - before[n] for n, c in launches().items()}
        if used[kernel] == 0:
            failures.append(f"{label}: {kernel} was not launched")
        rows_out.append(_row(label, h, coo.nnz, coo.num_rows, prep_s, ms,
                             used))
        handles[label] = (h, xd)

    # dense overlay through the Accelerator
    label = f"dense {DENSE_N}x{DENSE_N} Accelerator"
    w = rng.standard_normal((DENSE_N, DENSE_N)).astype(np.float32)
    acc = Accelerator()
    t0 = time.perf_counter()
    mid = acc.create_dense_handle(w)
    acc.load_matrices()
    prep_s = time.perf_counter() - t0
    acc.select_matrix(mid)
    x, y_in = inputs(DENSE_N, DENSE_N, rng)
    xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y_in).cuda()
    before = launches()
    y = acc.run_kernel(xd, yd, ALPHA, BETA)
    torch.cuda.synchronize()
    want = (ALPHA * (w.astype(np.float64) @ x.astype(np.float64))
            + BETA * y_in)
    check_run(label, y, want, acc.handle(mid), failures)
    ms = median_ms(lambda: acc.run_kernel(xd, yd, ALPHA, BETA))
    used = {n: c - before[n] for n, c in launches().items()}
    rows_out.append(_row(label, acc.handle(mid), DENSE_N * DENSE_N, DENSE_N,
                         prep_s, ms, used))
    counts = launches()
    for n, c in counts.items():
        if c == 0:
            failures.append(f"main path never launched {n}")
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


def kernel_checks(handles, failures):
    """Each kernel against its plain PyTorch version on the arrays and x
    that the main path gave it; launches here are not counted."""
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
    plain = {"spmv_chunked": spmv_chunked_plain,
             "spmv_windowed": spmv_windowed_plain}
    results = []
    for name, shape, args in cases:
        kern = KERNELS[name]["wrapper"]
        yk = kern(*args)
        yp = plain[name](*args)
        torch.cuda.synchronize()
        diff = (yk - yp).abs()
        ymax = float(yp.abs().max())
        bound = KERNEL_RTOL * yp.abs() + KERNEL_RTOL * max(ymax, 1e-30)
        worst = float((diff / bound).max())
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

    log("phase 4: each kernel against its plain version")
    results = kernel_checks(handles, failures)

    kernels = [{
        "name": f"{name} [{shape}]", "route": "cuda",
        "source": KERNELS[name]["source"],
        "replaces": KERNELS[name]["replaces"],
        "launches": counts[name], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
    } for name, shape, err, ms, plain_ms in results]
    log(json.dumps({"runs": runs}))
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
