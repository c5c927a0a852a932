"""Host CLI: prepare, verify and time one matrix on the card.

Port of ``hispmv_tpu/cli.py`` (the reference's ``spmv-host``):

    python -m hispmv_tpu_torch MATRIX.mtx [options]     # MatrixMarket file
    python -m hispmv_tpu_torch ROWS COLS [options]      # dense GeMV mode
    python -m hispmv_tpu_torch @name[:scale] [options]  # suite stand-in

It takes the JAX CLI's flags plus ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch versions) and ``--profile`` (the device profile
that plans the matrix and ranks the tuner's candidates; by default the
device's: ``nvidia-h100-80gb-hbm3`` on the card, ``tpu-v5e`` on the
CPU).  The steps are the same: load, ``tune``
when ``--format tune`` (model-only, or measured on the device with
``--measure N``), prepare, check one ``run`` against the float64 golden
(exit 1 when it fails), time the run with ``utils/timing.bench_spmv``
(CUDA events on the card) unless ``--no-bench``, and append a metrics row
with ``--metrics-csv``.  A model-only tune's estimate is a figure of the
active profile and is printed under its name, never as a time.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from hispmv_tpu_torch.profiles import PROFILES, device_profile

FORMATS = ["auto", "tune", "block", "ellx", "split", "routed", "window",
           "stream", "dense"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hispmv_tpu_torch",
        description="SpMV/GeMV on a CUDA card: prepare, verify and time one "
                    "matrix",
    )
    p.add_argument(
        "matrix",
        nargs="+",
        help=".mtx path | ROWS COLS (dense) | @suite_name[:scale]",
    )
    p.add_argument(
        "--format", default="auto", choices=FORMATS,
        help="execution format; 'tune' runs the cost-model DSE",
    )
    p.add_argument("--block-h", type=int, default=None)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--beta", type=float, default=0.0)
    p.add_argument("--tune-cache", default=None, help="DSE cache JSON path")
    p.add_argument(
        "--measure", type=int, default=0,
        help="with --format tune: time the top N candidates on the device",
    )
    p.add_argument("--metrics-csv", default=None, help="append metrics row")
    p.add_argument(
        "--no-bench", action="store_true", help="verify only, skip timing"
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--device", default="cuda",
        help="torch device of the handle (default cuda; cpu runs the plain "
             "PyTorch versions)",
    )
    p.add_argument(
        "--profile", default=None, choices=sorted(PROFILES),
        help="device profile that plans and tunes (default: the device's)",
    )
    return p


def load_matrix(args):
    from hispmv_tpu_torch.formats.matrix import coo_from_dense
    from hispmv_tpu_torch.formats.mtx import load_mtx
    from hispmv_tpu_torch.formats.synth import suite_matrix

    spec = args.matrix
    if len(spec) == 2 and spec[0].isdigit() and spec[1].isdigit():
        rows, cols = int(spec[0]), int(spec[1])
        rng = np.random.default_rng(args.seed)
        dense = rng.standard_normal((rows, cols)).astype(np.float32)
        return f"dense-{rows}x{cols}", coo_from_dense(dense)
    name = spec[0]
    if name.startswith("@"):
        scale = 1.0
        body = name[1:]
        if ":" in body:
            body, s = body.split(":", 1)
            scale = float(s)
        return f"{body}(synth x{scale})", suite_matrix(body, scale=scale)
    return name, load_mtx(name)


def _tune_line(name, res, device, profile) -> str:
    """The tuner's pick, each figure labelled as a time on ``device`` or as
    ``profile``'s estimate."""
    model = f"model est ({profile.name})"
    cands = [
        (lbl, round(s * 1e6), f"{device} us" if i < res.n_measured
         else f"{model} us")
        for i, (lbl, s) in enumerate(res.candidates[:4])
    ]
    if res.measured:
        pick = f"measured on {device} {res.est_seconds * 1e6:.1f} us"
    else:
        pick = f"{model} {res.est_seconds * 1e6:.0f} us"
    return f"[{name}] tuned -> {res.format} ({pick}); candidates: {cands}"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    name, coo = load_matrix(args)

    from hispmv_tpu_torch.api.handle import SpmvHandle
    from hispmv_tpu_torch.config import SpmvConfig
    from hispmv_tpu_torch.utils.errors import error_stats, print_error_stats
    from hispmv_tpu_torch.utils.metrics import MetricsRow, append_metrics

    cfg = SpmvConfig() if args.block_h is None else SpmvConfig(
        block_h=args.block_h
    )
    fmt = args.format
    predicted = float("nan")
    profile = (PROFILES[args.profile] if args.profile
               else device_profile(args.device))
    if fmt == "tune":
        from hispmv_tpu_torch.tune import tune

        res = tune(coo, cache_path=args.tune_cache, measure=args.measure,
                   device=args.device, profile=profile)
        cfg, fmt, predicted = res.config, res.format, res.est_seconds
        print(_tune_line(name, res, args.device, profile))
        if args.measure > 1 and not res.measured:
            print(f"[{name}] no measured pick: every shortlisted candidate "
                  "failed on the device, or the fastest was over 4x the "
                  f"model's estimate for an unmeasured {res.format}; the "
                  "model's pick stands, unmeasured", file=sys.stderr)

    t0 = time.perf_counter()
    handle = SpmvHandle(coo, config=cfg, format=fmt, device=args.device,
                        profile=profile)
    prep_s = time.perf_counter() - t0
    print(
        f"[{name}] rows={coo.num_rows} cols={coo.num_cols} nnz={coo.nnz} "
        f"format={handle.format} fill={handle.stats.fill:.4f} "
        f"device_bytes={handle.device_bytes} prep={prep_s:.2f}s "
        f"device={handle.device} profile={profile.name}"
    )

    # golden model on the host (cpuSequential analog), timed
    i = np.arange(coo.num_cols, dtype=np.float32)
    x = (i + 2.0) / (i + 1.0)  # spmv-host.cpp:17-23 deterministic vector
    # deterministic y_in so that --beta takes part in the run and the golden
    j = np.arange(coo.num_rows, dtype=np.float32)
    y_in = None if args.beta == 0.0 else ((j % 7) - 3.0) / (j + 1.0)
    t0 = time.perf_counter()
    want = coo.matvec(x.astype(np.float64))
    cpu_s = time.perf_counter() - t0
    cpu_gflops = 2 * (coo.nnz + coo.num_rows) / max(cpu_s, 1e-12) / 1e9

    got = handle.run(x, y_in=y_in, alpha=args.alpha,
                     beta=args.beta).cpu().numpy()
    want = args.alpha * want
    if y_in is not None:
        want = want + args.beta * y_in.astype(np.float64)
    stats = error_stats(got, want)
    print_error_stats(stats, name)

    kernel_s = float("nan")
    gflops = float("nan")
    if not args.no_bench:
        from hispmv_tpu_torch.utils.timing import bench_spmv

        kernel_s, _ = bench_spmv(handle, x)
        gflops = 2 * (coo.nnz + coo.num_rows) / kernel_s / 1e9
        print(
            f"[{name}] kernel={kernel_s*1e6:.1f}us on {handle.device} "
            f"{gflops:.2f} GFLOP/s (host golden: {cpu_gflops:.2f} GFLOP/s)"
        )

    if args.metrics_csv:
        append_metrics(
            args.metrics_csv,
            MetricsRow(
                matrix=name,
                rows=coo.num_rows,
                cols=coo.num_cols,
                nnz=coo.nnz,
                format=handle.format,
                fill=handle.stats.fill,
                prep_s=prep_s,
                cpu_s=cpu_s,
                cpu_gflops=cpu_gflops,
                device_bytes=handle.device_bytes,
                predicted_s=predicted,
                kernel_s=kernel_s,
                gflops=gflops,
                verified=stats.ok,
                max_rel_err=stats.max_rel_error,
            ),
        )
    return 0 if stats.ok else 1


if __name__ == "__main__":
    sys.exit(main())
