"""Model demo CLI: the torch.nn model against its accelerated copy, timed
and compared.

Port of ``hispmv_tpu/models/demo.py``, with the same flags plus
``--device``:

    python -m hispmv_tpu_torch.models.demo --batch-size 64 --input-size 4096 \
        --hidden-size 8192 --output-size 1024 --density 0.1

Builds ThreeLayerFCModel (dense -> sparse -> sparse with ReLU) on
``--device`` (default ``cuda``, which raises without a card) from a
``torch.Generator`` seeded with ``--seed``, swaps its layers onto an
Accelerator with the layer manager, runs both on one batch, prints each
one's time per batch, and compares the outputs (rtol 1e-3, atol 1e-4).  On
the card the times are CUDA-event medians; on the CPU they are host
wall-clock medians.  Exits 1 when the outputs differ.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

TIMED_RUNS = 10


def median_ms(fn, device: torch.device, runs: int = TIMED_RUNS) -> float:
    """Median time of ``fn()`` after one warm-up call: CUDA events on a
    card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(runs):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hispmv_tpu_torch.models.demo")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--input-size", type=int, default=1024)
    ap.add_argument("--hidden-size", type=int, default=2048)
    ap.add_argument("--output-size", type=int, default=256)
    ap.add_argument("--density", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from hispmv_tpu_torch.api.handle import Accelerator
    from hispmv_tpu_torch.models import (
        AcceleratorLayerManager,
        ThreeLayerFCModel,
        compare_model_outputs,
    )
    from hispmv_tpu_torch.utils.errors import print_error_stats

    accel = Accelerator(device=args.device)  # raises without the device
    dev = accel.device
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    model = ThreeLayerFCModel(args.input_size, hidden=args.hidden_size,
                              out=args.output_size, density=args.density,
                              generator=gen, device=dev)
    print(f"model init: {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    mgr = AcceleratorLayerManager(accel)
    accel_model = mgr.replace_layers(model)
    fmts = [h.format for h, _ in accel_model.layers]
    print(f"layer swap: {time.perf_counter() - t0:.2f}s; formats per layer: "
          f"{dict(zip(mgr.layer_names, fmts))}")

    xb = np.random.default_rng(args.seed + 1).standard_normal(
        (args.batch_size, args.input_size)).astype(np.float32)
    x = torch.from_numpy(xb).to(dev)
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    with torch.no_grad():
        want = model(x)
        ms = median_ms(lambda: model(x), dev)
        print(f"torch.nn model:    {ms:8.3f} ms/batch ({clock})")
        got = accel_model(x)
        ms = median_ms(lambda: accel_model(x), dev)
        print(f"accelerated model: {ms:8.3f} ms/batch ({clock})")

    stats = compare_model_outputs(got, want)
    print_error_stats(stats, "model outputs")
    return 0 if stats.ok else 1


if __name__ == "__main__":
    sys.exit(main())
