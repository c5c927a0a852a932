"""Run one cell of the benchmark once and print its result line.

    python3 spmvbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Exits with 2, printing no result, where there is no CUDA card or fewer
than the cell asks for, and with 3 where the process holds jax, jaxlib,
flax or hispmv_tpu once the window has closed.  The last line of
standard output is the result; the last lines of standard error are the
numbers compared, each beside its limit.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

FORBIDDEN = ("jax", "jaxlib", "flax", "hispmv_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that must not be there, compared
    whole (``hispmv_tpu_torch`` is not ``hispmv_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out[0] if out else None


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch

    import hispmv_tpu_torch  # noqa: F401  (fails fast without the program)
    from spmvbench import core, manifest

    spec = manifest.cell_spec(manifest.load(), args.workload)
    chips = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"spmvbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = core.run_cell(spec, args.seed, args.seconds, args.trace,
                        "cuda:0", T0)
    found = forbidden_modules()
    if found:
        print(f"spmvbench: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 3
    checks = out.pop("checks")
    out["card"] = card()
    out["checks"] = checks
    for name, c in checks.items():
        bound = {k: v for k, v in c.items() if k != "value"}
        print(f"check {name} {c['value']!r} {bound}", file=sys.stderr)
        if not math.isfinite(c["value"]):
            c["value"] = None  # no finite reading: JSON has no inf
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
