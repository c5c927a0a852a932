"""The readings that the limits of the check are set from.

For each seed, one process makes the configuration's matrix once,
prepares the program once, and runs every cell of that configuration
through the code of a run (``core.measure``, then ``core.judge``) for a
short window, so that the numbers compared are read as a run reads them;
on the control seeds it does the same with the cell's lower-precision
control (``limits/<cell>.json``: ``control``) in the program's place.
Sharing the prepared program across the cells of a configuration saves
its planning (about 100 s for ``pokec``).  One JSON line a reading, also
appended to ``chiprun_out/readings.jsonl``::

    python3 spmvbench/readings.py --config flan1565 --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds 2
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _ints(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", type=_ints, required=True)
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out", default="chiprun_out/readings.jsonl")
    args = p.parse_args(argv)

    import torch

    from spmvbench import core, manifest
    from spmvbench.loop import sync
    from spmvbench.reference import CsrReference

    bench = manifest.load()
    specs = [manifest.cell_spec(bench, w["name"]) for w in bench["workloads"]
             if w["config"] == args.config]
    config = specs[0]["config"]
    cuda = torch.device(args.device).type == "cuda"
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t = time.perf_counter()
        matrix = core.Matrix(config, seed, args.device)
        gen_s = time.perf_counter() - t
        ref = CsrReference(matrix.shape, *matrix.ref, args.device)
        controls = [None] if seed in args.seeds else []
        if seed in args.control_seeds:
            controls += sorted({s["limits"]["control"] for s in specs})
        for control in controls:
            t = time.perf_counter()
            program = core.make_program(config, matrix, args.device, control)
            sync(args.device)
            prepare_s = time.perf_counter() - t
            for spec in specs:
                if control not in (None, spec["limits"]["control"]):
                    continue
                m = core.measure(spec, program, matrix.shape, seed,
                                 args.seconds, 0, args.device,
                                 time.perf_counter())
                correct, failed, checks = core.judge(
                    spec, m.solver.kept(), ref, m.nonfinite)
                emit({"cell": spec["workload"]["name"], "seed": seed,
                      "control": control, "correct": correct,
                      **{k: c["value"] for k, c in checks.items()},
                      "solves": len(m.solve_s), "window_s": m.window_s,
                      "solve_ms_median": 1e3 * sorted(m.solve_s)[
                          len(m.solve_s) // 2],
                      "prepare_s": prepare_s, "gen_s": gen_s,
                      "device": torch.cuda.get_device_name(args.device)
                      if cuda else "cpu"})
                del m
            del program
            core.free_device(args.device)
        del ref, matrix
        core.free_device(args.device)
    print(f"readings done in {time.perf_counter() - T0:.1f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
