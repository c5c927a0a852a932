"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: the ``file`` of its ``configs`` entry;
- a traffic mix: ``spmvbench/traffic/<traffic>.json``;
- the limits of a cell's check: ``spmvbench/limits/<workload>.json``;
- a metric's reader: ``spmvbench/metrics/<metric>.py``, whose ``read(ctx)``
  returns the number, or None where it finds nothing to read.

A cell reports the end-to-end metrics that list it under ``workloads``,
or that list no cells; with ``--trace 1`` it reports the per-layer
metrics that list it, or, where a metric lists no cells, those whose
``moves`` metric the cell reports.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load():
    return _load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _lists(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(bench, workload):
    """The configuration, traffic, limits and metrics of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(ROOT, configs[cell["config"]]["file"]))
    traffic = _load_json(os.path.join(BENCH_DIR, "traffic",
                                      cell["traffic"] + ".json"))
    limits = _load_json(os.path.join(BENCH_DIR, "limits",
                                     workload + ".json"))
    e2e = [m for m in bench["end_to_end"] if _lists(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return {"workload": cell, "config": config, "traffic": traffic,
            "limits": limits, "end_to_end": e2e, "per_layer": per_layer}


@functools.lru_cache(maxsize=None)
def reader(name):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "spmvbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
