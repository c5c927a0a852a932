"""Benchmark metrics records + CSV collation.

Carried over unchanged from ``hispmv_tpu/utils/metrics.py`` (the standard
library only), with the same CSV columns.  ``predicted_s`` is the tuner's
figure: a model estimate under its device profile (the device's by
default: H100 on the card), or the measured time when the tuner timed
its candidates;
``kernel_s`` is the time taken on the handle's device.

Schema mirrors the reference's metrics CSVs (builds/U280_metrics.csv:1):
matrix, preprocessing time, golden CPU time/GFLOPS, stream length (device
bytes), predicted time (cost model), measured kernel time, GFLOPS, format,
fill, verification result.
"""

from __future__ import annotations

import csv
import dataclasses
import os


FIELDS = [
    "matrix",
    "rows",
    "cols",
    "nnz",
    "format",
    "fill",
    "prep_s",
    "cpu_s",
    "cpu_gflops",
    "device_bytes",
    "predicted_s",
    "kernel_s",
    "gflops",
    "verified",
    "max_rel_err",
]


@dataclasses.dataclass
class MetricsRow:
    matrix: str
    rows: int
    cols: int
    nnz: int
    format: str
    fill: float
    prep_s: float
    cpu_s: float
    cpu_gflops: float
    device_bytes: int
    predicted_s: float
    kernel_s: float
    gflops: float
    verified: bool
    max_rel_err: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def append_metrics(path: str, row: MetricsRow) -> None:
    """Append one row, creating the file with a header when absent."""
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        if not exists:
            w.writeheader()
        w.writerow(row.as_dict())


def read_metrics(path: str) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))
