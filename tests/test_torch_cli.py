"""The port's CLI, metrics CSV and timing harness on the CPU.

The cases of ``tests/test_cli.py`` with ``--device cpu``; the ``--format
tune`` pick equals the JAX CLI's on ``@poli_large:0.5``; ``python -m
hispmv_tpu_torch`` runs the CLI (and importing ``__main__`` does not);
the tune line labels a model-only figure as the profile's estimate.
``utils/timing``: a positive median time and the result of the timed call
captured."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hispmv_tpu.cli import main as jmain
from hispmv_tpu.utils.metrics import read_metrics as jread_metrics
from hispmv_tpu_torch import SpmvHandle
from hispmv_tpu_torch.cli import main
from hispmv_tpu_torch.formats.mtx import save_mtx
from hispmv_tpu_torch.formats.synth import random_coo
from hispmv_tpu_torch.utils.metrics import (
    FIELDS,
    MetricsRow,
    append_metrics,
    read_metrics,
)
from hispmv_tpu_torch.utils.timing import bench_spmv, median_ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_synthetic_suite(tmp_path, capsys):
    csv = str(tmp_path / "m.csv")
    rc = main(["@poli_large:0.5", "--format", "tune", "--no-bench",
               "--metrics-csv", csv, "--tune-cache",
               str(tmp_path / "cache.json"), "--device", "cpu"])
    assert rc == 0
    rows = read_metrics(csv)
    assert len(rows) == 1
    assert rows[0]["verified"] == "True"
    assert int(rows[0]["nnz"]) > 0
    assert rows[0]["kernel_s"] == "nan"
    out = capsys.readouterr().out
    assert "model est (tpu-v5e)" in out and "PASS" in out


def test_cli_tune_pick_equals_jax_cli(tmp_path):
    csv, jcsv = str(tmp_path / "m.csv"), str(tmp_path / "j.csv")
    assert main(["@poli_large:0.5", "--format", "tune", "--no-bench",
                 "--metrics-csv", csv, "--device", "cpu"]) == 0
    assert jmain(["@poli_large:0.5", "--format", "tune", "--no-bench",
                  "--metrics-csv", jcsv]) == 0
    (row,), (jrow,) = read_metrics(csv), jread_metrics(jcsv)
    # (device bytes differ: the routed handles pack their streams apart)
    for k in ("matrix", "rows", "cols", "nnz", "format", "verified"):
        assert row[k] == jrow[k], k
    assert float(row["predicted_s"]) == pytest.approx(
        float(jrow["predicted_s"]), rel=1e-9)


def test_cli_dense_mode():
    assert main(["64", "96", "--no-bench", "--device", "cpu"]) == 0


def test_cli_mtx_file(tmp_path):
    p = str(tmp_path / "a.mtx")
    save_mtx(p, random_coo(60, 50, 400, seed=1))
    assert main([p, "--no-bench", "--format", "window", "--device",
                 "cpu"]) == 0


def test_cli_alpha():
    assert main(["@poli_large:0.3", "--no-bench", "--alpha", "2.5",
                 "--device", "cpu"]) == 0


@pytest.mark.parametrize("fmt", ["split", "routed", "ellx", "block"])
def test_cli_bench_and_beta(tmp_path, fmt, capsys):
    """A timed run with beta, in a format of each family; the metrics
    row carries the time on the device named."""
    csv = str(tmp_path / "m.csv")
    assert main(["@trans5:0.02", "--format", fmt, "--beta", "0.5",
                 "--metrics-csv", csv, "--device", "cpu"]) == 0
    (row,) = read_metrics(csv)
    assert row["format"] == fmt and row["verified"] == "True"
    assert float(row["kernel_s"]) > 0 and float(row["gflops"]) > 0
    assert "us on cpu" in capsys.readouterr().out


def test_cli_measured_tune_labels_times(tmp_path, capsys):
    cache = str(tmp_path / "c.json")
    assert main(["@trans5:0.02", "--format", "tune", "--measure", "2",
                 "--tune-cache", cache, "--no-bench", "--device",
                 "cpu"]) == 0
    out = capsys.readouterr().out
    assert "measured on cpu" in out and "'cpu us'" in out
    assert os.path.exists(cache + ".measured")


def test_cli_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["64", "96", "--no-bench"])


def test_python_m_runs_the_cli(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "hispmv_tpu_torch", "48", "40", "--no-bench",
         "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "PASS" in out.stdout
    # importing the module runs nothing
    out = subprocess.run(
        [sys.executable, "-c", "import hispmv_tpu_torch.__main__"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0 and out.stdout == "", out.stderr


def test_metrics_roundtrip(tmp_path):
    p = str(tmp_path / "m.csv")
    row = MetricsRow("a", 1, 2, 3, "ellx", 0.5, 0.1, 0.2, 0.3, 4, 1e-6,
                     2e-6, 9.0, True, 1e-4)
    append_metrics(p, row)
    append_metrics(p, row)
    rows = read_metrics(p)
    assert len(rows) == 2 and list(rows[0]) == FIELDS
    assert rows[1]["format"] == "ellx" and rows[1]["verified"] == "True"


def test_median_ms_positive_on_cpu():
    a = torch.randn(64, 64)
    x = torch.randn(64)
    calls = []

    def fn():
        calls.append(1)
        return a @ x

    t = median_ms(fn, runs=5, warmup=2, device="cpu")
    assert t > 0 and len(calls) == 7


def test_bench_spmv_captures_result():
    coo = random_coo(300, 200, 3000, seed=2)
    h = SpmvHandle(coo, format="ellx", device="cpu")
    x = np.random.default_rng(3).standard_normal(200).astype(np.float32)
    t, y = bench_spmv(h, x, runs=3, warmup=1)
    assert t > 0
    assert isinstance(y, np.ndarray) and y.shape == (300,)
    np.testing.assert_array_equal(y, h.run(x).numpy())
    np.testing.assert_allclose(y, coo.matvec(x.astype(np.float64)),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        bench_spmv(h, x[:100])
