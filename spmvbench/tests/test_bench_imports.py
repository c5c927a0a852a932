"""Nothing the benchmark runs imports jax or hispmv_tpu (top-level names
compared whole), and the yardstick imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from spmvbench import manifest
from spmvbench.run import FORBIDDEN, forbidden_modules

SOURCES = sorted(glob.glob(os.path.join(manifest.BENCH_DIR, "**", "*.py"),
                           recursive=True))
# the yardstick: what decides the numbers and ``correct``
YARDSTICK = ("gen.py", "reference.py", "roofline.py", "trace.py",
             "loop.py", "manifest.py")


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, manifest.BENCH_DIR)
                              for p in SOURCES])
def test_no_jax_in_any_source(path):
    assert not _top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    names = _top_level_imports(os.path.join(manifest.BENCH_DIR, name))
    assert "hispmv_tpu_torch" not in names


def test_metric_readers_import_nothing_of_the_program():
    for path in glob.glob(os.path.join(manifest.BENCH_DIR, "metrics",
                                       "*.py")):
        assert "hispmv_tpu_torch" not in _top_level_imports(path)


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "hispmv_tpu_torch.fake", object())
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "hispmv_tpu", raising=False)
    assert "hispmv_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "hispmv_tpu.api", object())
    assert forbidden_modules() == ["hispmv_tpu"]


def test_a_run_without_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's paths: the
    run exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "spmvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run(
        [sys.executable, "spmvbench/run.py", "--workload", "flan1565.power",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
