"""The port stands alone: importing it loads neither jax nor hispmv_tpu, the
default device is the card with no silent move to the CPU, and the kernel
library is rebuilt when a source changes."""

import importlib
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import hispmv_tpu_torch
from hispmv_tpu_torch import Accelerator, SpmvHandle, prepare
from hispmv_tpu_torch.formats.synth import random_coo
from hispmv_tpu_torch.ops import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax_and_no_reference_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import hispmv_tpu_torch
        for m in pkgutil.walk_packages(hispmv_tpu_torch.__path__,
                                       "hispmv_tpu_torch."):
            importlib.import_module(m.name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hispmv_tpu"))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    coo = random_coo(20, 30, 50, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        prepare(coo)
    with pytest.raises(RuntimeError, match="cuda"):
        SpmvHandle(np.eye(4, dtype=np.float32))
    with pytest.raises(RuntimeError, match="cuda"):
        Accelerator()


def test_public_names():
    for name in ("prepare", "SpmvHandle", "Accelerator", "SpmvConfig",
                 "COOMatrix", "choose_format"):
        assert hasattr(hispmv_tpu_torch, name)


@pytest.mark.parametrize("module,names", [
    ("hispmv_tpu_torch.ops", ("spmv_block", "spmv_block_stream",
                              "spmv_block_batched", "gemv", "spmv_ref",
                              "finalize_ref")),
    ("hispmv_tpu_torch.dist", ("init_distributed", "Mesh", "make_mesh",
                               "ShardedBlockPlan", "ShardedWindowPlan",
                               "ShardedChunkedPlan",
                               "build_sharded_block_plan",
                               "build_sharded_window_plan",
                               "build_sharded_chunked_plan", "spmv_sharded",
                               "spmv_sharded_window", "spmv_sharded_chunked",
                               "to_device")),
    ("hispmv_tpu_torch.dist.dryrun", ("dryrun_multichip",)),
])
def test_package_exports(module, names):
    mod = importlib.import_module(module)
    for name in names:
        assert callable(getattr(mod, name)), name


def test_import_builds_no_kernel():
    code = textwrap.dedent("""
        import hispmv_tpu_torch.dist, hispmv_tpu_torch.ops
        import hispmv_tpu_torch.dist.dryrun
        from hispmv_tpu_torch.ops import cuda_build
        assert cuda_build._lib is None
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_kernel_library_is_stale_when_a_source_changes(tmp_path,
                                                       monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    lib = tmp_path / "libhispmv_kernels.so"
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(cuda_build, "LIB_PATH", str(lib))
    assert [os.path.basename(s) for s in cuda_build.sources()] == [
        "permute.cu", "spmv_block.cu", "spmv_chunked.cu",
        "spmv_chunked_batched.cu", "spmv_chunked_paneled.cu",
        "spmv_routed.cu", "spmv_windowed.cu", "spmv_windowed_batched.cu",
    ]
    assert cuda_build._stale()  # never built
    lib.write_bytes(b"")
    newest = max(os.path.getmtime(s) for s in cuda_build._inputs())
    os.utime(lib, (newest + 10, newest + 10))
    assert not cuda_build._stale()
    assert cuda_build.build() == 0.0  # current: nothing to compile
    header = csrc / "block_stream.cuh"
    os.utime(header, (newest + 20, newest + 20))
    assert cuda_build._stale()


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build._nvcc()
