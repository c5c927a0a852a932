"""The CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs a card: each is
marked ``cuda`` and skips without one (decided in the fixture, not at
import).  On the card, from the root of a checkout (this file imports
neither jax nor hispmv_tpu, so the conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance, kernel against plain version: both fp32 with the same products,
only the order of summation differs (atomics, run to run):
rtol=1e-5, atol=1e-5*max(1, max|y|)."""

import numpy as np
import pytest
import torch

from hispmv_tpu_torch import COOMatrix, SpmvConfig, SpmvHandle
from hispmv_tpu_torch.formats.synth import (
    banded_coo,
    blocked_coo,
    random_coo,
)
from hispmv_tpu_torch.ops.spmv_chunked import (
    chunk_for,
    pack_chunks,
    spmv_chunked,
    spmv_chunked_plain,
)
from hispmv_tpu_torch.ops.spmv_windowed import (
    chunk_for_windowed,
    pack_window_chunks,
    spmv_windowed,
    spmv_windowed_plain,
)
from hispmv_tpu_torch.plan.blocks import build_block_plan
from hispmv_tpu_torch.plan.windows import SEGS, build_window_plan
from hispmv_tpu_torch.utils.errors import error_stats

pytestmark = pytest.mark.cuda

MATRICES = {
    "random": lambda: random_coo(700, 3000, 20_000, seed=11),
    "banded": lambda: banded_coo(1000, 1000, 30_000, seed=12),
    "blocked": lambda: blocked_coo(1024, 1024, 40_000, seed=13),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def assert_close(got, want):
    got, want = got.cpu(), want.cpu()
    atol = 1e-5 * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


def _x2d(ncols, padded, dev, seed=0):
    x = torch.zeros(padded, dtype=torch.float32)
    x[:ncols] = torch.from_numpy(
        np.random.default_rng(seed).standard_normal(ncols).astype(np.float32)
    )
    return x.reshape(-1, 128).to(dev)


def _b1_args(name, bh, chunk, dtype, dev):
    plan = build_block_plan(MATRICES[name](), bh)
    data3d, meta, _ = pack_chunks(plan, chunk or chunk_for(bh))
    data = torch.from_numpy(data3d).to(dev, dtype)
    x2d = _x2d(plan.shape[1], plan.num_col_blocks * 128, dev)
    return (data, torch.from_numpy(meta).to(dev), x2d, plan.num_row_blocks,
            bh, chunk or chunk_for(bh))


def _b7_args(name, bh, chunk, dtype, dev):
    plan = build_window_plan(MATRICES[name](), bh)
    chunk = chunk or chunk_for_windowed(bh)
    data3d, subidx3d, meta, _ = pack_window_chunks(plan, chunk)
    x2d = _x2d(plan.shape[1], plan.num_windows * SEGS * 128, dev)
    return (torch.from_numpy(data3d).to(dev, dtype),
            torch.from_numpy(subidx3d).to(dev), torch.from_numpy(meta).to(dev),
            x2d, plan.num_row_blocks, bh, chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [8, None])
@pytest.mark.parametrize("bh", [1, 8, 64])
@pytest.mark.parametrize("name", list(MATRICES))
def test_b1_kernel_matches_plain(dev, name, bh, chunk, dtype):
    args = _b1_args(name, bh, chunk, dtype, dev)
    before = spmv_chunked.launches
    y = spmv_chunked(*args)
    torch.cuda.synchronize()
    assert spmv_chunked.launches == before + 1
    assert y.device.type == "cuda" and y.dtype == torch.float32
    assert_close(y, spmv_chunked_plain(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [8, None])
@pytest.mark.parametrize("bh", [1, 8, 64])
@pytest.mark.parametrize("name", list(MATRICES))
def test_b7_kernel_matches_plain(dev, name, bh, chunk, dtype):
    args = _b7_args(name, bh, chunk, dtype, dev)
    before = spmv_windowed.launches
    y = spmv_windowed(*args)
    torch.cuda.synchronize()
    assert spmv_windowed.launches == before + 1
    assert_close(y, spmv_windowed_plain(*args))


def test_kernels_reject_what_they_cannot_run(dev):
    data, meta, x2d, nrb, _, chunk = _b1_args("random", 3, 8,
                                              torch.float32, dev)
    with pytest.raises(ValueError, match="block_h"):
        spmv_chunked(data, meta, x2d, nrb, 3, chunk)
    data, meta, x2d, nrb, bh, chunk = _b1_args("random", 8, 8,
                                               torch.float32, dev)
    strided = torch.zeros((x2d.shape[0], 256), device=dev)[:, :128]
    with pytest.raises(ValueError, match="contiguous"):
        spmv_chunked(data, meta, strided, nrb, bh, chunk)
    with pytest.raises(ValueError, match="tensors on"):
        spmv_chunked(data, meta.cpu(), x2d, nrb, bh, chunk)


@pytest.mark.parametrize("fmt,cfg", [
    ("block", SpmvConfig()),
    ("block", SpmvConfig(block_h=64, value_dtype="bfloat16")),
    ("window", SpmvConfig()),
    ("window", SpmvConfig(block_h=64)),
    ("ellx", SpmvConfig()),
    ("ellx", SpmvConfig(block_h=1)),
    ("stream", SpmvConfig()),
    ("dense", SpmvConfig()),
    ("auto", SpmvConfig()),
])
def test_handle_runs_on_card(dev, fmt, cfg):
    coo = MATRICES["random"]()
    h = SpmvHandle(coo, cfg, fmt)
    assert all(t.device.type == "cuda" for t in getattr(h, "_d", {}).values())
    rng = np.random.default_rng(4)
    x = rng.standard_normal(coo.num_cols).astype(np.float32)
    y_in = rng.standard_normal(coo.num_rows).astype(np.float32)
    y = h.run(torch.from_numpy(x).to(dev), torch.from_numpy(y_in).to(dev),
              1.5, -0.5)
    assert y.device.type == "cuda"
    golden = coo
    if cfg.value_dtype == "bfloat16":  # hold it to the rounded payload
        vals = torch.from_numpy(coo.values).to(torch.bfloat16).float()
        golden = COOMatrix(coo.shape, coo.rows, coo.cols, vals.numpy())
    want = 1.5 * golden.matvec(x.astype(np.float64)) - 0.5 * y_in
    assert error_stats(y.cpu().numpy(), want, rtol=1e-3).ok


def test_ellx_overflow_runs_b1_on_card(dev):
    coo = random_coo(4096, 4096, 4096, seed=3)
    # one heavy row so that its row-block spills past k_base
    rows = np.concatenate([coo.rows, np.full(4096, 7, np.int32)])
    cols = np.concatenate([coo.cols, np.arange(4096, dtype=np.int32)])
    vals = np.concatenate([coo.values, np.ones(4096, np.float32)])
    heavy = COOMatrix(coo.shape, rows, cols, vals)
    h = SpmvHandle(heavy, format="ellx")
    assert "odata" in h._d
    before = spmv_chunked.launches
    assert h.verify().ok
    assert spmv_chunked.launches == before + 1
