"""The CUDA kernels against their plain PyTorch versions, on the card, and
the handle's ``run`` and ``linear`` and the sharded executors against the
golden there.

A CUDA kernel has no CPU mode, so every test here needs a card: each is
marked ``cuda`` and skips without one (decided in the fixture, not at
import).  On the card, from the root of a checkout (this file imports
neither jax nor hispmv_tpu, so the conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance, kernel against plain version: both with the same products and
precision (fp32; B9's and B13's tile prefixes fp64), only the order of
summation differs (atomics, run to run; B9's prefix is a block scan on
the card and a sequential cumsum in the plain version): rtol=1e-5,
atol=1e-5*max(1, max|y|).  B11 does no arithmetic and is held
to its plain version and to ``x[perm]`` exactly, B12 and the full gathered
x gather likewise.  Handles are held to the float64 golden at rtol=1e-3."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hispmv_tpu_torch import Accelerator, COOMatrix, SpmvConfig, SpmvHandle
from hispmv_tpu_torch.formats.synth import (
    banded_coo,
    blocked_coo,
    powerlaw_coo,
    random_coo,
    rmat_coo,
    suite_matrix,
)
from hispmv_tpu_torch.ops.permute import (
    pack_permute_plan,
    pack_stage,
    permute_apply,
    permute_stage,
    permute_stage_grid,
    permute_stage_plain,
)
from hispmv_tpu_torch.models import (
    AcceleratorLayerManager,
    ThreeLayerFCModel,
    compare_model_outputs,
)
from hispmv_tpu_torch.dist import (
    ProcessMesh,
    build_sharded_block_plan,
    build_sharded_chunked_plan,
    build_sharded_window_plan,
    init_distributed,
    make_mesh,
    make_process_mesh,
    spmv_sharded,
    spmv_sharded_chunked,
    spmv_sharded_window,
)
from hispmv_tpu_torch.dist.dryrun import dryrun_multichip
from hispmv_tpu_torch.ops.spmv_block import (
    block_batched_grid,
    run_starts,
    spmv_block,
    spmv_block_batched,
    spmv_block_batched_plain,
    spmv_block_stream,
    spmv_block_stream_plain,
)
from hispmv_tpu_torch.ops.spmv_chunked import (
    chunk_for,
    chunked_batched_grid,
    chunked_paneled_grid,
    pack_chunks,
    pack_chunks_paneled,
    pack_chunks_tiled,
    spmv_chunked,
    spmv_chunked_batched,
    spmv_chunked_batched_plain,
    spmv_chunked_paneled,
    spmv_chunked_paneled_plain,
    spmv_chunked_plain,
    chunked_tiled_grid,
    spmv_chunked_tiled,
    spmv_chunked_tiled_plain,
    tiled_sector_mask,
)
from hispmv_tpu_torch.ops.spmv_gathered import (
    gathered_gather_apply,
    pack_gathered,
    s1_gather,
    s1_gather_grid,
    s1_gather_plain,
    spmv_gathered_grid,
    spmv_gathered_tiles,
    spmv_gathered_tiles_plain,
)
from hispmv_tpu_torch.ops.spmv_windowed import (
    chunk_for_windowed,
    pack_window_chunks,
    spmv_windowed,
    spmv_windowed_batched,
    spmv_windowed_batched_plain,
    spmv_windowed_plain,
    windowed_batched_grid,
)
from hispmv_tpu_torch.ops.spmv_routed import (
    MAX_STREAMS,
    pack_stream,
    routed_batched_v,
    routed_table,
    segment_lts,
    spmv_routed_stream,
    spmv_routed_stream_batched,
    spmv_routed_stream_batched_plain,
    spmv_routed_stream_plain,
    spmv_routed_streams,
    spmv_routed_streams_plain,
)
from hispmv_tpu_torch.plan import gathered as G
from hispmv_tpu_torch.profiles import H100, V5E
from hispmv_tpu_torch.plan.blocks import build_block_plan, degree_column_perm
from hispmv_tpu_torch.plan.permute import build_permute_plan
from hispmv_tpu_torch.plan.routed import build_routed_plan
from hispmv_tpu_torch.plan.windows import SEGS, build_window_plan
from hispmv_tpu_torch.plan.split import build_split_plan
from hispmv_tpu_torch.utils.errors import error_stats
from hispmv_tpu_torch.utils.timing import bench_spmv, median_ms

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
@pytest.mark.parametrize("bh", [1, 2, 4, 8, 16, 64])
@pytest.mark.parametrize("name", list(MATRICES))
def test_b1_kernel_matches_plain(dev, name, bh, chunk, dtype):
    """Every row count of a slice (R 1, 2, 4, 8; bh 16 and 64 in row
    slices): at V 1 the flush reduces R values, and bh 1 and 2 take the
    halvings 0 and 1 (the rest by plain additions across the warp)."""
    args = _b1_args(name, bh, chunk, dtype, dev)
    before = spmv_chunked.launches
    y = spmv_chunked(*args)
    torch.cuda.synchronize()
    assert spmv_chunked.launches == before + 1
    assert y.device.type == "cuda" and y.dtype == torch.float32
    assert_close(y, spmv_chunked_plain(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [8, None])
@pytest.mark.parametrize("bh", [1, 2, 4, 8, 16, 64])
@pytest.mark.parametrize("name", list(MATRICES))
def test_b7_kernel_matches_plain(dev, name, bh, chunk, dtype):
    """B1's row counts with the window gather."""
    args = _b7_args(name, bh, chunk, dtype, dev)
    before = spmv_windowed.launches
    y = spmv_windowed(*args)
    torch.cuda.synchronize()
    assert spmv_windowed.launches == before + 1
    assert_close(y, spmv_windowed_plain(*args))


def _b1_run(args, vpt=0):
    before = spmv_chunked.launches
    y = spmv_chunked(*args, vpt=vpt)
    torch.cuda.synchronize()
    assert spmv_chunked.launches == before + 1
    assert y.shape == (args[3], args[4]) and y.dtype == torch.float32
    assert_close(y, spmv_chunked_plain(*args))


def _b7_run(args, vpt=0):
    before = spmv_windowed.launches
    y = spmv_windowed(*args, vpt=vpt)
    torch.cuda.synchronize()
    assert spmv_windowed.launches == before + 1
    assert y.shape == (args[4], args[5]) and y.dtype == torch.float32
    assert_close(y, spmv_windowed_plain(*args))


@pytest.mark.parametrize("vpt", [1, 4, 8])
@pytest.mark.parametrize("bh", [1, 2, 8, 64])
def test_b1_b7_kernels_at_each_v(dev, bh, vpt):
    """V pinned: at V 4 and 8 one vector is live and the others are masked
    (not loaded, not written)."""
    _b1_run(_b1_args("blocked", bh, 8, torch.float32, dev), vpt)
    _b7_run(_b7_args("banded", bh, 8, torch.float32, dev), vpt)


def test_b1_b7_kernels_refuse_other_v(dev):
    b1 = _b1_args("random", 8, 8, torch.float32, dev)
    b7 = _b7_args("random", 8, 8, torch.float32, dev)
    for vpt in (2, 16):
        with pytest.raises(ValueError, match=f"vpt={vpt}"):
            spmv_chunked(*b1, vpt=vpt)
        with pytest.raises(ValueError, match=f"vpt={vpt}"):
            spmv_windowed(*b7, vpt=vpt)


def _heavy_rows_coo():
    """Eight dense rows of 100,000 columns beside a sparse rest: one
    row-block of ~780 blocks at bh 8 spans dozens of chunks of 16 and many
    ranges, and the others flush every few blocks."""
    rng = np.random.default_rng(21)
    n = 100_000
    dense_r = np.repeat(np.arange(8, 16), n)
    dense_c = np.tile(np.arange(n), 8)
    sp = random_coo(4000, n, 2_000, seed=22)
    return COOMatrix((4000, n), np.concatenate([dense_r, sp.rows]),
                     np.concatenate([dense_c, sp.cols]),
                     rng.standard_normal(8 * n + sp.nnz).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b1_kernel_row_block_across_ranges(dev, dtype):
    """B2's case at one vector: the partial open at a range's end goes to
    the row-block of its last block, and the next range adds the rest."""
    plan = build_block_plan(_heavy_rows_coo(), 8)
    data3d, meta, nch = pack_chunks(plan, 16)
    assert np.bincount(plan.block_rows).max() > 10 * 16
    args = (torch.from_numpy(data3d).to(dev, dtype),
            torch.from_numpy(meta).to(dev),
            _x2d(plan.shape[1], plan.num_col_blocks * 128, dev, seed=4),
            plan.num_row_blocks, 8, 16)
    V, slices, ctas = chunked_batched_grid(1, nch, 16, 8)
    assert (V, slices) == (1, 1) and ctas > nch
    for vpt in (0, 4):
        _b1_run(args, vpt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b7_kernel_row_block_across_ranges(dev, dtype):
    """B1's case with the window gather."""
    plan = build_window_plan(_heavy_rows_coo(), 8)
    data3d, subidx3d, meta, nch = pack_window_chunks(plan, 16)
    assert np.bincount(plan.block_rows).max() > 10 * 16
    args = (torch.from_numpy(data3d).to(dev, dtype),
            torch.from_numpy(subidx3d).to(dev),
            torch.from_numpy(meta).to(dev),
            _x2d(plan.shape[1], plan.num_windows * SEGS * 128, dev, seed=4),
            plan.num_row_blocks, 8, 16)
    V, slices, ctas = windowed_batched_grid(1, nch, 16, 8)
    assert (V, slices) == (1, 1) and ctas > nch
    for vpt in (0, 4):
        _b7_run(args, vpt)


@pytest.mark.parametrize("bh", [1, 8, 64])
def test_b1_b7_kernels_on_padding_blocks(dev, bh):
    """Chunks that do not divide the stream leave padding blocks at its end
    (zero payload, the last real row-block, no last flag): they read x row
    0 (window 0, sub-index 0), add zeros and never flush."""
    coo = MATRICES["blocked"]()
    plan = build_block_plan(coo, bh)
    chunk = next(c for c in (40, 48, 56) if plan.num_blocks % c)
    data3d, meta, _ = pack_chunks(plan, chunk)
    assert (meta[:, 0, :].reshape(-1)[plan.num_blocks:]
            == plan.block_rows[-1] * 2).all()
    args = (torch.from_numpy(data3d).to(dev), torch.from_numpy(meta).to(dev),
            _x2d(plan.shape[1], plan.num_col_blocks * 128, dev),
            plan.num_row_blocks, bh, chunk)
    wplan = build_window_plan(coo, bh)
    wchunk = next(c for c in (40, 48, 56) if wplan.num_blocks % c)
    wdata, wsub, wmeta, _ = pack_window_chunks(wplan, wchunk)
    wargs = (torch.from_numpy(wdata).to(dev), torch.from_numpy(wsub).to(dev),
             torch.from_numpy(wmeta).to(dev),
             _x2d(wplan.shape[1], wplan.num_windows * SEGS * 128, dev),
             wplan.num_row_blocks, bh, wchunk)
    for vpt in (0, 1, 4):
        _b1_run(args, vpt)
        _b7_run(wargs, vpt)


def test_b1_b7_launch_shape(dev):
    """At one vector the launcher takes V 1; row slices of 8 rows past bh
    8; a grid of one wave of the V 1 instance's resident CTAs on this
    card's SMs, more CTAs than chunks (the design it replaces ran one a
    chunk), and at least as many as at V 4 (fewer registers a thread)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for grid in (chunked_batched_grid, windowed_batched_grid):
        for bh, slices in ((1, 1), (2, 1), (8, 1), (16, 2), (64, 8)):
            V, s, ctas = grid(1, 200, 128, bh)
            assert (V, s) == (1, slices)
            assert ctas % slices == 0 and ctas >= sms and ctas > 200
            assert ctas >= grid(1, 200, 128, bh, 4)[2]
        # one block a range at most: no more ranges than blocks
        assert grid(1, 1, 8, 8) == (1, 1, 8)


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


# --- routed format: B9 and B11 -------------------------------------------

def _one_row():
    n = 3000  # one row across ~3 windows: every tile has one run (lmax 1)
    return COOMatrix((8, 4096), np.zeros(n), np.arange(n),
                     np.linspace(-1, 1, n).astype(np.float32))


# (matrix, (l1, lmax) of its first stream)
ROUTED = {
    "tiny": (lambda: random_coo(3, 7, 8, seed=6), (1, 1)),
    "one_row": (_one_row, (1, 1)),
    "banded": (lambda: banded_coo(300, 300, 3000, seed=0), (1, 2)),
    "wide": (lambda: random_coo(40, 5000, 3000, seed=4), (5, 2)),
    "tall_l1_5_lmax16": (lambda: random_coo(33000, 1024, 3000, seed=1),
                         (5, 16)),
    "tall_lmax32": (lambda: random_coo(33000, 128, 2000, seed=1), (1, 32)),
}


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("name", list(ROUTED))
def test_b9_kernel_matches_plain(dev, name, bucket):
    coo, (l1, lmax) = ROUTED[name][0](), ROUTED[name][1]
    plan = build_routed_plan(coo)
    assert (plan.streams[0].l1, plan.streams[0].lmax) == (l1, lmax)
    x2d = _x2d(coo.num_cols, plan.num_windows * 1024, dev)
    for s in plan.streams:
        tchunk = 4 if bucket else 1
        for arrays, dims in pack_stream(s, tchunk, bucket=bucket):
            packed = tuple(torch.from_numpy(a).to(dev) for a in arrays)
            before = spmv_routed_streams.launches
            y = spmv_routed_stream(packed, dims, x2d, plan.num_ytiles)
            torch.cuda.synchronize()
            assert spmv_routed_streams.launches == before + 1
            assert_close(y, spmv_routed_stream_plain(packed, dims, x2d,
                                                     plan.num_ytiles))


# streams for B9's tables: lmax 1, 2, 4, 8, 16 and 32, l1 1 to 5
TABLE_MATRICES = dict(
    {n: f for n, (f, _) in ROUTED.items()},
    random900=lambda: random_coo(900, 700, 8_000, seed=9),
    tall_lmax8=lambda: random_coo(20_000, 512, 6_000, seed=2),
    powerlaw4000=lambda: powerlaw_coo(4000, 4000, 60_000, seed=7),
)


def _table_streams(bucket):
    """Every stream of TABLE_MATRICES with its lt, packed one tile a chunk
    (``bucket=False``) or bucketed three tiles a chunk, whose padding tiles
    have lt 0; the first stream's W raised to 64, as the pow-2 bucketing
    does for a span of 33 to 64 windows.  Returns the entries, the x rows
    and the y tiles that cover them all."""
    entries, nwin, nyt = [], 1, 1
    for f in TABLE_MATRICES.values():
        plan = build_routed_plan(f())
        nwin, nyt = max(nwin, plan.num_windows), max(nyt, plan.num_ytiles)
        for s in plan.streams:
            segs = pack_stream(s, 3 if bucket else 1, bucket=bucket)
            for (arrays, dims), lt in zip(segs, segment_lts(s, segs)):
                entries.append((arrays, dims, lt))
    arrays, dims, lt = entries[0]
    entries[0] = (arrays, dims[:2] + (64,) + dims[3:], lt)
    return entries, nwin * 8, nyt


@pytest.mark.parametrize("bucket", [False, True])
def test_b9_table_kernel_matches_plain(dev, bucket):
    """One B9 launch a table of up to MAX_STREAMS streams mixing lmax 1 to
    32, l1 1 to 5 and W up to 64, adding into a y that already holds
    values, against the plain version (every layer run; the kernel runs
    only k < lt)."""
    entries, x_rows, nyt = _table_streams(bucket)
    seen = {d[4] for _, d, _ in entries}
    assert {1, 2, 4, 8, 16, 32} <= seen and max(d[2] for _, d, _ in entries) \
        == 64 and {d[3] for _, d, _ in entries} >= {1, 4, 5}
    if bucket:  # bucketed segments end in padding tiles of lt 0
        assert any((lt == 0).any() for _, _, lt in entries)
    rng = np.random.default_rng(2)
    x2d = torch.from_numpy(rng.standard_normal((x_rows, 128)).astype(
        np.float32)).to(dev)
    y0 = torch.from_numpy(rng.standard_normal((nyt * 8, 128)).astype(
        np.float32)).to(dev)
    order = rng.permutation(len(entries))  # mix the lmax within a table
    for i in range(0, len(entries), MAX_STREAMS):
        part = [entries[j] for j in order[i: i + MAX_STREAMS]]
        table = routed_table([
            (tuple(torch.from_numpy(a).to(dev) for a in arrays), dims,
             torch.from_numpy(lt).to(dev)) for arrays, dims, lt in part],
            nyt)
        before = spmv_routed_streams.launches
        y = spmv_routed_streams(table, x2d, y0.clone())
        torch.cuda.synchronize()
        assert spmv_routed_streams.launches == before + 1
        assert_close(y, spmv_routed_streams_plain(table, x2d, y0.clone()))


def test_b9_one_entry_table_is_the_stream_call(dev):
    """A one-entry table (with lt) gives what ``spmv_routed_stream`` (the
    same kernel on a one-entry table without lt: every layer) gives."""
    entries, x_rows, nyt = _table_streams(False)
    x2d = _x2d(x_rows * 128, x_rows * 128, dev, seed=5)
    for arrays, dims, lt in entries:
        packed = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        table = routed_table([(packed, dims, torch.from_numpy(lt).to(dev))],
                             nyt)
        assert_close(spmv_routed_streams(table, x2d),
                     spmv_routed_stream(packed, dims, x2d, nyt))


def test_b9_small_rows_keep_their_digits(dev):
    """B9's fp64 tile prefix: in random900 with every seventh row scaled to
    1e-3 and the others to 1e3, each small row's run (a difference of two
    prefixes ~1e4 times its sum) errs by under 1e-6 of the sum of its
    terms' magnitudes against the float64 golden."""
    coo = TABLE_MATRICES["random900"]()
    small = coo.rows % 7 == 0
    vals = np.where(small, 1e-3, 1e3).astype(np.float32) * coo.values
    coo = COOMatrix(coo.shape, coo.rows, coo.cols, vals)
    plan = build_routed_plan(coo)
    x2d = _x2d(coo.num_cols, plan.num_windows * 1024, dev, seed=33)
    y = torch.zeros(plan.num_ytiles * 1024, dtype=torch.float64)
    for s in plan.streams:
        ((arrays, dims),) = pack_stream(s, tchunk=1, bucket=False)
        packed = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        y += spmv_routed_stream(packed, dims, x2d,
                                plan.num_ytiles).cpu().reshape(-1)
    x = x2d.cpu().numpy().reshape(-1)[:coo.num_cols].astype(np.float64)
    got = y.numpy()[:coo.num_rows]
    np.add.at(got, plan.residual_rows,
              plan.residual_vals.astype(np.float64) * x[plan.residual_cols])
    terms = np.zeros(coo.num_rows)
    np.add.at(terms, coo.rows, np.abs(vals.astype(np.float64) * x[coo.cols]))
    rows = np.unique(coo.rows[small])
    rel = np.abs(got - coo.matvec(x))[rows] / terms[rows]
    assert rel.max() < 1e-6


def test_b9_table_rejects_unaligned_boundary_words(dev):
    entries, _, nyt = _table_streams(False)
    arrays, dims, lt = next(e for e in entries if e[1][4] > 1)
    packed = [torch.from_numpy(a).to(dev) for a in arrays]
    flat = torch.zeros(packed[3].numel() + 1, dtype=torch.int32, device=dev)
    packed[3] = flat[1:].view(packed[3].shape)
    packed[3].copy_(torch.from_numpy(arrays[3]))
    with pytest.raises(ValueError, match="aligned"):
        routed_table([(tuple(packed), dims, torch.from_numpy(lt).to(dev))],
                     nyt)


@pytest.mark.parametrize("n", [700, 9000, 400_000])
def test_b11_kernel_equals_plain_and_gather(dev, n):
    perm = np.random.default_rng(n).permutation(n)
    plan = build_permute_plan(perm)
    rng = np.random.default_rng(1)
    for s in (plan.s1, plan.s2, plan.s3):
        for bucket in (True, False):
            (route,), dims = pack_stage(s, bucket=bucket)
            arrays = (torch.from_numpy(route).to(dev),)
            a = torch.from_numpy(rng.standard_normal(
                (dims[0] * dims[1] * 8, 128)).astype(np.float32)).to(dev)
            before = permute_stage.launches
            got = permute_stage(arrays, dims, a)
            torch.cuda.synchronize()
            assert permute_stage.launches == before + 1
            assert torch.equal(got, permute_stage_plain(arrays, dims, a))
    packed = pack_permute_plan(plan, dev)
    x = rng.standard_normal(n).astype(np.float32)
    y = permute_apply(packed, packed["arrays"], torch.from_numpy(x).to(dev))
    assert np.array_equal(y.cpu().numpy(), x[perm])


def _misaligned(t):
    """A copy of ``t`` whose storage starts one element past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def _stage_routes(nwin, real):
    """i32 [nwin, 8, 128] route words: windows of the stages of a real
    permutation plan, repeated to nwin, or random 13-bit words."""
    rng = np.random.default_rng(nwin)
    if not real:
        return rng.integers(0, 1 << 13, (nwin, 8, 128), dtype=np.int32)
    plan = build_permute_plan(rng.permutation(400_000))
    windows = np.concatenate([s.route for s in (plan.s1, plan.s2, plan.s3)])
    return np.resize(windows, (nwin, 8, 128)).astype(np.int32)


B11_WINDOWS = [1, 3, 390, 1024, 4097]


@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("nwin", B11_WINDOWS)
def test_b11_kernel_equals_plain_at_window_counts(dev, nwin, real):
    route = torch.from_numpy(_stage_routes(nwin, real)).to(dev)
    arrays, dims = (route.reshape(nwin, 8, 128),), (nwin, 1)
    a = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (nwin * 8, 128)).astype(np.float32)).to(dev)
    before = permute_stage.launches
    got = permute_stage(arrays, dims, a)
    torch.cuda.synchronize()
    assert permute_stage.launches == before + 1
    assert torch.equal(got, permute_stage_plain(arrays, dims, a))


@pytest.mark.parametrize("windows", [2, 3])
def test_b11_windows_a_cta_variants_are_exact(dev, windows, tmp_path):
    """permute.cu built alone at 2 and 3 windows a CTA: every window count,
    whether a multiple of the windows a CTA takes or not, is exact."""
    import ctypes

    from hispmv_tpu_torch.ops import cuda_build

    lib = cuda_build.build_alone("permute.cu",
                                 {"HISPMV_PERMUTE_WINDOWS": windows},
                                 str(tmp_path / "libpermute.so"))
    ptr = ctypes.c_void_p
    lib.hispmv_permute_stage.argtypes = [ptr, ptr, ptr, ctypes.c_int, ptr]
    lib.hispmv_permute_stage_grid.argtypes = [ctypes.c_int, ptr]
    for nwin in B11_WINDOWS:
        route = torch.from_numpy(_stage_routes(nwin, True)).to(dev)
        a = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (nwin * 8, 128)).astype(np.float32)).to(dev)
        out = torch.empty_like(a)
        assert lib.hispmv_permute_stage(
            route.data_ptr(), a.data_ptr(), out.data_ptr(), nwin,
            torch.cuda.current_stream().cuda_stream) == 0
        shape = (ctypes.c_int * 3)()
        assert lib.hispmv_permute_stage_grid(nwin, ctypes.addressof(shape)) == 0
        assert tuple(shape) == (windows, 256 * windows, -(-nwin // windows))
        torch.cuda.synchronize()
        assert torch.equal(out, permute_stage_plain(
            (route.reshape(nwin, 8, 128),), (nwin, 1), a))


@pytest.mark.parametrize("nwin", B11_WINDOWS)
def test_b11_launch_shape(dev, nwin):
    w, threads, ctas = permute_stage_grid(nwin)
    assert threads == 256 * w and ctas == -(-nwin // w)


def test_b11_kernel_refuses_unaligned_tensors(dev):
    nwin = 3
    route = torch.from_numpy(_stage_routes(nwin, True)).to(dev)
    a = torch.ones((nwin * 8, 128), device=dev)
    good = ((route.reshape(nwin, 8, 128),), (nwin, 1), a)
    permute_stage(*good)
    with pytest.raises(ValueError, match="aligned"):
        permute_stage((_misaligned(good[0][0]),), good[1], a)
    with pytest.raises(ValueError, match="aligned"):
        permute_stage(good[0], good[1], _misaligned(a))


def test_b11_permute_apply_takes_unaligned_views(dev):
    """permute_apply copies a view that is not 16-byte aligned (a batch
    row) before B11 reads it."""
    n = 1 << 20  # one panel's worth: S1 reads x without padding it
    perm = np.random.default_rng(3).permutation(n)
    packed = pack_permute_plan(build_permute_plan(perm), dev)
    x = np.random.default_rng(4).standard_normal(n + 1).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)[1:]
    assert xd.data_ptr() % 16
    y = permute_apply(packed, packed["arrays"], xd)
    assert np.array_equal(y.cpu().numpy(), x[1:][perm])


def _stretched_rmat():
    """An R-MAT scattered along the diagonal of a 1.1M x 1.1M index space:
    fails routed_vmem_ok under V5E, so a V5E handle builds the banded cell
    grid."""
    coo = rmat_coo(2048, 2048, 12_000, seed=23)
    rows = coo.rows.astype(np.int64) + (coo.cols.astype(np.int64) % 7) \
        * 150_000
    cols = coo.cols.astype(np.int64) + (coo.rows.astype(np.int64) % 5) \
        * 200_000
    return COOMatrix((1_100_000, 1_100_000), rows, cols, coo.values)


@pytest.mark.parametrize("rank_sort", [False, True])
@pytest.mark.parametrize("name", ["powerlaw", "banded_grid", "residual"])
def test_routed_handle_runs_on_card(dev, name, rank_sort):
    if name == "powerlaw":
        coo = powerlaw_coo(4000, 4000, 60_000, seed=7)
    elif name == "banded_grid":
        coo = _stretched_rmat()
    else:  # one nnz per macro cell: everything demotes to the residual
        rng = np.random.default_rng(54)
        cols = np.arange(60) * 16384 + rng.integers(0, 1024, 60)
        coo = COOMatrix((64, int(cols.max()) + 1), rng.integers(0, 64, 60),
                        cols, rng.standard_normal(60).astype(np.float32))
    # V5E bands the grid case (the card's H100 profile never bands)
    h = SpmvHandle(coo, SpmvConfig(rank_sort=rank_sort), "routed",
                   profile=V5E if name == "banded_grid" else None)
    assert h.format == "routed"
    assert all(t.device.type == "cuda" for t in h._d.values())
    rng = np.random.default_rng(4)
    x = rng.standard_normal(coo.num_cols).astype(np.float32)
    y_in = rng.standard_normal(coo.num_rows).astype(np.float32)
    b9, b11 = spmv_routed_streams.launches, permute_stage.launches
    y = h.run(torch.from_numpy(x).to(dev), torch.from_numpy(y_in).to(dev),
              1.5, -0.5)
    torch.cuda.synchronize()
    want = 1.5 * coo.matvec(x.astype(np.float64)) - 0.5 * y_in
    assert error_stats(y.cpu().numpy(), want, rtol=1e-3).ok
    # one B9 launch a routed part with tiles: the plan, or each banded cell
    metas = ([c["meta"] for c in h._routed_meta["cells"]]
             if name == "banded_grid" else [h._routed_meta])
    assert spmv_routed_streams.launches - b9 == sum(
        m["table"] is not None for m in metas)
    assert (permute_stage.launches > b11) == rank_sort
    assert h.verify().ok


# --- batched linear(): B2, B8 and B10 ---------------------------------------


def _batch(n, cols, dev, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, cols)).astype(np.float32)).to(dev)


def _b2_run(args, vpt=0):
    before = spmv_chunked_batched.launches
    y = spmv_chunked_batched(*args, vpt=vpt)
    torch.cuda.synchronize()
    assert spmv_chunked_batched.launches == before + 1
    data, _, xb, nrb, bh, _ = args
    assert y.shape == (nrb, bh, xb.shape[2]) and y.dtype == torch.float32
    assert_close(y, spmv_chunked_batched_plain(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 4, 7, 8, 9, 64])
@pytest.mark.parametrize("bh", [1, 8, 16, 64])
@pytest.mark.parametrize("name", ["random", "blocked"])
def test_b2_kernel_matches_plain(dev, name, bh, B, dtype):
    """Row slices (bh 16, 64), masked vector groups (B 1, 7, 9), 16-byte
    and 4-byte x loads; V pinned to 4 and 8 on the f32 random cases."""
    data, meta, x2d, nrb, bh, chunk = _b1_args(name, bh, None, dtype, dev)
    xb = _batch(B, x2d.numel(), dev, seed=B).T.reshape(-1, 128, B)
    args = (data, meta, xb.contiguous(), nrb, bh, chunk)
    pinned = (4, 8) if name == "random" and dtype == torch.float32 else ()
    for vpt in (0,) + pinned:
        _b2_run(args, vpt)


def test_b2_kernel_batch_past_one_panel(dev):
    """130 vectors: 17 groups of V 8 in one launch, the last masked."""
    data, meta, x2d, nrb, bh, chunk = _b1_args("banded", 8, 8,
                                               torch.float32, dev)
    xb = _batch(130, x2d.numel(), dev, seed=2).T.reshape(-1, 128, 130)
    args = (data, meta, xb.contiguous(), nrb, bh, chunk)
    assert_close(spmv_chunked_batched(*args),
                 spmv_chunked_batched_plain(*args))


@pytest.mark.parametrize("B", [4, 8])
def test_b2_kernel_unaligned_x(dev, B):
    """An xb that is contiguous but not 16-byte aligned takes the 4-byte
    loads at a batch that is a multiple of 4."""
    data, meta, x2d, nrb, bh, chunk = _b1_args("blocked", 8, None,
                                               torch.float32, dev)
    flat = torch.zeros(x2d.numel() * B + 1, device=dev)
    xb = flat[1:].view(-1, 128, B)
    xb.copy_(_batch(B, x2d.numel(), dev, seed=3).T.reshape(-1, 128, B))
    assert xb.data_ptr() % 16 != 0 and xb.is_contiguous()
    for vpt in (4, 8):
        _b2_run((data, meta, xb, nrb, bh, chunk), vpt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b2_kernel_row_block_across_ranges(dev, dtype):
    """Eight dense rows of 100,000 columns beside a sparse rest: one
    row-block of 782 blocks spans dozens of chunks of 16 and many ranges
    (as on trans5's ELLX overflow), and the others flush every few
    blocks."""
    plan = build_block_plan(_heavy_rows_coo(), 8)
    data3d, meta, nch = pack_chunks(plan, 16)
    assert np.bincount(plan.block_rows).max() > 10 * 16
    xb = _batch(8, plan.num_col_blocks * 128, dev, seed=4).T.reshape(
        -1, 128, 8)
    args = (torch.from_numpy(data3d).to(dev, dtype),
            torch.from_numpy(meta).to(dev), xb.contiguous(),
            plan.num_row_blocks, 8, 16)
    assert chunked_batched_grid(8, nch, 16, 8)[2] > nch
    for vpt in (0, 4):
        _b2_run(args, vpt)


def test_b2_launcher_picks_v(dev):
    """V 1 at B 1 (B1's launch), 4 at B 2-4 and when V 8 would leave some
    of the card's SMs idle, else 8; vpt names 1, 4 or 8 and nothing else.
    Row slices of 8 rows past bh 8, and a grid of at most one wave that
    covers every slice and vector group."""
    grid = chunked_batched_grid
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert [grid(B, 100, 256, 8)[0] for B in (1, 4, 5, 64)] == [1, 4, 8, 8]
    assert grid(8, 1, sms - 1, 1)[0] == 4  # sms - 1 CTAs at V 8
    assert grid(8, 1, sms, 1)[0] == 8
    assert [grid(8, 1, 8, 64, v)[0] for v in (1, 4, 8)] == [1, 4, 8]
    assert [grid(8, 1, 8, bh)[1] for bh in (1, 8, 16, 64)] == [1, 1, 2, 8]
    V, slices, ctas = grid(64, 100, 256, 64)
    assert ctas % (slices * 64 // V) == 0
    with pytest.raises(RuntimeError, match="launch failed"):
        grid(8, 1, 8, 8, 16)


def _b8_run(args, vpt=0):
    before = spmv_windowed_batched.launches
    y = spmv_windowed_batched(*args, vpt=vpt)
    torch.cuda.synchronize()
    assert spmv_windowed_batched.launches == before + 1
    _, _, _, xt, nrb, bh, _ = args
    assert y.shape == (nrb, bh, xt.shape[2]) and y.dtype == torch.float32
    assert_close(y, spmv_windowed_batched_plain(*args))


def _b8_args(name, bh, dtype, B, dev, seed=None):
    """B7's arrays and a batch of B vectors, x vector-minor [nwin*8, 128,
    B]."""
    data, subidx, meta, x2d, nrb, bh, chunk = _b7_args(name, bh, None, dtype,
                                                       dev)
    xt = _vector_minor(_batch(B, x2d.numel(), dev,
                              seed=B if seed is None else seed))
    return (data, subidx, meta, xt, nrb, bh, chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 4, 7, 8, 9, 64])
@pytest.mark.parametrize("bh", [1, 8, 16, 64])
@pytest.mark.parametrize("name", ["random", "banded"])
def test_b8_kernel_matches_plain(dev, name, bh, B, dtype):
    """B2's cases with the window gather: row slices (bh 16, 64, each
    re-reading subidx), masked vector groups (B 1, 7, 9), 16-byte and
    4-byte x loads; V pinned to 4 and 8 on the f32 random cases."""
    args = _b8_args(name, bh, dtype, B, dev)
    pinned = (4, 8) if name == "random" and dtype == torch.float32 else ()
    for vpt in (0,) + pinned:
        _b8_run(args, vpt)


def test_b8_kernel_batch_past_one_panel(dev):
    """130 vectors: 17 groups of V 8 in one launch, the last masked (the
    staged design ran panels of 64)."""
    _b8_run(_b8_args("banded", 8, torch.float32, 130, dev, seed=2))


@pytest.mark.parametrize("B", [4, 8])
def test_b8_kernel_unaligned_x(dev, B):
    """An xt that is contiguous but not 16-byte aligned takes the 4-byte
    loads at a batch that is a multiple of 4."""
    data, subidx, meta, xt0, nrb, bh, chunk = _b8_args("banded", 8,
                                                       torch.float32, B, dev)
    flat = torch.zeros(xt0.numel() + 1, device=dev)
    xt = flat[1:].view(xt0.shape)
    xt.copy_(xt0)
    assert xt.data_ptr() % 16 != 0 and xt.is_contiguous()
    for vpt in (4, 8):
        _b8_run((data, subidx, meta, xt, nrb, bh, chunk), vpt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b8_kernel_row_block_across_ranges(dev, dtype):
    """Eight dense rows of 100,000 columns beside a sparse rest: one
    row-block of ~780 window blocks spans dozens of chunks of 16 and many
    ranges, and the others flush every few blocks."""
    plan = build_window_plan(_heavy_rows_coo(), 8)
    data3d, subidx3d, meta, nch = pack_window_chunks(plan, 16)
    assert np.bincount(plan.block_rows).max() > 10 * 16
    xt = _vector_minor(_batch(8, plan.num_windows * SEGS * 128, dev,
                              seed=4))
    args = (torch.from_numpy(data3d).to(dev, dtype),
            torch.from_numpy(subidx3d).to(dev),
            torch.from_numpy(meta).to(dev), xt, plan.num_row_blocks, 8, 16)
    assert windowed_batched_grid(8, nch, 16, 8)[2] > nch
    for vpt in (0, 4):
        _b8_run(args, vpt)


def test_b8_launcher_picks_v(dev):
    """B2's launcher rule: V 1 at B 1 (B7's launch), 4 at B 2-4 and when V
    8 would leave some of the card's SMs idle, else 8; vpt names 1, 4 or 8
    and nothing else; row slices of 8 rows past bh 8, and a grid of at most
    one wave that covers every slice and vector group."""
    grid = windowed_batched_grid
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert [grid(B, 100, 256, 8)[0] for B in (1, 4, 5, 64)] == [1, 4, 8, 8]
    assert grid(8, 1, sms - 1, 1)[0] == 4  # sms - 1 CTAs at V 8
    assert grid(8, 1, sms, 1)[0] == 8
    assert [grid(8, 1, 8, 64, v)[0] for v in (1, 4, 8)] == [1, 4, 8]
    assert [grid(8, 1, 8, bh)[1] for bh in (1, 8, 16, 64)] == [1, 1, 2, 8]
    V, slices, ctas = grid(64, 100, 256, 64)
    assert ctas % (slices * 64 // V) == 0
    assert grid(130, 100, 256, 8)[2] % 17 == 0  # 17 vector groups of 8
    with pytest.raises(RuntimeError, match="launch failed"):
        grid(8, 1, 8, 8, 16)


def _b10_stream_cases(name):
    """The streams of ROUTED[name] packed three tiles a chunk, so a stream
    whose tile count is not a multiple of 3 ends in padded tiles."""
    coo = ROUTED[name][0]()
    plan = build_routed_plan(coo)
    segs = [seg for s in plan.streams
            for seg in pack_stream(s, 3, bucket=False)]
    padded = any(d[0] * d[1] > s.num_tiles
                 for s, (_, d) in zip(plan.streams, segs))
    return plan, segs, padded


def _vector_minor(xb):
    """[B, C] -> xt [C/128, 128, B], B10's x."""
    return xb.T.reshape(-1, 128, xb.shape[0]).contiguous()


@pytest.mark.parametrize("vpt", [0, 4, 8])
@pytest.mark.parametrize("B", [1, 3, 8, 9, 64])
@pytest.mark.parametrize("name", list(ROUTED))
def test_b10_kernel_matches_plain(dev, name, B, vpt):
    """Every V against the plain version: B below, at and past V (a masked
    last vector group), 4-byte x loads at odd B, lmax 1 to 32, padded last
    tiles."""
    plan, segs, _ = _b10_stream_cases(name)
    C = plan.num_windows * 1024
    xb = _batch(B, C, dev, seed=B)
    xt = _vector_minor(xb)
    for packed_np, dims in segs:
        packed = tuple(torch.from_numpy(a).to(dev) for a in packed_np)
        before = spmv_routed_stream_batched.launches
        y = spmv_routed_stream_batched(packed, dims, xt, plan.num_ytiles,
                                       vpt=vpt)
        torch.cuda.synchronize()
        assert spmv_routed_stream_batched.launches == before + 1
        assert y.shape == (B * plan.num_ytiles * 8, 128)
        assert_close(y, spmv_routed_stream_batched_plain(
            packed, dims, xt, plan.num_ytiles))
        # vector b of the batch is B9 on vector b
        y9 = spmv_routed_stream(packed, dims, xb[-1].reshape(-1, 128),
                                plan.num_ytiles)
        assert_close(y.reshape(B, -1)[-1], y9.reshape(-1))


def test_b10_launcher_picks_v(dev):
    """V 8, or 4 at B <= 4 and when V 8 would leave SMs (132) idle; vpt
    names 4 or 8 and nothing else."""
    assert [routed_batched_v(B, 1000) for B in (1, 4, 5, 64)] == [4, 4, 8, 8]
    assert routed_batched_v(64, 16) == 4  # 128 CTAs at V 8
    assert routed_batched_v(64, 17) == 8  # 136
    assert [routed_batched_v(64, 4, v) for v in (4, 8, 16)] == [4, 8, 0]


def test_b10_streams_end_in_padded_tiles():
    """The cases above include streams with padded last tiles, lmax 1 and
    lmax past one group of four layers."""
    seen = set()
    for name in ROUTED:
        plan, segs, padded = _b10_stream_cases(name)
        seen |= {("padded", padded)} | {("lmax>4", d[4] > 4) for _, d in segs}
        seen |= {("lmax1", d[4] == 1) for _, d in segs}
    assert {("padded", True), ("lmax>4", True), ("lmax1", True)} <= seen


@pytest.mark.parametrize("B", [4, 8])
def test_b10_kernel_unaligned_x(dev, B):
    """An xt that is contiguous but not 16-byte aligned takes the 4-byte
    loads at a batch that is a multiple of 4."""
    plan, segs, _ = _b10_stream_cases("tall_l1_5_lmax16")
    C = plan.num_windows * 1024
    flat = torch.zeros(C * B + 1, device=dev)
    xt = flat[1:].view(C // 128, 128, B)
    xt.copy_(_vector_minor(_batch(B, C, dev, seed=3)))
    assert xt.data_ptr() % 16 != 0 and xt.is_contiguous()
    for packed_np, dims in segs:
        packed = tuple(torch.from_numpy(a).to(dev) for a in packed_np)
        assert_close(spmv_routed_stream_batched(packed, dims, xt,
                                                plan.num_ytiles),
                     spmv_routed_stream_batched_plain(packed, dims, xt,
                                                      plan.num_ytiles))


def _golden_linear(coo, xb, bias, value_dtype="float32"):
    vals = coo.values
    if value_dtype == "bfloat16":  # hold it to the rounded payload
        vals = torch.from_numpy(vals).to(torch.bfloat16).float().numpy()
    a = COOMatrix(coo.shape, coo.rows, coo.cols, vals).to_scipy()
    return (a @ xb.astype(np.float64).T).T + bias


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
    ("routed", SpmvConfig()),
    ("routed", SpmvConfig(rank_sort=True)),
])
@pytest.mark.parametrize("B", [1, 64])
def test_linear_on_card(dev, fmt, cfg, B):
    coo = MATRICES["random"]()
    h = SpmvHandle(coo, cfg, fmt)
    xb = np.random.default_rng(B).standard_normal(
        (B, coo.num_cols)).astype(np.float32)
    bias = np.linspace(-1, 1, coo.num_rows).astype(np.float32)
    y = h.linear(torch.from_numpy(xb).to(dev), torch.from_numpy(bias).to(dev))
    assert y.device.type == "cuda" and y.shape == (B, coo.num_rows)
    # B6 reads the plan's f32 values, as the JAX handle uploads them; B2
    # and the other formats read the payload in the handle's value dtype
    dtype = cfg.value_dtype
    if h.format == "block" and not h._block_uses_b2(B):
        dtype = "float32"
    want = _golden_linear(coo, xb, bias, dtype)
    assert error_stats(y.cpu().numpy(), want, rtol=1e-3).ok


def test_ellx_overflow_linear_runs_b2_on_card(dev):
    coo = random_coo(4096, 4096, 4096, seed=3)
    rows = np.concatenate([coo.rows, np.full(4096, 7, np.int32)])
    cols = np.concatenate([coo.cols, np.arange(4096, dtype=np.int32)])
    vals = np.concatenate([coo.values, np.ones(4096, np.float32)])
    heavy = COOMatrix(coo.shape, rows, cols, vals)
    h = SpmvHandle(heavy, format="ellx")
    assert "odata" in h._d
    xb = np.random.default_rng(9).standard_normal((9, 4096)).astype(
        np.float32)
    before = spmv_chunked_batched.launches
    y = h.linear(torch.from_numpy(xb).to(dev))
    torch.cuda.synchronize()
    assert spmv_chunked_batched.launches == before + 1
    assert error_stats(y.cpu().numpy(),
                       _golden_linear(heavy, xb, 0.0), rtol=1e-3).ok


@pytest.mark.parametrize("B", [3, 16, 64])
def test_routed_linear_one_b10_launch_per_stream(dev, B):
    coo = powerlaw_coo(4000, 4000, 60_000, seed=7)
    h = SpmvHandle(coo, format="routed")
    xb = np.random.default_rng(5).standard_normal((B, 4000)).astype(
        np.float32)
    before = spmv_routed_stream_batched.launches
    y = h.linear(torch.from_numpy(xb).to(dev))
    torch.cuda.synchronize()
    assert (spmv_routed_stream_batched.launches - before
            == len(h.plan.streams))
    assert error_stats(y.cpu().numpy(), _golden_linear(coo, xb, 0.0),
                       rtol=1e-3).ok


def test_model_swap_on_card(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    model = ThreeLayerFCModel(512, hidden=1024, out=128, density=0.1,
                              generator=gen, device=dev)
    accel = AcceleratorLayerManager(Accelerator()).replace_layers(model)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (16, 512)).astype(np.float32)).to(dev)
    with torch.no_grad():
        want = model(x)
    got = accel(x)
    assert got.device.type == "cuda"
    assert compare_model_outputs(got, want).ok


# --- the per-block and x-paneled streams: B5, B6 and B3 ---------------------


def _b5_arrays(name, bh, dev):
    plan = build_block_plan(MATRICES[name](), bh)
    arrays = tuple(torch.from_numpy(a).to(dev) for a in (
        plan.data, plan.block_rows, plan.block_cols, plan.block_firsts,
        plan.block_lasts))
    return plan, arrays, run_starts(plan.block_firsts).to(dev)


@pytest.mark.parametrize("bh", [1, 8, 64])
@pytest.mark.parametrize("name", list(MATRICES))
def test_b5_kernel_matches_plain(dev, name, bh):
    plan, arrays, starts = _b5_arrays(name, bh, dev)
    xb = _x2d(plan.shape[1], plan.num_col_blocks * 128, dev).reshape(
        -1, 1, 128)
    before = spmv_block_stream.launches
    y = spmv_block_stream(*arrays, xb, plan.num_row_blocks, starts=starts)
    torch.cuda.synchronize()
    assert spmv_block_stream.launches == before + 1
    assert y.shape == (plan.num_row_blocks, 1, bh)
    want = spmv_block_stream_plain(*arrays, xb, plan.num_row_blocks)
    assert_close(y, want)
    # no atomics: the same inputs give the same bits
    assert torch.equal(y, spmv_block_stream(*arrays, xb,
                                            plan.num_row_blocks))


@pytest.mark.parametrize("D", [3, 8])
def test_b5_kernel_on_sharded_streams(dev, D):
    """Padding blocks after a shard's last run, and (D 8 on a 16-row
    matrix) empty shards: one zero block storing y[0] = 0."""
    for coo in (MATRICES["random"](), random_coo(16, 200, 100, seed=5)):
        sp = build_sharded_block_plan(coo, D)
        xb = _x2d(coo.num_cols, sp.num_col_blocks * 128, dev).reshape(
            -1, 1, 128)
        for d in range(D):
            arrays = tuple(torch.from_numpy(a[d]).to(dev) for a in (
                sp.data, sp.block_rows, sp.block_cols, sp.block_firsts,
                sp.block_lasts))
            y = spmv_block_stream(*arrays, xb, sp.nrb_max)
            assert_close(y, spmv_block_stream_plain(*arrays, xb, sp.nrb_max))


# B6 against its plain version: the kernel widens the fp32 inputs exactly
# and sums in fp64 (DMMA), the plain version sums fp32 products in fp32, so
# the two differ by the plain version's rounding: assert_close's rtol 1e-5
# and atol 1e-5*max(1, max|y|).  The kernel's sum has a fixed order: a
# second call gives the same bits.


def _b6_call(arrays, xb, nrb, starts=None):
    before = spmv_block_batched.launches
    y = spmv_block_batched(*arrays, xb, nrb, starts=starts)
    torch.cuda.synchronize()
    assert spmv_block_batched.launches == before + 1
    assert y.shape == (nrb, arrays[0].shape[1], xb.shape[2])
    assert_close(y, spmv_block_batched_plain(*arrays, xb, nrb))
    assert torch.equal(y, spmv_block_batched(*arrays, xb, nrb, starts=starts))
    return y


def _b6_x(ncb, B, dev, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (ncb, 128, B)).astype(np.float32)).to(dev)


@pytest.mark.parametrize("B", [1, 7, 16, 64, 130])
@pytest.mark.parametrize("bh", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("name", ["random", "blocked"])
def test_b6_kernel_matches_plain(dev, name, bh, B):
    plan, arrays, starts = _b5_arrays(name, bh, dev)
    xb = _batch(B, plan.num_col_blocks * 128, dev, seed=B).T.reshape(
        -1, 128, B).contiguous()
    _b6_call(arrays, xb, plan.num_row_blocks, starts)


@pytest.mark.parametrize("B", [7, 64])
@pytest.mark.parametrize("D", [3, 8])
def test_b6_kernel_on_sharded_streams(dev, D, B):
    """Padding blocks after a shard's last run, and (D 8 on a 16-row
    matrix) empty shards: one zero block storing y[0] = 0."""
    for coo in (MATRICES["random"](), random_coo(16, 200, 100, seed=5)):
        sp = build_sharded_block_plan(coo, D)
        xb = _b6_x(sp.num_col_blocks, B, dev, seed=D)
        for d in range(D):
            arrays = tuple(torch.from_numpy(a[d]).to(dev) for a in (
                sp.data, sp.block_rows, sp.block_cols, sp.block_firsts,
                sp.block_lasts))
            _b6_call(arrays, xb, sp.nrb_max)


@pytest.mark.parametrize("B", [1, 64])
def test_b6_kernel_run_without_last_flag_stores_nothing(dev, B):
    plan, arrays, _ = _b5_arrays("banded", 8, dev)
    lasts = arrays[4].clone()
    lasts[int(torch.nonzero(lasts)[0])] = 0
    arrays = arrays[:4] + (lasts,)
    y = _b6_call(arrays, _b6_x(plan.num_col_blocks, B, dev),
                 plan.num_row_blocks)
    assert not y[0].any() and y[1:].any()


@pytest.mark.parametrize("B", [16, 130])
def test_b6_kernel_one_row_block_of_hundreds_of_blocks(dev, B):
    coo = random_coo(20, 400 * 128, 60_000, seed=17)
    plan = build_block_plan(coo, 8)
    runs = np.diff(np.append(np.flatnonzero(plan.block_firsts),
                             plan.num_blocks))
    assert runs.max() >= 300
    arrays = tuple(torch.from_numpy(a).to(dev) for a in (
        plan.data, plan.block_rows, plan.block_cols, plan.block_firsts,
        plan.block_lasts))
    _b6_call(arrays, _b6_x(plan.num_col_blocks, B, dev), plan.num_row_blocks)


def test_b6_kernel_skips_padding_between_runs(dev):
    """Blocks after a run's last flag and before the next first flag (with
    a nonzero payload here) are never read."""
    plan = build_block_plan(MATRICES["banded"](), 8)
    ends = np.flatnonzero(plan.block_lasts)
    pad = np.ones((1, 8, 128), np.float32)
    data, rows, cols, firsts, lasts = [], [], [], [], []
    prev = 0
    for e in ends:
        data += [plan.data[prev:e + 1], pad]
        rows += [plan.block_rows[prev:e + 1], plan.block_rows[e:e + 1]]
        cols += [plan.block_cols[prev:e + 1], np.zeros(1, np.int32)]
        firsts += [plan.block_firsts[prev:e + 1], np.zeros(1, np.int32)]
        lasts += [plan.block_lasts[prev:e + 1], np.zeros(1, np.int32)]
        prev = e + 1
    arrays = tuple(torch.from_numpy(np.concatenate(a)).to(dev)
                   for a in (data, rows, cols, firsts, lasts))
    assert arrays[0].shape[0] == plan.num_blocks + len(ends)
    xb = _b6_x(plan.num_col_blocks, 64, dev)
    y = _b6_call(arrays, xb, plan.num_row_blocks)
    _, plain_arrays, _ = _b5_arrays("banded", 8, dev)
    assert_close(y, spmv_block_batched_plain(*plain_arrays, xb,
                                             plan.num_row_blocks))


def test_b6_launch_shape(dev):
    """One warp per (run, 8-row slice, 16-vector group), at most four
    groups (64 vectors) a CTA, the batch's panels of 64 on grid z."""
    for bh, slices in ((1, 1), (8, 1), (16, 2), (64, 8)):
        assert block_batched_grid(100, bh, 64) == (4, slices, 100 * slices)
    assert block_batched_grid(100, 8, 1) == (1, 1, 100)
    assert block_batched_grid(100, 8, 20) == (2, 1, 100)
    assert block_batched_grid(100, 8, 130) == (4, 1, 300)
    for bad in ((0, 8, 64), (100, 3, 64), (100, 8, 0)):
        with pytest.raises(RuntimeError, match="block_batched_grid"):
            block_batched_grid(*bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh", [1, 2, 4, 8, 16, 64])
@pytest.mark.parametrize("name", ["random", "blocked"])
def test_b3_kernel_matches_plain(dev, name, bh, dtype):
    plan = build_block_plan(MATRICES[name](), bh)
    panel_ncb = 4  # random: 6 panels, blocked: 2
    data3d, meta, panels, _ = pack_chunks_paneled(plan, 8, panel_ncb)
    npanels = -(-plan.num_col_blocks // panel_ncb)
    args = (torch.from_numpy(data3d).to(dev, dtype),
            torch.from_numpy(meta).to(dev), torch.from_numpy(panels).to(dev),
            _x2d(plan.shape[1], npanels * panel_ncb * 128, dev),
            plan.num_row_blocks, bh, 8, panel_ncb)
    assert len(np.unique(panels)) > 1
    before = spmv_chunked_paneled.launches
    y = spmv_chunked_paneled(*args)
    torch.cuda.synchronize()
    assert spmv_chunked_paneled.launches == before + 1
    want = spmv_chunked_paneled_plain(*args)
    assert_close(y, want)
    out = torch.ones_like(y)
    assert spmv_chunked_paneled(*args, out=out) is out
    assert_close(out, want + 1.0)


def _b3_run(plan, data3d, meta, panels, panel_ncb, chunk, dtype, dev):
    npanels = -(-plan.num_col_blocks // panel_ncb)
    args = (torch.from_numpy(data3d).to(dev, dtype),
            torch.from_numpy(meta).to(dev), torch.from_numpy(panels).to(dev),
            _x2d(plan.shape[1], npanels * panel_ncb * 128, dev, seed=4),
            plan.num_row_blocks, plan.block_h, chunk, panel_ncb)
    before = spmv_chunked_paneled.launches
    y = spmv_chunked_paneled(*args)
    torch.cuda.synchronize()
    assert spmv_chunked_paneled.launches == before + 1
    assert_close(y, spmv_chunked_paneled_plain(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b3_kernel_row_block_across_ranges_and_panels(dev, dtype):
    """B1's case in panels: the dense row-block has a run of 8 blocks in
    each of 98 panels, each run spanning ranges of the grid, and the grid
    cuts ranges across chunk and panel boundaries."""
    plan = build_block_plan(_heavy_rows_coo(), 8)
    panel_ncb = 8
    data3d, meta, panels, nch = pack_chunks_paneled(plan, 16, panel_ncb)
    rows = meta[:, 0, :] >> 1
    heavy = np.bincount(rows.reshape(-1)).argmax()
    assert len(np.unique(panels[(rows == heavy).any(1)])) > 90
    V, slices, ctas = chunked_paneled_grid(nch, 16, 8)
    assert (V, slices) == (1, 1) and ctas > nch
    assert -(-nch * 16 // ctas) < 16  # ranges shorter than a chunk
    _b3_run(plan, data3d, meta, panels, panel_ncb, 16, dtype, dev)


@pytest.mark.parametrize("bh", [1, 8, 64])
def test_b3_kernel_on_padding_between_panels(dev, bh):
    """A chunk that divides no panel's block count: every panel's segment
    ends in padding blocks (zero payload, its last row-block, no last
    flag) that sit between two segments, so ranges begin and end in
    them."""
    plan = build_block_plan(MATRICES["random"](), bh)
    panel_ncb = 4
    counts = np.bincount(plan.block_cols // panel_ncb)
    chunk = next(c for c in range(8, 64, 8) if (counts % c).all())
    data3d, meta, panels, _ = pack_chunks_paneled(plan, chunk, panel_ncb)
    pad = ~data3d.reshape(-1, bh * 128).any(1)
    seg_end = np.r_[panels[1:] != panels[:-1], True]
    assert pad.reshape(-1, chunk)[:, -1][seg_end].all()  # every panel pads
    assert (meta[:, 0, :].reshape(-1)[pad] & 1 == 0).all()
    _b3_run(plan, data3d, meta, panels, panel_ncb, chunk, torch.float32, dev)


def test_b3_kernel_empty_ring_segment_adds_nothing(dev):
    """An empty ring segment (all zeros: row-block 0, no last flag) leaves
    the y it adds into as it was, bit for bit; a full one adds its
    product."""
    coo = random_coo(4000, 40, 3000, seed=5)  # one col block: shards 1-3
    plan = build_sharded_chunked_plan(coo, 4, chunk=16)
    nch, bh, per = plan.data5.shape[2], plan.block_h, plan.ncb_per_shard
    panels = torch.zeros(nch, dtype=torch.int32, device=dev)
    x2d = _x2d(40, per * 128, dev)
    for step in range(4):
        data3d, meta = plan.data5[0, step], plan.meta5[0, step]
        args = (torch.from_numpy(data3d).to(dev),
                torch.from_numpy(meta).to(dev), panels, x2d, plan.nrb_max,
                bh, 16, per)
        out = torch.full((plan.nrb_max, bh), 0.5, device=dev)
        y = spmv_chunked_paneled(*args, out=out.clone())
        torch.cuda.synchronize()
        if data3d.any():
            assert_close(y, spmv_chunked_paneled_plain(*args, out=out))
        else:
            assert torch.equal(y, out)
    assert not plan.data5[0, 1:].any()


def test_b3_launch_shape(dev):
    """B3 runs at V 1; row slices of 8 rows past bh 8; a grid of one wave
    of resident CTAs on this card's SMs, more CTAs than chunks (the design
    it replaces ran one a chunk); B1's shape, one instance per mode."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bh, slices in ((1, 1), (2, 1), (8, 1), (16, 2), (64, 8)):
        V, s, ctas = chunked_paneled_grid(200, 128, bh)
        assert (V, s) == (1, slices)
        assert ctas % slices == 0 and ctas >= sms and ctas > 200
    assert chunked_paneled_grid(1, 8, 8) == (1, 1, 8)
    with pytest.raises(RuntimeError, match="chunked_paneled_grid"):
        chunked_paneled_grid(8, 16, 3)


def test_one_shot_spmv_block_on_card(dev):
    coo = MATRICES["banded"]()
    plan = build_block_plan(coo, 8)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(coo.num_cols).astype(np.float32)
    y_in = rng.standard_normal(coo.num_rows).astype(np.float32)
    y = spmv_block(plan, x, y_in, 1.5, -0.5)
    assert y.device.type == "cuda"
    want = 1.5 * coo.matvec(x.astype(np.float64)) - 0.5 * y_in
    assert error_stats(y.cpu().numpy(), want, rtol=1e-3).ok


# --- dist: the sharded executors ---------------------------------------------

SHARDED = {
    "block": (build_sharded_block_plan, spmv_sharded, ("replicated",
                                                       "gather")),
    "window": (build_sharded_window_plan, spmv_sharded_window,
               ("replicated", "gather")),
    "chunked": (lambda c, d: build_sharded_chunked_plan(c, d, chunk=16),
                spmv_sharded_chunked, ("ring", "replicated")),
}


def _run_sharded(kind, devices, coo):
    build, run, modes = SHARDED[kind]
    mesh = make_mesh(devices=devices)
    plan = build(coo, mesh.size)
    x = np.random.default_rng(mesh.size).standard_normal(
        coo.num_cols).astype(np.float32)
    want = coo.matvec(x.astype(np.float64))
    D = mesh.size
    for mode in modes:
        b3, b5 = spmv_chunked_paneled.launches, spmv_block_stream.launches
        b7, rot = spmv_windowed.launches, spmv_sharded_chunked.rotations
        y = run(plan, x, mesh, x_mode=mode)
        torch.cuda.synchronize()
        assert y.device == mesh.devices[0] and y.shape == (coo.num_rows,)
        assert error_stats(y.cpu().numpy(), want, rtol=1e-3).ok, (kind, mode)
        if kind == "block":
            assert spmv_block_stream.launches - b5 == D
        elif kind == "window":
            assert spmv_windowed.launches - b7 == D
        else:
            assert spmv_chunked_paneled.launches - b3 == D * D
            assert spmv_sharded_chunked.rotations - rot == (
                D * (D - 1) if mode == "ring" else 0)


@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("kind", list(SHARDED))
def test_sharded_executors_on_one_card(dev, kind, D):
    """The mesh repeats one card: the schedule runs as on D devices."""
    _run_sharded(kind, ["cuda:0"] * D, powerlaw_coo(3000, 2500, 50_000,
                                                    seed=9))


@pytest.mark.parametrize("kind", list(SHARDED))
def test_sharded_executors_on_distinct_cards(dev, kind):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more cards, found {n}")
    _run_sharded(kind, [f"cuda:{i}" for i in range(min(n, 4))],
                 powerlaw_coo(3000, 2500, 50_000, seed=9))


def test_sharded_window_with_empty_shards_on_one_card(dev):
    """16 rows over 8 shards: some shards hold no block, some one chunk;
    each launch of B7 sizes its own grid."""
    coo = random_coo(16, 200, 100, seed=5)
    plan = build_sharded_window_plan(coo, 8)
    assert 0 in plan.blocks_per_dev or min(plan.nrb_per_dev) == 0
    _run_sharded("window", ["cuda:0"] * 8, coo)


def test_dryrun_multichip_on_one_card(dev):
    stats = dryrun_multichip(["cuda:0"] * 4)
    assert stats["ring_copies"] == 12


@pytest.fixture
def nccl_world(dev, tmp_path):
    """A world of one NCCL rank on cuda:0, joined by a file store; its
    process mesh.  Left after the test."""
    assert init_distributed(f"file://{tmp_path}/store", 1, 0,
                            backend="nccl") is False
    try:
        yield make_process_mesh("cuda:0")
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("kind", list(SHARDED))
def test_process_mesh_of_one_nccl_rank(nccl_world, kind):
    """The executors on a ProcessMesh of one NCCL rank: y on the rank's
    card equals the one-process form on ["cuda:0"] (same kernels, same
    arrays: B5 bit for bit; B7 and B3 add by atomics, so at the kernel
    tolerance) and is within 1e-3 of the golden; one B5 or B7, or D B3, a
    call, and no ring send at D 1."""
    build, run, modes = SHARDED[kind]
    coo = powerlaw_coo(3000, 2500, 50_000, seed=9)
    plan = build(coo, 1)
    x = np.random.default_rng(1).standard_normal(coo.num_cols).astype(
        np.float32)
    want = coo.matvec(x.astype(np.float64))
    counter = {"block": spmv_block_stream, "window": spmv_windowed,
               "chunked": spmv_chunked_paneled}[kind]
    for mode in modes:
        one = run(plan, x, make_mesh(devices=["cuda:0"]), x_mode=mode)
        launched, sent = counter.launches, spmv_sharded_chunked.rotations
        y = run(plan, x, nccl_world, x_mode=mode)
        torch.cuda.synchronize()
        assert counter.launches - launched == 1, (kind, mode)
        assert spmv_sharded_chunked.rotations == sent
        assert y.device == torch.device("cuda", 0)
        assert y.shape == (coo.num_rows,)
        if kind == "block":
            assert torch.equal(y, one), mode
        else:
            assert_close(y, one)
        assert error_stats(y.cpu().numpy(), want, rtol=1e-3).ok, (kind, mode)


def test_process_mesh_on_distinct_cards(dev, tmp_path):
    """The dry run on min(cards, 4) NCCL ranks, one a card, under
    torchrun: every rank's y within 1e-3 of the golden and D - 1 ring
    sends."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more cards, found {n}")
    D = min(n, 4)
    env = dict(os.environ, PYTHONPATH=REPO)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(D), "-m", "hispmv_tpu_torch.dist.dryrun"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert sorted(d["rank"] for d in lines) == list(range(D))
    for d in lines:
        assert d["ok"] and d["ring_copies"] == D - 1
        assert d["device"] == f"cuda:{d['rank']}"


def test_gloo_group_refuses_card_tensors(nccl_world):
    """A gloo group given the card raises, naming the backend and the
    device, before any collective."""
    gloo = torch.distributed.new_group(backend="gloo")
    with pytest.raises(RuntimeError, match="gloo.*cuda:0"):
        make_process_mesh("cuda:0", group=gloo)
    with pytest.raises(RuntimeError, match="gloo.*cuda:0"):
        ProcessMesh(gloo, 0, 1, torch.device("cuda", 0))


# --- B4 and the block handle's layouts ---------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh", [1, 8, 64])
@pytest.mark.parametrize("name", ["random", "banded"])
def test_b4_kernel_matches_plain(dev, name, bh, dtype):
    plan = build_block_plan(MATRICES[name](), bh)
    panel_ncb, panel_nrb = 4, 8  # several x and y panels
    data3d, meta, xp, yp, _, _ = pack_chunks_tiled(plan, 8, panel_ncb,
                                                   panel_nrb)
    npx = -(-plan.num_col_blocks // panel_ncb)
    npy = -(-plan.num_row_blocks // panel_nrb)
    assert len(np.unique(xp)) > 1 and len(np.unique(yp)) > 1
    data = torch.from_numpy(data3d).to(dev, dtype)
    args = (data, torch.from_numpy(meta).to(dev),
            torch.from_numpy(xp).to(dev), torch.from_numpy(yp).to(dev),
            _x2d(plan.shape[1], npx * panel_ncb * 128, dev), npy, panel_nrb,
            bh, 8, panel_ncb, tiled_sector_mask(data, bh))
    before = spmv_chunked_tiled.launches
    y = spmv_chunked_tiled(*args)
    torch.cuda.synchronize()
    assert spmv_chunked_tiled.launches == before + 1
    assert y.shape == (npy * panel_nrb, bh)
    assert_close(y, spmv_chunked_tiled_plain(*args))
    # and the true product: the plain version without the mask
    assert_close(y, spmv_chunked_tiled_plain(*args[:10]))


def _b4_args(plan, chunk, panel_ncb, panel_nrb, dtype, dev, seed=4):
    """B4's arguments, the helper's sector mask last, and the chunk count."""
    data3d, meta, xp, yp, _, nch = pack_chunks_tiled(plan, chunk, panel_ncb,
                                                     panel_nrb)
    npx = -(-plan.num_col_blocks // panel_ncb)
    data = torch.from_numpy(data3d).to(dev, dtype)
    return (data, torch.from_numpy(meta).to(dev),
            torch.from_numpy(xp).to(dev), torch.from_numpy(yp).to(dev),
            _x2d(plan.shape[1], npx * panel_ncb * 128, dev, seed=seed),
            -(-plan.num_row_blocks // panel_nrb), panel_nrb, plan.block_h,
            chunk, panel_ncb, tiled_sector_mask(data, plan.block_h)), nch


def _b4_run(args, true_mask=True):
    """One launch of B4, held to the plain version with the same mask and,
    where the mask is the helper's (``true_mask``), to the plain version
    without one: the true product, so a mask built wrong on the card
    shows."""
    before = spmv_chunked_tiled.launches
    y = spmv_chunked_tiled(*args)
    torch.cuda.synchronize()
    assert spmv_chunked_tiled.launches == before + 1
    assert_close(y, spmv_chunked_tiled_plain(*args))
    if true_mask:
        assert_close(y, spmv_chunked_tiled_plain(*args[:10]))
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh", [1, 8, 64])
@pytest.mark.parametrize("col_reorder", [False, True])
def test_b4_kernel_with_sector_mask_on_blocked(dev, col_reorder, bh, dtype):
    """The blocked matrix (dense windows, sectors both live and clear in
    most blocks), its columns degree-reordered or not."""
    coo = MATRICES["blocked"]()
    perm = degree_column_perm(coo) if col_reorder else None
    plan = build_block_plan(coo, bh, col_perm=perm)
    args, _ = _b4_args(plan, 8, 2, 4, dtype, dev)
    live = tiled_sector_mask(args[0], bh).cpu().numpy().view(np.uint16)
    assert 0 < np.unpackbits(live.view(np.uint8)).mean() < 1
    _b4_run(args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b4_kernel_row_block_across_ranges_and_panels(dev, dtype):
    """B3's case in row panels too: the dense row-block's runs (one in each
    of 8 col panels) span ranges of the grid, and the grid cuts ranges
    across chunk and y-panel boundaries (a chunk of 17 blocks, so that
    ranges do not all start on chunk boundaries)."""
    plan = build_block_plan(_heavy_rows_coo(), 8)
    args, nch = _b4_args(plan, 17, 100, 32, dtype, dev)
    yp = args[3].cpu().numpy()
    assert len(np.unique(yp)) > 8
    V, slices, ctas = chunked_tiled_grid(nch, 17, 8)
    assert (V, slices) == (1, 1) and ctas > nch
    nb = nch * 17
    span = -(-nb // ctas)
    assert span < 17  # ranges shorter than a chunk
    k0 = np.arange(0, nb, span)
    k1 = np.minimum(k0 + span, nb) - 1
    assert (yp[k0 // 17] != yp[k1 // 17]).any()
    _b4_run(args)


@pytest.mark.parametrize("bh", [1, 8, 64])
def test_b4_kernel_on_padding_between_panels(dev, bh):
    """A chunk that divides no segment's block count: every (row panel,
    col panel) segment ends in padding blocks (zero payload, sector mask
    0, its last row-block, no last flag) that sit between two segments, so
    ranges begin and end in them."""
    plan = build_block_plan(MATRICES["random"](), bh)
    panel_ncb, panel_nrb = 8, 256 // bh  # 3 x 3 segments
    key = (plan.block_rows // panel_nrb) * 10**6 + plan.block_cols // panel_ncb
    counts = np.unique(key, return_counts=True)[1]
    chunk = next(c for c in range(8, 64, 8) if (counts % c).all())
    args, _ = _b4_args(plan, chunk, panel_ncb, panel_nrb, torch.float32, dev)
    xp, yp = args[2].cpu().numpy(), args[3].cpu().numpy()
    seg_end = np.r_[(xp[1:] != xp[:-1]) | (yp[1:] != yp[:-1]), True]
    pad = ~args[0].reshape(-1, bh * 128).any(1).cpu().numpy()
    assert pad.reshape(-1, chunk)[:, -1][seg_end].all()  # every segment pads
    assert not args[10].cpu().numpy().reshape(-1, bh)[pad].any()
    _b4_run(args)


def test_b4_kernel_needs_sector_mask(dev):
    plan = build_block_plan(MATRICES["banded"](), 8)
    args, _ = _b4_args(plan, 8, 4, 8, torch.float32, dev)
    with pytest.raises(ValueError, match="sector_mask"):
        spmv_chunked_tiled(*args[:10])
    with pytest.raises(ValueError, match="sector_mask"):
        spmv_chunked_tiled(*args[:10], args[10].to(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b4_kernel_skips_by_sector_mask(dev, dtype):
    """With one needed bit cleared in every row of a block, the kernel
    gives the plain version's answer under that mask, not the full
    product: it reads the payload by the mask."""
    plan = build_block_plan(MATRICES["blocked"](), 8)
    args, _ = _b4_args(plan, 8, 4, 8, dtype, dev)
    mask = args[10]
    words = mask.to(torch.int32) & 0xFFFF
    low = words & -words  # each row's lowest set bit
    cleared = words - low
    cleared = torch.where(cleared >= 1 << 15, cleared - (1 << 16),
                          cleared).to(torch.int16)
    cut = (*args[:10], cleared)
    y = _b4_run(cut, true_mask=False)
    full = spmv_chunked_tiled_plain(*args)
    assert (y - full).abs().max() > 1e-3 * full.abs().max()


def test_b4_launch_shape(dev):
    """B4 runs at V 1; row slices of 8 rows past bh 8; a grid of one wave
    of resident CTAs on this card's SMs, more CTAs than chunks (the design
    it replaces ran one a chunk)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bh, slices in ((1, 1), (2, 1), (8, 1), (16, 2), (64, 8)):
        V, s, ctas = chunked_tiled_grid(200, 128, bh)
        assert (V, s) == (1, slices)
        assert ctas % slices == 0 and ctas >= sms and ctas > 200
    assert chunked_tiled_grid(1, 8, 8) == (1, 1, 8)
    with pytest.raises(RuntimeError, match="chunked_tiled_grid"):
        chunked_tiled_grid(8, 16, 3)


# V5E's budgets replaced to give each layout on banded_coo(5000, 20000,
# 60000); B2 takes a batch of 8 on the chunked handle
BLOCK_LAYOUTS = {
    "chunked": ({}, spmv_chunked),
    "paneled": ({"chunked_budget_bytes": 2 * 2**20 + 48 * 1024,
                 "panel_ncb": 8}, spmv_chunked_paneled),
    "tiled": ({"chunked_budget_bytes": 64 * 1024, "panel_ncb": 16,
               "panel_y_bytes": 8 * 1024}, spmv_chunked_tiled),
}


@pytest.mark.parametrize("col_reorder", [False, True])
@pytest.mark.parametrize("layout", list(BLOCK_LAYOUTS))
def test_block_handle_layouts_on_card(dev, layout, col_reorder):
    consts, kernel = BLOCK_LAYOUTS[layout]
    profile = dataclasses.replace(V5E, **consts)
    coo = banded_coo(5000, 20_000, 60_000, seed=52)
    h = SpmvHandle(coo, SpmvConfig(col_reorder=col_reorder), "block",
                   profile=profile)
    assert getattr(h, "_" + layout)
    rng = np.random.default_rng(53)
    x = rng.standard_normal(coo.num_cols).astype(np.float32)
    before = kernel.launches
    y = h.run(torch.from_numpy(x).to(dev))
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert error_stats(y.cpu().numpy(), coo.matvec(x.astype(np.float64)),
                       rtol=1e-3).ok
    # linear: B2 for the chunked handle at this batch, else B6
    xb = rng.standard_normal((8, coo.num_cols)).astype(np.float32)
    b2, b6 = spmv_chunked_batched.launches, spmv_block_batched.launches
    yb = h.linear(torch.from_numpy(xb).to(dev))
    torch.cuda.synchronize()
    want = (1, 0) if layout == "chunked" else (0, 1)
    assert (spmv_chunked_batched.launches - b2,
            spmv_block_batched.launches - b6) == want
    assert error_stats(yb.cpu().numpy(), _golden_linear(coo, xb, 0.0),
                       rtol=1e-3).ok


# --- the gathered executor: B12, B11 twice and B13 ---------------------------


def _unique_coo(n_rows, n_cols, nnz, seed):
    rng = np.random.default_rng(seed)
    k = np.unique(rng.integers(0, n_rows, nnz).astype(np.int64) * n_cols
                  + rng.integers(0, n_cols, nnz))
    vals = rng.standard_normal(len(k)).astype(np.float32)
    return COOMatrix((n_rows, n_cols), k // n_cols, k % n_cols, vals)


def _gathered(dev):
    coo = _unique_coo(4096, 16384, 60_000, 1)
    plan = G.build_gathered_plan(coo.rows, coo.cols, coo.values, coo.shape,
                                 16)[0]
    arrays, meta = pack_gathered(plan, tchunk=4)
    d = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    x = np.random.default_rng(2).standard_normal(coo.num_cols).astype(
        np.float32)
    x2d = torch.from_numpy(x[: meta["K"] * 1024]).to(dev).reshape(-1, 128)
    return plan, d, meta, x, x2d


def test_b12_kernel_equals_plain(dev):
    plan, d, meta, _, x2d = _gathered(dev)
    before = s1_gather.launches
    got = s1_gather(d["s1"], x2d, meta["P"], meta["K"])
    torch.cuda.synchronize()
    assert s1_gather.launches == before + 1
    assert torch.equal(got, s1_gather_plain(d["s1"], x2d, meta["P"],
                                            meta["K"]))


def _s1_words(P, K, seed=0):
    """Random B12 words of P x K windows: every row holds every lane L
    0-127 (a stride coprime with 128) and every rank 0-3, the sub fields
    and the other bits random (the sign bit too)."""
    rng = np.random.default_rng(seed)
    n = P * K * 8
    s = np.arange(n)[:, None]
    j = np.arange(128)[None, :]
    L = (37 * j + 11 * s) % 128
    rank = (j + s) % 4
    high = rng.integers(0, 1 << 32, (n, 128), dtype=np.uint64)
    w = (high & ~np.uint64(0x1FF)) | (rank << 7).astype(np.uint64) \
        | L.astype(np.uint64)
    return w.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("K", [1, 5, 512])
@pytest.mark.parametrize("P", [1, 3, 8])
def test_b12_kernel_equals_plain_on_random_words(dev, P, K):
    words = _s1_words(P, K)
    u = words.view(np.uint32)
    subs = (u[:, None, :] >> (16 + 3 * np.arange(4))[None, :, None]) & 7
    assert set(np.unique(u & 127)) == set(range(128))
    assert set(np.unique((u >> 7) & 3)) == set(range(4))
    assert set(np.unique(subs)) == set(range(8))
    wd = torch.from_numpy(words).to(dev)
    x2d = torch.from_numpy(np.random.default_rng(K).standard_normal(
        (K * 8, 128)).astype(np.float32)).to(dev)
    before = s1_gather.launches
    got = s1_gather(wd, x2d, P, K)
    torch.cuda.synchronize()
    assert s1_gather.launches == before + 1
    assert torch.equal(got, s1_gather_plain(wd, x2d, P, K))


def test_b12_kernel_equals_plain_on_analytics(dev):
    """The side-plan of analytics under V5E with the gathered costs
    lowered (P 8 x K 512 windows), through the routed handle."""
    h = SpmvHandle(suite_matrix("analytics", 1.0, seed=0), format="routed",
                   profile=dataclasses.replace(V5E, gath_tile_ns=1.0,
                                               gath_stage_ns=1.0))
    gm = h._routed_meta["gathered"]
    assert (gm["P"], gm["K"]) == (8, 512)
    x2d = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (gm["K"] * 8, 128)).astype(np.float32)).to(dev)
    got = s1_gather(h._d["g_s1"], x2d, gm["P"], gm["K"])
    torch.cuda.synchronize()
    assert torch.equal(got, s1_gather_plain(h._d["g_s1"], x2d, gm["P"],
                                            gm["K"]))


@pytest.mark.parametrize("P,K", [(1, 1), (3, 5), (8, 512), (64, 512)])
def test_b12_launch_shape(dev, P, K):
    """A warp a row, 8 a CTA; one wave of resident CTAs at most."""
    warps, rows, ctas = s1_gather_grid(P, K)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (warps, rows) == (8, P * K * 8)
    assert ctas == P * K or (ctas % sms == 0 and sms <= ctas < P * K)
    assert ctas <= 8 * sms


def test_b12_kernel_refuses_unaligned_words(dev):
    words = torch.from_numpy(_s1_words(1, 5)).to(dev)
    x2d = torch.ones((5 * 8, 128), device=dev)
    s1_gather(words, x2d, 1, 5)
    with pytest.raises(ValueError, match="aligned"):
        s1_gather(_misaligned(words), x2d, 1, 5)


def test_gathered_gather_on_card_is_exact(dev):
    plan, d, meta, x, x2d = _gathered(dev)
    b12, b11 = s1_gather.launches, permute_stage.launches
    xg = gathered_gather_apply(d, meta, "", x2d)
    torch.cuda.synchronize()
    assert (s1_gather.launches - b12, permute_stage.launches - b11) == (1, 2)
    np.testing.assert_array_equal(xg.cpu().numpy().reshape(-1),
                                  G.gather_x_numpy(plan, x))


@pytest.mark.parametrize("pad", [False, True])
def test_b13_kernel_matches_plain(dev, pad):
    """pad adds a chunk of padding tiles (route 0 both ways, y tile 0), as
    the JAX package's packer does."""
    plan, d, meta, x, _ = _gathered(dev)
    if pad:
        for k in ("vals", "word"):
            d[k] = torch.cat([d[k], torch.zeros_like(d[k][:1])])
        d["byt"] = torch.cat([d["byt"], d["byt"].new_zeros(meta["tchunk"])])
        meta["nch"] += 1
    xg = torch.from_numpy(G.gather_x_numpy(plan, x)).to(dev).reshape(-1, 128)
    args = (d["vals"], d["word"], d["byt"], xg, plan.num_ytiles, meta["nch"],
            meta["tchunk"])
    before = spmv_gathered_tiles.launches
    y = spmv_gathered_tiles(*args)
    torch.cuda.synchronize()
    assert spmv_gathered_tiles.launches == before + 1
    assert_close(y, spmv_gathered_tiles_plain(*args))
    want = G.gathered_matvec_numpy(plan, x)
    got = y.cpu().numpy().reshape(-1)[: len(want)]
    assert error_stats(got, want, rtol=1e-3).ok


# tile counts: one, a few, one past a wave of 132 SMs x 8 CTAs, analytics'
B13_TILES = [1, 3, 1057, 2077]


def _b13_random(T, nyt, dev, short=0, seed=0):
    """B13's arguments on T random tiles: random vals, 26-bit words (two
    random 13-bit routes), byt with repeats inside [0, nyt), and xg short
    by ``short`` rows."""
    rng = np.random.default_rng(seed + T)
    vals = rng.standard_normal((T, 8, 128)).astype(np.float32)
    word = rng.integers(0, 1 << 26, (T, 8, 128), dtype=np.int32)
    byt = rng.integers(0, nyt, T).astype(np.int32)
    byt[-1] = byt[0]
    xg = rng.standard_normal((T * 8 - short, 128)).astype(np.float32)
    return (*(torch.from_numpy(a).to(dev) for a in (vals, word, byt, xg)),
            nyt, T, 1)


@pytest.mark.parametrize("T", B13_TILES)
def test_b13_kernel_matches_plain_on_random_words(dev, T):
    args = _b13_random(T, 64, dev)
    before = spmv_gathered_tiles.launches
    y = spmv_gathered_tiles(*args)
    torch.cuda.synchronize()
    assert spmv_gathered_tiles.launches == before + 1
    assert_close(y, spmv_gathered_tiles_plain(*args))


def test_b13_kernel_bad_y_tile_adds_nothing(dev):
    """byt with repeats and one y tile past num_ytiles: that tile adds
    nothing, the others add up."""
    vals, word, byt, xg, nyt, nch, tchunk = _b13_random(3, 2, dev)
    byt = torch.tensor([1, 2, 1], dtype=torch.int32, device=dev)
    args = (vals, word, byt, xg, nyt, nch, tchunk)
    y = spmv_gathered_tiles(*args)
    assert_close(y, spmv_gathered_tiles_plain(*args))
    alone = spmv_gathered_tiles(vals[:1], word[:1], byt[:1], xg[:8], nyt, 1,
                                1)
    assert float(alone.abs().max()) > 0
    assert_close(spmv_gathered_tiles(vals[2:], word[2:], byt[:1],
                                     xg[16:], nyt, 1, 1) + alone, y)


@pytest.mark.parametrize("short", [3, 16, 8 * 1057])
def test_b13_kernel_short_xg(dev, short):
    """xg short by 3 rows (the last tile partly covered), by two whole
    tiles and by 1057 tiles: the missing rows read as 0."""
    args = _b13_random(2077, 64, dev, short=short)
    y = spmv_gathered_tiles(*args)
    assert_close(y, spmv_gathered_tiles_plain(*args))


@pytest.mark.parametrize("n", [(4096, 16384, 60_000, 1),
                               (8192, 8192, 20_000, 0)])
def test_b13_kernel_is_the_float64_row_sum_rounded_once(dev, n):
    """The fp64 prefix kept on the card: a short row's sum keeps its
    digits (an fp32 prefix errs by ~1e-5 of the tile's running sum)."""
    R, C, nnz, seed = n
    coo = _unique_coo(R, C, nnz, seed)
    plan = G.build_gathered_plan(coo.rows, coo.cols, coo.values, coo.shape,
                                 C // 1024)[0]
    arrays, meta = pack_gathered(plan)
    d = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    x = np.random.default_rng(1).standard_normal(C).astype(np.float32)
    xg = torch.from_numpy(G.gather_x_numpy(plan, x)).to(dev).reshape(-1, 128)
    y = spmv_gathered_tiles(d["vals"], d["word"], d["byt"], xg,
                            plan.num_ytiles, meta["nch"], meta["tchunk"])
    want = G.gathered_matvec_numpy(plan, x)
    np.testing.assert_allclose(y.cpu().numpy().reshape(-1)[: R], want,
                               rtol=1e-6, atol=1e-9)


def test_b13_kernel_refuses_unaligned_tensors(dev):
    args = list(_b13_random(3, 2, dev))
    spmv_gathered_tiles(*args)
    for k in (0, 1, 3):  # vals, word, xg: read by 16 bytes
        bad = list(args)
        bad[k] = _misaligned(args[k])
        with pytest.raises(ValueError, match="aligned"):
            spmv_gathered_tiles(*bad)


@pytest.mark.parametrize("T", B13_TILES)
def test_b13_launch_shape(dev, T):
    """256 threads and a CTA a tile, 8 resident an SM (32 registers)."""
    assert spmv_gathered_grid(T) == (256, T, 8)


def test_gathered_routed_handle_on_card(dev):
    """Cheap gathered costs divert this matrix's tiles to the side-plan:
    one run is B12, B11 twice, B13 and one B9 launch for every stream."""
    coo = _unique_coo(16384, 16384, 150_000, 3)
    h = SpmvHandle(coo, format="routed", profile=dataclasses.replace(
        V5E, gath_tile_ns=1.0, gath_stage_ns=1.0, gath_launch_ns=0.0))
    assert h.plan.gathered is not None
    rng = np.random.default_rng(5)
    x = rng.standard_normal(coo.num_cols).astype(np.float32)
    counts = (s1_gather, permute_stage, spmv_gathered_tiles,
              spmv_routed_streams)
    before = [k.launches for k in counts]
    y = h.run(torch.from_numpy(x).to(dev))
    torch.cuda.synchronize()
    assert len(h.plan.streams) > 0
    assert [k.launches - b for k, b in zip(counts, before)] == [1, 2, 1, 1]
    assert error_stats(y.cpu().numpy(), coo.matvec(x.astype(np.float64)),
                       rtol=1e-3).ok
    xb = rng.standard_normal((3, coo.num_cols)).astype(np.float32)
    yb = h.linear(torch.from_numpy(xb).to(dev))
    assert error_stats(yb.cpu().numpy(), _golden_linear(coo, xb, 0.0),
                       rtol=1e-3).ok


# --- the split format and the timing harness ---------------------------------


@pytest.mark.parametrize("body", ["auto", "ellx"])
def test_split_handle_runs_on_card(dev, body):
    """trans5 at scale 0.05: 12 hub columns and 11 hub rows.  The routed
    body (``auto``) is one B9 launch a run and one a vector of a linear;
    the ELLX body runs B1 on its overflow, B2 once a linear."""
    coo = suite_matrix("trans5", 0.05, seed=0)
    if body == "auto":
        h = SpmvHandle(coo, format="split")
        kern, per_run = spmv_routed_streams, 1
    else:
        h = SpmvHandle.from_plan(build_split_plan(coo, body_format="ellx"))
        assert h._split_plan_meta.body.overflow is not None
        kern, per_run = spmv_chunked, 1
    assert h.format == "split" and h.plan.stats["kc"] > 0
    assert all(t.device.type == "cuda" for t in h._d.values())
    rng = np.random.default_rng(6)
    x = rng.standard_normal(coo.num_cols).astype(np.float32)
    y_in = rng.standard_normal(coo.num_rows).astype(np.float32)
    before = kern.launches
    y = h.run(torch.from_numpy(x).to(dev), torch.from_numpy(y_in).to(dev),
              2.0, 0.5)
    torch.cuda.synchronize()
    assert kern.launches - before == per_run
    want = 2.0 * coo.matvec(x.astype(np.float64)) + 0.5 * y_in
    assert error_stats(y.cpu().numpy(), want, rtol=1e-3).ok
    B = 8
    xb = rng.standard_normal((B, coo.num_cols)).astype(np.float32)
    bias = rng.standard_normal(coo.num_rows).astype(np.float32)
    lin = spmv_routed_streams if body == "auto" else spmv_chunked_batched
    before = lin.launches
    yb = h.linear(torch.from_numpy(xb).to(dev), torch.from_numpy(bias).to(dev))
    torch.cuda.synchronize()
    assert lin.launches - before == (B if body == "auto" else 1)
    assert error_stats(yb.cpu().numpy(), _golden_linear(coo, xb, bias),
                       rtol=1e-3).ok


def test_bench_spmv_on_card(dev):
    """CUDA-event timing of a handle's run: a positive median, the result
    of the timed call, and the kernel launched by every timed call."""
    coo = suite_matrix("trans5", 0.05, seed=0)
    h = SpmvHandle(coo, format="ellx")
    x = np.random.default_rng(7).standard_normal(coo.num_cols).astype(
        np.float32)
    before = spmv_chunked.launches
    t, y = bench_spmv(h, x, runs=5, warmup=2)
    assert spmv_chunked.launches - before == 1 + 5 + 2
    assert 0 < t < 1.0
    assert error_stats(y, coo.matvec(x.astype(np.float64)), rtol=1e-3).ok
    xd = torch.from_numpy(x).to(dev)
    assert median_ms(lambda: h.run(xd), runs=3, warmup=1, device=dev) > 0


# --- plans kept on disk, profile_trace and PowerMonitor on the card -------

WRAPPERS = (spmv_chunked, spmv_windowed, spmv_routed_streams, permute_stage,
            spmv_chunked_paneled, spmv_chunked_tiled, s1_gather,
            spmv_gathered_tiles)


def _launches():
    return [w.launches for w in WRAPPERS]


@pytest.mark.parametrize("fmt,cfg", [
    ("block", SpmvConfig()),
    ("block", SpmvConfig(col_reorder=True)),
    ("routed", SpmvConfig()),
    ("routed", SpmvConfig(rank_sort=True)),
])
def test_reloaded_plan_runs_on_card_with_the_same_launches(dev, tmp_path,
                                                           fmt, cfg):
    from hispmv_tpu_torch.plan import load_plan, save_plan

    coo = powerlaw_coo(4000, 4000, 60_000, seed=7)
    h = SpmvHandle(coo, cfg, fmt)
    path = str(tmp_path / "plan.npz")
    save_plan(path, h.plan, compress=False)
    h2 = SpmvHandle.from_plan(load_plan(path))
    assert h2.format == h.format == fmt
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal(coo.num_cols).astype(
        np.float32)).to(dev)
    y_in = torch.from_numpy(rng.standard_normal(coo.num_rows).astype(
        np.float32)).to(dev)
    runs = []
    for handle in (h, h2):
        before = _launches()
        y = handle.run(x, y_in, 1.5, -0.5)
        torch.cuda.synchronize()
        runs.append((y, [a - b for a, b in zip(_launches(), before)]))
    (y, n), (y2, n2) = runs
    assert n == n2 and sum(n) > 0
    assert_close(y2, y)
    want = 1.5 * coo.matvec(x.cpu().numpy().astype(np.float64)) \
        - 0.5 * y_in.cpu().numpy()
    assert error_stats(y2.cpu().numpy(), want, rtol=1e-3).ok


def test_profile_trace_sees_device_events_on_card(dev, tmp_path):
    from hispmv_tpu_torch.utils.trace import profile_trace

    coo = MATRICES["blocked"]()
    h = SpmvHandle(coo, format="block")
    x = torch.ones(coo.num_cols, device=dev)
    h.run(x)
    with profile_trace(str(tmp_path), device=dev) as tr:
        for _ in range(5):
            h.run(x)
    assert tr.device_us > 0
    with open(tr.path) as f:
        assert "chunked_vec_kernel" in f.read()


@pytest.mark.parametrize("fmt", ["block", "routed"])
def test_kernel_spans_count_the_launches_on_card(dev, tmp_path, fmt):
    """Under profile_trace the program's spans land in the Chrome trace,
    one ``kernel.B<n>`` span a launch of the 13 wrappers, and the device
    time is the union of the device's intervals."""
    import importlib

    from hispmv_tpu_torch.utils.trace import profile_trace

    wrappers = [getattr(importlib.import_module("hispmv_tpu_torch.ops." + m),
                        n) for m, names in (
        ("spmv_chunked", ("spmv_chunked", "spmv_chunked_batched",
                          "spmv_chunked_paneled", "spmv_chunked_tiled")),
        ("spmv_block", ("spmv_block_stream", "spmv_block_batched")),
        ("spmv_windowed", ("spmv_windowed", "spmv_windowed_batched")),
        ("spmv_routed", ("spmv_routed_streams",
                         "spmv_routed_stream_batched")),
        ("permute", ("permute_stage",)),
        ("spmv_gathered", ("s1_gather", "spmv_gathered_tiles")))
        for n in names]
    coo = MATRICES["blocked"]()
    h = SpmvHandle(coo, format=fmt)
    x = torch.ones(coo.num_cols, device=dev)
    xb = torch.ones((16, coo.num_cols), device=dev)
    h.run(x)
    h.linear(xb)
    before = [w.launches for w in wrappers]
    with profile_trace(str(tmp_path), device=dev) as tr:
        for _ in range(3):
            h.run(x)
            h.linear(xb)
    launches = sum(w.launches for w in wrappers) - sum(before)
    counts = tr.tracer.counts
    assert counts["run"] == 3 and counts["linear"] == 3
    kernels = sum(v for k, v in counts.items() if k.startswith("kernel."))
    assert kernels == launches > 0
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"hispmv.run", "hispmv.linear", "hispmv.pad"} <= names
    durs = [e.get("dur", 0) for e in events if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    # the union is at most the sum, up to the rounding of ts + dur (1e-3
    # us an interval: the trace's timestamps are large)
    assert 0 < tr.device_us <= sum(durs) + 1e-3 * len(durs)


def test_power_monitor_reads_finite_watts_on_card(dev):
    import time

    from hispmv_tpu_torch.utils.trace import PowerMonitor

    pm = PowerMonitor(interval_s=0.1, device=dev)
    pm.start()
    a = torch.randn(4096, 4096, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        a = a @ a.T
        a /= a.norm()
    torch.cuda.synchronize()
    pm.stop()
    assert len(pm.samples) >= 3
    assert all(np.isfinite(s.watts) and s.watts > 0 for s in pm.samples)
    assert pm.max_watts >= pm.avg_watts > 0
    assert pm.avg_bytes_in_use > 0


# --- the card's device profile -------------------------------------------------

H100_FORMATS = ["block", "window", "ellx", "routed", "split", "stream",
                "dense"]


def test_cuda_entry_points_plan_under_h100(dev):
    from hispmv_tpu_torch.tune import DSE, tune

    coo = suite_matrix("trans5", 0.2, seed=0)
    assert SpmvHandle(coo, format="ellx").profile is H100
    assert Accelerator().profile is H100
    assert AcceleratorLayerManager().accel.profile is H100
    assert tune(coo).candidates == DSE(H100).explore(coo).candidates
    assert SpmvHandle(coo, format="ellx", profile=V5E).profile is V5E


@pytest.mark.parametrize("fmt", H100_FORMATS)
def test_h100_plans_on_card_match_plain_and_golden(dev, fmt):
    """Each format's H100 plan of a trans5-like matrix: run and linear on
    the card against the same plan's plain versions on the CPU and the
    float64 golden."""
    coo = suite_matrix("trans5", 0.2, seed=0)
    h = SpmvHandle(coo, format=fmt)
    hc = SpmvHandle(coo, format=fmt, device="cpu", profile=H100)
    rng = np.random.default_rng(21)
    x = rng.standard_normal(coo.num_cols).astype(np.float32)
    y = h.run(torch.from_numpy(x).to(dev))
    assert_close(y, hc.run(x))
    assert error_stats(y.cpu().numpy(), coo.matvec(x.astype(np.float64)),
                       rtol=1e-3).ok
    xb = rng.standard_normal((8, coo.num_cols)).astype(np.float32)
    yb = h.linear(torch.from_numpy(xb).to(dev))
    assert_close(yb, hc.linear(xb))
    assert error_stats(yb.cpu().numpy(), _golden_linear(coo, xb, 0.0),
                       rtol=1e-3).ok
