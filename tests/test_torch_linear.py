"""Batched ``linear()`` in the port against the JAX package (the routed
format's cases, B10 among them, are in ``tests/test_torch_linear_routed.py``).

- The plain PyTorch versions of B2 and B8 against the Pallas kernels in
  interpret mode, on identical packed arrays and batches made from a seed
  with numpy.
- ``ellx_matvec_batched`` (base product in groups, overflow through B2).
- ``SpmvHandle.linear`` and ``Accelerator.linear`` against the JAX
  package's ``linear`` for the formats dense, block, window, ellx, stream
  and auto, with a bias, a [C] input squeezed back to [R], other configs
  and alternating batch sizes.

Port against JAX: rtol=1e-5, atol=1e-5*max(1, max|y|) (fp32 on both sides,
only the order of summation differs).  Against the float64 golden
``A @ x.T + bias``: ``error_stats`` at rtol=1e-3, the reference's
acceptance."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import small_matrix_cases

from hispmv_tpu.api.handle import Accelerator as JAccelerator
from hispmv_tpu.api.handle import SpmvHandle as JSpmvHandle
from hispmv_tpu.config import SpmvConfig as JSpmvConfig
from hispmv_tpu.ops.spmv_chunked import spmv_chunked_batched_pallas
from hispmv_tpu.ops.spmv_ellx import ellx_matvec_batched as jellx_batched
from hispmv_tpu.ops.spmv_windowed import pack_batch_x as jpack_batch_x
from hispmv_tpu.ops.spmv_windowed import spmv_windowed_batched_pallas
from hispmv_tpu_torch import Accelerator, SpmvConfig, SpmvHandle
from hispmv_tpu_torch.formats.matrix import COOMatrix
from hispmv_tpu_torch.formats.synth import random_coo
from hispmv_tpu_torch.ops.spmv_chunked import (
    pack_chunks,
    spmv_chunked_batched,
    spmv_chunked_batched_plain,
)
from hispmv_tpu_torch.ops.spmv_ellx import build_ellx_plan, ellx_matvec_batched
from hispmv_tpu_torch.ops.spmv_windowed import (
    pack_window_chunks,
    spmv_windowed_batched,
    spmv_windowed_batched_plain,
)
from hispmv_tpu_torch.plan.blocks import build_block_plan
from hispmv_tpu_torch.plan.windows import SEGS, build_window_plan
from hispmv_tpu_torch.utils.errors import error_stats

CASES = list(small_matrix_cases())
FORMATS = ["dense", "block", "window", "ellx", "stream", "auto"]


@functools.lru_cache(maxsize=None)
def _case(name):
    return small_matrix_cases()[name]


def assert_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def batch(n, cols, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, cols)).astype(np.float32)


def golden(coo, xb, bias=None):
    y = (coo.to_scipy() @ xb.astype(np.float64).T).T
    return y if bias is None else y + bias


def assert_golden(got, coo, xb, bias=None):
    stats = error_stats(np.asarray(got), golden(coo, xb, bias), rtol=1e-3)
    assert stats.ok, (stats.num_mismatches, stats.max_rel_error)


# ---------------------------------------------------------------------------
# B2 and B8: the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _xb_blocks(ncb, B, seed=5):
    """x for B vectors in the B2 layout [ncb, 128, B]."""
    return np.random.default_rng(seed).standard_normal(
        (ncb, 128, B)).astype(np.float32)


@pytest.mark.parametrize("B", [1, 3, 8, 9])
@pytest.mark.parametrize("bh", [1, 8, 16])
def test_plain_b2_matches_pallas(bh, B):
    coo = _case("powerlaw")
    plan = build_block_plan(coo, bh)
    data3d, meta, _ = pack_chunks(plan, 16)
    xb = _xb_blocks(plan.num_col_blocks, B)
    y = spmv_chunked_batched_plain(
        torch.from_numpy(data3d), torch.from_numpy(meta),
        torch.from_numpy(xb), plan.num_row_blocks, bh, 16)
    assert y.shape == (plan.num_row_blocks, bh, B)
    jy = spmv_chunked_batched_pallas(
        jnp.asarray(data3d), jnp.asarray(meta), jnp.asarray(xb),
        plan.num_row_blocks, bh, 16, interpret=True)
    assert_close(y.numpy(), np.asarray(jy))
    # against the golden, row by row of the block tiles
    x = xb.transpose(2, 0, 1).reshape(B, -1)[:, :coo.num_cols]
    assert_golden(y.numpy().reshape(-1, B)[:coo.num_rows].T, coo, x)


def test_b2_wrapper_on_cpu_takes_plain_version_and_checks_arguments():
    plan = build_block_plan(_case("random"), 8)
    data3d, meta, _ = pack_chunks(plan, 16)
    args = (torch.from_numpy(data3d), torch.from_numpy(meta),
            torch.from_numpy(_xb_blocks(plan.num_col_blocks, 4)),
            plan.num_row_blocks, 8, 16)
    before = spmv_chunked_batched.launches
    torch.testing.assert_close(spmv_chunked_batched(*args),
                               spmv_chunked_batched_plain(*args), rtol=0,
                               atol=0)
    assert spmv_chunked_batched.launches == before
    for vpt in (0, 1, 4, 8):  # V is the kernel's; the plain one ignores it
        torch.testing.assert_close(spmv_chunked_batched(*args, vpt=vpt),
                                   spmv_chunked_batched_plain(*args),
                                   rtol=0, atol=0)
    assert spmv_chunked_batched.launches == before
    for vpt in (2, 3, 16):
        with pytest.raises(ValueError, match=f"vpt={vpt}"):
            spmv_chunked_batched(*args, vpt=vpt)
    with pytest.raises(ValueError, match="B"):
        spmv_chunked_batched(args[0], args[1], args[2][:, :, 0], *args[3:])
    with pytest.raises(ValueError, match="no kernel"):
        spmv_chunked_batched(*(a.to("meta") for a in args[:3]), *args[3:])


def _xt(xb):
    """[B, C] -> x vector-minor [C/128, 128, B], B8's x."""
    return torch.from_numpy(xb).T.reshape(-1, 128, xb.shape[0]).contiguous()


@pytest.mark.parametrize("B", [1, 3, 8, 9])
@pytest.mark.parametrize("bh", [1, 8, 16])
def test_plain_b8_matches_pallas(bh, B):
    coo = _case("banded")
    plan = build_window_plan(coo, bh)
    data3d, subidx3d, meta, _ = pack_window_chunks(plan, 16)
    xb = batch(B, plan.num_windows * SEGS * 128, seed=6)
    xt = _xt(xb)
    assert xt.shape == (plan.num_windows * SEGS, 128, B)
    # the same x as the TPU kernel's packed [nwin*8, B*128], value for value
    xp = np.asarray(jpack_batch_x(jnp.asarray(xb), plan.num_windows))
    np.testing.assert_array_equal(
        xt.permute(0, 2, 1).reshape(plan.num_windows * SEGS, B * 128).numpy(),
        xp)
    y = spmv_windowed_batched_plain(
        torch.from_numpy(data3d), torch.from_numpy(subidx3d),
        torch.from_numpy(meta), xt, plan.num_row_blocks, bh, 16)
    assert y.shape == (plan.num_row_blocks, bh, B)
    jy = spmv_windowed_batched_pallas(
        jnp.asarray(data3d), jnp.asarray(subidx3d), jnp.asarray(meta),
        jnp.asarray(xp), plan.num_row_blocks, bh, 16, interpret=True)
    assert_close(y.numpy(), np.asarray(jy))
    assert_golden(y.numpy().reshape(-1, B)[:coo.num_rows].T, coo,
                  xb[:, :coo.num_cols])


def test_b8_wrapper_on_cpu_takes_plain_version_and_checks_arguments():
    plan = build_window_plan(_case("random"), 8)
    data3d, subidx3d, meta, _ = pack_window_chunks(plan, 16)
    xb = batch(2, plan.num_windows * SEGS * 128, seed=7)
    args = (torch.from_numpy(data3d), torch.from_numpy(subidx3d),
            torch.from_numpy(meta), _xt(xb), plan.num_row_blocks, 8, 16)
    before = spmv_windowed_batched.launches
    torch.testing.assert_close(spmv_windowed_batched(*args),
                               spmv_windowed_batched_plain(*args), rtol=0,
                               atol=0)
    for vpt in (0, 1, 4, 8):  # V is the kernel's; the plain one ignores it
        torch.testing.assert_close(spmv_windowed_batched(*args, vpt=vpt),
                                   spmv_windowed_batched_plain(*args),
                                   rtol=0, atol=0)
    assert spmv_windowed_batched.launches == before
    for vpt in (2, 3, 16):
        with pytest.raises(ValueError, match=f"vpt={vpt}"):
            spmv_windowed_batched(*args, vpt=vpt)
    xt = args[3]
    for bad in (xt[:, :100], xt[:, :, 0], xt[1:],
                xt.permute(0, 2, 1).reshape(xt.shape[0], -1)):
        with pytest.raises(ValueError, match="B\\]"):
            spmv_windowed_batched(*args[:3], bad, *args[4:])
    with pytest.raises(TypeError, match="subidx"):
        spmv_windowed_batched(args[0], args[1].long(), *args[2:])
    with pytest.raises(TypeError, match="x float32"):
        spmv_windowed_batched(*args[:3], xt.double(), *args[4:])
    with pytest.raises(ValueError, match="no kernel"):
        spmv_windowed_batched(*(a.to("meta") for a in args[:4]), *args[4:])


# ---------------------------------------------------------------------------
# ELLX
# ---------------------------------------------------------------------------


def _heavy_row_coo():
    """One heavy row, so that its row-block spills past k_base."""
    coo = random_coo(4096, 4096, 4096, seed=3)
    rows = np.concatenate([coo.rows, np.full(4096, 7, np.int32)])
    cols = np.concatenate([coo.cols, np.arange(4096, dtype=np.int32)])
    vals = np.concatenate([coo.values, np.ones(4096, np.float32)])
    return COOMatrix(coo.shape, rows, cols, vals)


@pytest.mark.parametrize("bh", [1, 8])
def test_ellx_matvec_batched_with_overflow_matches_jax(bh, monkeypatch):
    coo = _heavy_row_coo()
    eplan = build_ellx_plan(build_block_plan(coo, bh))
    assert eplan.overflow is not None
    odata, ometa, _ = pack_chunks(eplan.overflow, 16)
    d = {"base_data": eplan.base_data, "base_cols": eplan.base_cols,
         "odata": odata, "ometa": ometa, "ov_expand": eplan.ov_expand}
    xb = _xb_blocks(eplan.num_col_blocks, 5, seed=8)
    args = (eplan.num_row_blocks, bh, 16, eplan.overflow.num_row_blocks)
    jy = np.asarray(jellx_batched({k: jnp.asarray(v) for k, v in d.items()},
                                  jnp.asarray(xb), *args, interpret=True))
    td = {k: torch.from_numpy(v) for k, v in d.items()}
    y = ellx_matvec_batched(td, torch.from_numpy(xb), *args)
    assert_close(y.numpy(), jy)
    # a small gather cap splits the base product into many groups: same y
    monkeypatch.setattr("hispmv_tpu_torch.ops.spmv_ellx.BASE_GATHER_BYTES",
                        3 * eplan.k_base * 128 * 5 * 4)
    assert_close(ellx_matvec_batched(td, torch.from_numpy(xb), *args).numpy(),
                 jy)


# ---------------------------------------------------------------------------
# the handle and the Accelerator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", CASES)
def test_linear_matches_jax(name, fmt):
    coo = _case(name)
    jh = JSpmvHandle(coo, format=fmt)
    h = SpmvHandle(coo, format=fmt, device="cpu")
    assert h.format == jh.format
    xb = batch(3, coo.num_cols, seed=11)
    bias = np.random.default_rng(12).standard_normal(
        coo.num_rows).astype(np.float32)
    y = h.linear(xb, bias)
    assert y.dtype == torch.float32 and y.shape == (3, coo.num_rows)
    assert_close(y.numpy(), np.asarray(jh.linear(xb, bias)))
    assert_golden(y.numpy(), coo, xb, bias)
    # a single vector comes back as [R]
    y1 = h.linear(torch.from_numpy(xb[1]), bias)
    assert y1.shape == (coo.num_rows,)
    assert_close(y1.numpy(), y[1].numpy())


@pytest.mark.parametrize("cfg", [
    SpmvConfig(col_reorder=True),
    SpmvConfig(value_dtype="bfloat16"),
    SpmvConfig(block_h=64),
], ids=["col_reorder", "bf16", "bh64"])
@pytest.mark.parametrize("fmt", ["block", "ellx", "window"])
def test_linear_configs_match_jax(fmt, cfg):
    coo = _case("powerlaw")
    jcfg = JSpmvConfig(col_reorder=cfg.col_reorder,
                       value_dtype=cfg.value_dtype, block_h=cfg.block_h)
    jh = JSpmvHandle(coo, jcfg, format=fmt)
    h = SpmvHandle(coo, cfg, format=fmt, device="cpu")
    xb = batch(4, coo.num_cols, seed=13)
    assert_close(h.linear(xb).numpy(), np.asarray(jh.linear(xb)))


def test_linear_batch_size_alternation():
    """tests/test_api.py's case: batches of 8, 16, 8 and 1 on one handle."""
    coo = random_coo(256, 192, 6000, seed=32)
    h = SpmvHandle(coo, format="block", device="cpu")
    jh = JSpmvHandle(coo, format="block")
    for i, B in enumerate([8, 16, 8, 1]):
        xb = batch(B, 192, seed=33 + i)
        y = h.linear(xb)
        assert y.shape == (B, 256)
        assert_golden(y.numpy(), coo, xb)
        if B == 8:
            assert_close(y.numpy(), np.asarray(jh.linear(xb)))


def test_linear_rejects_wrong_width():
    h = SpmvHandle(_case("random"), format="block", device="cpu")
    with pytest.raises(ValueError, match="columns"):
        h.linear(np.ones((2, h.shape[1] + 1), np.float32))


def test_accelerator_linear_matches_jax():
    coo = _case("banded")
    w = np.random.default_rng(19).standard_normal((48, 300)).astype(
        np.float32)
    acc, jacc = Accelerator(device="cpu"), JAccelerator()
    for a in (acc, jacc):
        assert a.create_sparse_handle(coo, format="window") == 0
        assert a.create_dense_handle(w) == 1
        a.load_matrices()
    xb = batch(5, 300, seed=20)
    bias = np.arange(48, dtype=np.float32)
    for mid, b in ((0, None), (1, bias)):
        y = acc.linear(mid, xb, b)
        assert_close(y.numpy(), np.asarray(jacc.linear(mid, xb, b)))
    y = acc.linear(1, xb, bias)
    np.testing.assert_allclose(
        y.numpy(), xb.astype(np.float64) @ w.T.astype(np.float64) + bias,
        rtol=1e-3, atol=1e-4)
    # linear leaves the selected matrix alone
    assert acc.handle() is acc.handle(0)
