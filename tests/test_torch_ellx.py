"""ELLX in the port against the JAX package: ``build_ellx_plan`` gives an
identical plan (TPU-calibrated k_base choice included), and ``ellx_matvec``
(base product + B1 overflow + ov_expand merge) matches the JAX
``ellx_matvec`` with Pallas in interpret mode, heavy overflow included.
Tolerance: fp32 on both sides, rtol=1e-5, atol=1e-5*max(1, max|y|)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import small_matrix_cases

from hispmv_tpu.ops.spmv_chunked import pack_chunks as jpack_chunks
from hispmv_tpu.ops.spmv_ellx import build_ellx_plan as jbuild_ellx_plan
from hispmv_tpu.ops.spmv_ellx import ellx_matvec as jellx_matvec
from hispmv_tpu.plan.blocks import build_block_plan as jbuild_block_plan
from hispmv_tpu_torch.ops.spmv_chunked import pack_chunks
from hispmv_tpu_torch.ops.spmv_ellx import (
    build_ellx_plan,
    ellx_base_matvec,
    ellx_matvec,
)
from hispmv_tpu_torch.plan.blocks import build_block_plan

CHUNK = 16
CASES = list(small_matrix_cases())


@functools.lru_cache(maxsize=None)
def _case(name):
    return small_matrix_cases()[name]


def assert_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def plans(name, bh, k_base=None):
    coo = _case(name)
    return (build_ellx_plan(build_block_plan(coo, bh), k_base),
            jbuild_ellx_plan(jbuild_block_plan(coo, bh), k_base))


def x2d_for(eplan, seed=0):
    x = np.zeros(eplan.num_col_blocks * 128, np.float32)
    x[: eplan.shape[1]] = np.random.default_rng(seed).standard_normal(
        eplan.shape[1]
    )
    return x.reshape(-1, 128)


@pytest.mark.parametrize("bh", [1, 8])
@pytest.mark.parametrize("name", CASES)
def test_ellx_plan_equal(name, bh):
    p, jp = plans(name, bh)
    for f in ("shape", "nnz", "block_h", "k_base", "num_row_blocks",
              "num_col_blocks"):
        assert getattr(p, f) == getattr(jp, f), f
    for f in ("base_data", "base_cols", "ov_expand"):
        a, b = getattr(p, f), getattr(jp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert (p.overflow is None) == (jp.overflow is None)
    if p.overflow is not None:
        for f in ("data", "block_rows", "block_cols", "block_lasts"):
            np.testing.assert_array_equal(getattr(p.overflow, f),
                                          getattr(jp.overflow, f))


def run_both(name, bh, k_base=None):
    p, jp = plans(name, bh, k_base)
    x2d = x2d_for(p)
    d = {"base_data": torch.from_numpy(p.base_data),
         "base_cols": torch.from_numpy(p.base_cols)}
    jd = {"base_data": jnp.asarray(jp.base_data),
          "base_cols": jnp.asarray(jp.base_cols)}
    ov_nrb = 0
    if p.overflow is not None:
        odata, ometa, _ = pack_chunks(p.overflow, CHUNK)
        jodata, jometa, _ = jpack_chunks(jp.overflow, CHUNK)
        d.update(odata=torch.from_numpy(odata),
                 ometa=torch.from_numpy(ometa),
                 ov_expand=torch.from_numpy(p.ov_expand))
        jd.update(odata=jnp.asarray(jodata), ometa=jnp.asarray(jometa),
                  ov_expand=jnp.asarray(jp.ov_expand))
        ov_nrb = p.overflow.num_row_blocks
    y = ellx_matvec(d, torch.from_numpy(x2d), p.num_row_blocks, bh, CHUNK,
                    ov_nrb)
    jy = jellx_matvec(jd, jnp.asarray(x2d), jp.num_row_blocks, bh, CHUNK,
                      ov_nrb, interpret=True)
    return p, y.numpy(), np.asarray(jy)


@pytest.mark.parametrize("bh", [1, 8])
@pytest.mark.parametrize("name", ["banded", "powerlaw", "wide", "tall",
                                  "single_dense_row"])
def test_ellx_matvec_matches_jax(name, bh):
    _, y, jy = run_both(name, bh)
    assert_close(y, jy)


@pytest.mark.parametrize("bh", [1, 8])
@pytest.mark.parametrize("name", ["single_dense_row", "powerlaw"])
def test_ellx_heavy_overflow_matches_jax(name, bh):
    # k_base=1 spills every block past the first of each row-block into the
    # overflow stream (single_dense_row: ~2000 nnz of one row)
    p, y, jy = run_both(name, bh, k_base=1)
    assert p.overflow is not None and p.overflow.num_blocks > 10
    assert_close(y, jy)


def test_ellx_base_matvec_bf16_payload():
    p, _ = plans("blocked", 8)
    x2d = torch.from_numpy(x2d_for(p))
    cols = torch.from_numpy(p.base_cols)
    y32 = ellx_base_matvec(torch.from_numpy(p.base_data), cols, x2d)
    bf = torch.from_numpy(p.base_data).to(torch.bfloat16)
    y16 = ellx_base_matvec(bf, cols, x2d)
    want = ellx_base_matvec(bf.float(), cols, x2d)
    assert y16.dtype == torch.float32
    torch.testing.assert_close(y16, want, rtol=0, atol=0)
    assert float((y16 - y32).abs().max()) > 0  # the payload was rounded
