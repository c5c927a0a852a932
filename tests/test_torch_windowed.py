"""B7 (the windowed block stream) in the port against the JAX package: the
window planner and packer give identical arrays, and the plain PyTorch
version of the kernel matches ``spmv_windowed_pallas`` in interpret mode on
the same arrays, for bh 1, 8 and 64.  Tolerance: fp32 on both sides, only
the order of summation differs: rtol=1e-5, atol=1e-5*max(1, max|y|)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import small_matrix_cases

from hispmv_tpu.ops.spmv_windowed import (
    pack_window_chunks as jpack_window_chunks,
)
from hispmv_tpu.ops.spmv_windowed import spmv_windowed_pallas
from hispmv_tpu.plan.windows import build_window_plan as jbuild_window_plan
from hispmv_tpu_torch.ops.spmv_windowed import (
    chunk_for_windowed,
    pack_window_chunks,
    spmv_windowed,
    spmv_windowed_plain,
)
from hispmv_tpu_torch.plan.windows import SEGS, build_window_plan

CHUNK = 16
CASES = list(small_matrix_cases())


@functools.lru_cache(maxsize=None)
def _case(name):
    return small_matrix_cases()[name]


def assert_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def x2d_for(plan, seed=0):
    x = np.zeros(plan.num_windows * SEGS * 128, np.float32)
    x[: plan.shape[1]] = np.random.default_rng(seed).standard_normal(
        plan.shape[1]
    )
    return x.reshape(-1, 128)


def run_both(plan, jplan, chunk, dtype="float32"):
    """(port y, JAX y) of B7 on the same packed arrays."""
    data3d, subidx3d, meta, _ = pack_window_chunks(plan, chunk)
    jdata, jsub, jmeta, _ = jpack_window_chunks(jplan, chunk, dtype=dtype)
    tdata = torch.from_numpy(data3d)
    if dtype == "bfloat16":
        tdata = tdata.to(torch.bfloat16)
    np.testing.assert_array_equal(
        tdata.float().numpy(), np.asarray(jdata, np.float32)
    )
    np.testing.assert_array_equal(subidx3d, jsub)
    np.testing.assert_array_equal(meta, jmeta)
    x2d = x2d_for(plan)
    y = spmv_windowed_plain(tdata, torch.from_numpy(subidx3d),
                            torch.from_numpy(meta), torch.from_numpy(x2d),
                            plan.num_row_blocks, plan.block_h, chunk)
    jy = spmv_windowed_pallas(jnp.asarray(jdata), jnp.asarray(jsub),
                              jnp.asarray(jmeta), jnp.asarray(x2d),
                              plan.num_row_blocks, plan.block_h, chunk,
                              interpret=True)
    return y.numpy(), np.asarray(jy)


@pytest.mark.parametrize("bh", [1, 8, 64])
@pytest.mark.parametrize("name", CASES)
def test_window_plan_and_pack_equal(name, bh):
    coo = _case(name)
    plan, jplan = build_window_plan(coo, bh), jbuild_window_plan(coo, bh)
    for f in ("shape", "nnz", "block_h", "num_row_blocks", "num_windows"):
        assert getattr(plan, f) == getattr(jplan, f), f
    for f in ("data", "subidx", "block_rows", "block_wins", "block_firsts",
              "block_lasts"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(jplan, f),
                                      err_msg=f)
    chunk = chunk_for_windowed(bh)
    for a, b in zip(pack_window_chunks(plan, chunk),
                    jpack_window_chunks(jplan, chunk)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh", [1, 8, 64])
@pytest.mark.parametrize("name", ["banded", "powerlaw", "wide", "tiny"])
def test_plain_b7_matches_pallas(name, bh, dtype):
    coo = _case(name)
    y, jy = run_both(build_window_plan(coo, bh),
                     jbuild_window_plan(coo, bh), CHUNK, dtype)
    assert_close(y, jy)


def test_b7_row_block_spans_chunks():
    # single_dense_row: row 50 covers two 1024-column windows with 8 layers
    # each, so at chunk=8 its row-block runs across a chunk boundary
    coo = _case("single_dense_row")
    plan = build_window_plan(coo, 8)
    _, _, meta, _ = pack_window_chunks(plan, 8)
    rows, last = meta[:, 0, :] >> 1, meta[:, 0, :] & 1
    assert ((rows[:-1, -1] == rows[1:, 0]) & (last[:-1, -1] == 0)).any()
    y, jy = run_both(plan, jbuild_window_plan(coo, 8), 8)
    assert_close(y, jy)


def test_b7_padding_blocks():
    coo = _case("random")
    plan = build_window_plan(coo, 8)
    chunk = 24
    assert plan.num_blocks % chunk != 0
    data3d, subidx3d, meta, nch = pack_window_chunks(plan, chunk)
    pad = nch * chunk - plan.num_blocks
    assert (meta[:, 0, :].reshape(-1)[-pad:] == plan.block_rows[-1] * 2).all()
    assert not data3d.reshape(-1, 8, 128)[-pad:].any()
    y, jy = run_both(plan, jbuild_window_plan(coo, 8), chunk)
    assert_close(y, jy)


def _tensors(bh=8, chunk=CHUNK):
    plan = build_window_plan(_case("powerlaw"), bh)
    data3d, subidx3d, meta, _ = pack_window_chunks(plan, chunk)
    return (torch.from_numpy(data3d), torch.from_numpy(subidx3d),
            torch.from_numpy(meta), torch.from_numpy(x2d_for(plan)),
            plan.num_row_blocks, bh, chunk)


def test_wrapper_on_cpu_takes_plain_version():
    args = _tensors()
    before = spmv_windowed.launches
    torch.testing.assert_close(spmv_windowed(*args),
                               spmv_windowed_plain(*args), rtol=0, atol=0)
    assert spmv_windowed.launches == before


def test_wrapper_rejects_bad_arguments():
    data, sub, meta, x2d, nrb, bh, chunk = _tensors()
    with pytest.raises(TypeError):
        spmv_windowed(data, sub.long(), meta, x2d, nrb, bh, chunk)
    with pytest.raises(ValueError):
        spmv_windowed(data, sub[:, :8], meta, x2d, nrb, bh, chunk)
    with pytest.raises(ValueError):
        spmv_windowed(data, sub, meta, x2d, nrb, 4, chunk)


def test_wrapper_off_cpu_never_takes_plain_version():
    data, sub, meta, x2d, nrb, bh, chunk = _tensors()
    on_meta = [t.to("meta") for t in (data, sub, meta, x2d)]
    with pytest.raises(ValueError, match="no kernel"):
        spmv_windowed(*on_meta, nrb, bh, chunk)
