"""B5 and B6 (the per-block block stream, one vector and a batch) in the port
against the JAX package: the plain PyTorch versions against
``spmv_block_pallas`` / ``spmv_block_batched_pallas`` in interpret mode on
identical plan arrays, the one-shot ``spmv_block`` against JAX's (with
``col_reorder``, alpha, beta and y_in), and all of them against the
float64 golden.

Port against JAX: rtol=1e-5, atol=1e-5*max(1, max|y|) (fp32 on both sides,
only the order of summation differs).  Against the golden: rtol=1e-3, the
reference's acceptance, with atol=1e-5*max(1, max|y|)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import small_matrix_cases

import hispmv_tpu_torch.ops as ops
from hispmv_tpu.ops.spmv_block import spmv_block as jspmv_block
from hispmv_tpu.ops.spmv_block import (
    spmv_block_batched_pallas,
    spmv_block_pallas,
)
from hispmv_tpu.plan.blocks import build_block_plan as jbuild_block_plan
from hispmv_tpu.plan.blocks import degree_column_perm as jdegree_column_perm
from hispmv_tpu_torch.ops.spmv_block import (
    run_starts,
    spmv_block,
    spmv_block_batched,
    spmv_block_batched_plain,
    spmv_block_stream,
    spmv_block_stream_plain,
)
from hispmv_tpu_torch.plan.blocks import build_block_plan, degree_column_perm

CASES = list(small_matrix_cases())


@functools.lru_cache(maxsize=None)
def _case(name):
    return small_matrix_cases()[name]


def assert_close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float64)
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def golden(coo, x):
    return coo.to_scipy() @ np.asarray(x, np.float64)


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _stream(plan):
    """The plan's stream arrays as (numpy, torch) tuples."""
    arrays = (plan.data, plan.block_rows, plan.block_cols,
              plan.block_firsts, plan.block_lasts)
    return arrays, tuple(torch.from_numpy(a) for a in arrays)


def _b5_both(plan, x_blocks):
    arrays, tarrays = _stream(plan)
    y = spmv_block_stream_plain(*tarrays, torch.from_numpy(x_blocks),
                                plan.num_row_blocks)
    jy = spmv_block_pallas(*(jnp.asarray(a) for a in arrays),
                           jnp.asarray(x_blocks), plan.num_row_blocks,
                           interpret=True)
    return y.numpy(), np.asarray(jy)


def _x_blocks(plan, seed=0, batch=None):
    C = plan.num_col_blocks * 128
    x = np.zeros((C,) if batch is None else (C, batch), np.float32)
    shape = (plan.shape[1],) if batch is None else (plan.shape[1], batch)
    x[: plan.shape[1]] = np.random.default_rng(seed).standard_normal(shape)
    if batch is None:
        return x.reshape(-1, 1, 128)
    return x.reshape(-1, 128, batch)


@pytest.mark.parametrize("bh", [1, 8])
@pytest.mark.parametrize("name", CASES)
def test_plain_b5_matches_pallas(name, bh):
    coo = _case(name)
    plan = build_block_plan(coo, bh)
    xb = _x_blocks(plan)
    y, jy = _b5_both(plan, xb)
    assert y.shape == jy.shape == (plan.num_row_blocks, 1, bh)
    assert_close(y, jy)
    x = xb.reshape(-1)[: coo.num_cols]
    assert_close(y.reshape(-1)[: coo.num_rows], golden(coo, x), rtol=1e-3)


def _b6_both(arrays, xb, nrb):
    """B6's plain version and the Pallas kernel (interpret mode) on the
    same stream arrays and x [ncb, 128, B]."""
    y = spmv_block_batched_plain(*(torch.from_numpy(a) for a in arrays),
                                 torch.from_numpy(xb), nrb)
    jy = spmv_block_batched_pallas(*(jnp.asarray(a) for a in arrays),
                                   jnp.asarray(xb), nrb, interpret=True)
    return y.numpy(), np.asarray(jy)


# (B, bh): bh 8 at B 1, 7, 64 keeps its first ids
B6_SHAPES = [pytest.param(B, 8, id=str(B)) for B in (1, 7, 64)] + [
    pytest.param(B, bh, id=f"{B}-bh{bh}")
    for B, bh in ((9, 8), (130, 8), (1, 16), (9, 16), (130, 16))]


@pytest.mark.parametrize("B,bh", B6_SHAPES)
@pytest.mark.parametrize("name", ["banded", "random", "powerlaw", "wide",
                                  "tiny", "single_dense_row"])
def test_plain_b6_matches_pallas(name, B, bh):
    coo = _case(name)
    plan = build_block_plan(coo, bh)
    xb = _x_blocks(plan, seed=B, batch=B)
    arrays, _ = _stream(plan)
    y, jy = _b6_both(arrays, xb, plan.num_row_blocks)
    assert y.shape == (plan.num_row_blocks, bh, B)
    assert_close(y, jy)
    # vector b of the batch against the golden
    want = golden(coo, xb.reshape(-1, B)[: coo.num_cols])
    got = y.reshape(-1, B)[: coo.num_rows]
    assert_close(got, want, rtol=1e-3)


@pytest.mark.parametrize("col_reorder", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_one_shot_spmv_block_matches_jax(name, col_reorder):
    coo = _case(name)
    perm = degree_column_perm(coo) if col_reorder else None
    jperm = jdegree_column_perm(coo) if col_reorder else None
    plan = build_block_plan(coo, 8, col_perm=perm)
    jplan = jbuild_block_plan(coo, 8, col_perm=jperm)
    x, y_in = _x(coo.num_cols, 1), _x(coo.num_rows, 2)
    y = spmv_block(plan, x, y_in, 1.5, -0.5, device="cpu")
    jy = jspmv_block(jplan, x, y_in, 1.5, -0.5, interpret=True)
    assert y.dtype == torch.float32 and y.shape == (coo.num_rows,)
    assert_close(y.numpy(), np.asarray(jy))
    assert_close(y.numpy(), 1.5 * golden(coo, x) - 0.5 * y_in, rtol=1e-3)
    # without y_in: alpha * A @ x only
    assert_close(spmv_block(plan, x, alpha=2.0, device="cpu").numpy(),
                 2.0 * golden(coo, x), rtol=1e-3)


def test_ops_package_exports():
    assert ops.spmv_block is spmv_block
    assert ops.spmv_block_stream is spmv_block_stream
    assert ops.spmv_block_batched is spmv_block_batched
    for name in ("gemv", "spmv_ref", "finalize_ref"):
        assert callable(getattr(ops, name))


def _padded_stream():
    """A stream as the sharded planner leaves it: real blocks, then padding
    blocks on the last row-block with first = last = 0.  The padding here
    carries a NONZERO payload, so a version that read it would differ."""
    plan = build_block_plan(_case("random"), 8)
    n, pad = plan.num_blocks, 5
    data = np.concatenate([plan.data, np.ones((pad, 8, 128), np.float32)])
    rows = np.concatenate([plan.block_rows,
                           np.full(pad, plan.block_rows[-1], np.int32)])
    cols = np.concatenate([plan.block_cols, np.zeros(pad, np.int32)])
    zeros = np.zeros(pad, np.int32)
    firsts = np.concatenate([plan.block_firsts, zeros])
    lasts = np.concatenate([plan.block_lasts, zeros])
    assert n > 1
    return plan, (data, rows, cols, firsts, lasts)


def test_b5_skips_blocks_after_the_last_flag():
    plan, arrays = _padded_stream()
    xb = _x_blocks(plan)
    y = spmv_block_stream_plain(*(torch.from_numpy(a) for a in arrays),
                                torch.from_numpy(xb), plan.num_row_blocks)
    jy = spmv_block_pallas(*(jnp.asarray(a) for a in arrays), jnp.asarray(xb),
                           plan.num_row_blocks, interpret=True)
    assert_close(y.numpy(), np.asarray(jy))
    plain, _ = _b5_both(plan, xb)
    np.testing.assert_array_equal(y.numpy(), plain)


def test_b5_run_without_last_flag_stores_nothing():
    # row-block 0's run loses its last flag: the TPU grid re-zeroes its
    # accumulator at the next first flag and never writes y[0]
    plan = build_block_plan(_case("banded"), 8)
    lasts = plan.block_lasts.copy()
    end0 = int(np.flatnonzero(lasts)[0])
    lasts[end0] = 0
    xb = _x_blocks(plan)
    arrays = (plan.data, plan.block_rows, plan.block_cols, plan.block_firsts,
              lasts)
    y = spmv_block_stream_plain(*(torch.from_numpy(a) for a in arrays),
                                torch.from_numpy(xb), plan.num_row_blocks)
    jy = spmv_block_pallas(*(jnp.asarray(a) for a in arrays), jnp.asarray(xb),
                           plan.num_row_blocks, interpret=True)
    assert not y[0].any()
    assert_close(y.numpy()[1:], np.asarray(jy)[1:])


def test_b5_empty_shard_block_stores_zero():
    # the sharded planner's empty shard: one zero block on row-block 0
    data = np.zeros((3, 8, 128), np.float32)
    rows = np.zeros(3, np.int32)
    cols = np.zeros(3, np.int32)
    firsts = np.array([1, 0, 0], np.int32)
    lasts = np.array([1, 0, 0], np.int32)
    xb = np.ones((1, 1, 128), np.float32)
    y = spmv_block_stream_plain(*(torch.from_numpy(a) for a in
                                  (data, rows, cols, firsts, lasts)),
                                torch.from_numpy(xb), 2)
    assert y.shape == (2, 1, 8) and not y.any()


@pytest.mark.parametrize("B", [1, 9])
def test_b6_skips_blocks_after_the_last_flag(B):
    plan, arrays = _padded_stream()
    xb = _x_blocks(plan, batch=B)
    y, jy = _b6_both(arrays, xb, plan.num_row_blocks)
    assert_close(y, jy)
    plain, _ = _b6_both(_stream(plan)[0], xb, plan.num_row_blocks)
    np.testing.assert_array_equal(y, plain)


@pytest.mark.parametrize("B", [1, 9])
def test_b6_run_without_last_flag_stores_nothing(B):
    # as B5's: row-block 0's run loses its last flag and y[0] stays zero
    plan = build_block_plan(_case("banded"), 8)
    lasts = plan.block_lasts.copy()
    lasts[int(np.flatnonzero(lasts)[0])] = 0
    arrays = (plan.data, plan.block_rows, plan.block_cols, plan.block_firsts,
              lasts)
    y, jy = _b6_both(arrays, _x_blocks(plan, batch=B), plan.num_row_blocks)
    assert not y[0].any() and y[1:].any()
    assert_close(y[1:], jy[1:])


def test_b6_empty_shard_block_stores_zero():
    # the sharded planner's empty shard: one zero block on row-block 0,
    # which the TPU grid stores as zeros
    data = np.zeros((3, 8, 128), np.float32)
    index = np.zeros(3, np.int32)
    flags = np.array([1, 0, 0], np.int32)
    xb = np.ones((1, 128, 5), np.float32)
    y, jy = _b6_both((data, index, index, flags, flags), xb, 2)
    assert y.shape == (2, 8, 5) and not y.any()
    np.testing.assert_array_equal(y[0], jy[0])


def test_run_starts():
    firsts = np.array([1, 0, 0, 1, 1, 0], np.int32)
    np.testing.assert_array_equal(run_starts(firsts).numpy(), [0, 3, 4])
    assert run_starts(torch.from_numpy(firsts)).dtype == torch.int32
    np.testing.assert_array_equal(
        run_starts(torch.from_numpy(firsts)).numpy(), [0, 3, 4])


def _tensors(B=None):
    plan = build_block_plan(_case("random"), 8)
    _, tarrays = _stream(plan)
    xb = torch.from_numpy(_x_blocks(plan, batch=B))
    return tarrays + (xb, plan.num_row_blocks)


def test_wrappers_on_cpu_take_plain_versions():
    args = _tensors()
    before = spmv_block_stream.launches
    torch.testing.assert_close(spmv_block_stream(*args),
                               spmv_block_stream_plain(*args), rtol=0,
                               atol=0)
    assert spmv_block_stream.launches == before
    args = _tensors(B=3)
    before = spmv_block_batched.launches
    torch.testing.assert_close(spmv_block_batched(*args),
                               spmv_block_batched_plain(*args), rtol=0,
                               atol=0)
    assert spmv_block_batched.launches == before


def test_wrappers_reject_bad_arguments():
    data, rows, cols, firsts, lasts, xb, nrb = _tensors()
    with pytest.raises(TypeError):
        spmv_block_stream(data.double(), rows, cols, firsts, lasts, xb, nrb)
    with pytest.raises(TypeError):
        spmv_block_stream(data, rows.long(), cols, firsts, lasts, xb, nrb)
    with pytest.raises(ValueError):
        spmv_block_stream(data, rows[1:], cols, firsts, lasts, xb, nrb)
    with pytest.raises(ValueError):
        spmv_block_stream(data, rows, cols, firsts, lasts,
                          xb.reshape(-1, 128), nrb)
    with pytest.raises(ValueError):
        spmv_block_batched(data, rows, cols, firsts, lasts,
                           xb.reshape(-1, 1, 128), nrb)


def test_wrappers_off_cpu_never_take_plain_versions():
    data, rows, cols, firsts, lasts, xb, nrb = _tensors()
    on_meta = [t.to("meta") for t in (data, rows, cols, firsts, lasts, xb)]
    starts = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        spmv_block_stream(*on_meta, nrb, starts=starts)
    xb3 = torch.zeros((xb.shape[0], 128, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        spmv_block_batched(*on_meta[:5], xb3, nrb, starts=starts)


def test_one_shot_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    plan = build_block_plan(_case("tiny"), 8)
    with pytest.raises(RuntimeError, match="cuda"):
        spmv_block(plan, _x(plan.shape[1]))
    with pytest.raises(ValueError, match="columns"):
        spmv_block(plan, _x(plan.shape[1] + 1), device="cpu")
