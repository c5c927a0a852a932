"""B1 (the chunked block stream) in the port against the JAX package: the
planner and packer give identical arrays, and the plain PyTorch version of
the kernel matches ``spmv_chunked_pallas`` in interpret mode on the same
arrays.  B1 is B2 at one vector (its CUDA kernel is B2's at batch 1), and
both packages hold that identity.  Tolerance: both sides are fp32 and
differ only in the order of summation, so rtol=1e-5, atol=1e-5*max(1,
max|y|); against the float64 golden (of the bf16-rounded values for a bf16
payload), ``error_stats`` at rtol=1e-3, the reference's acceptance."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from conftest import small_matrix_cases

from hispmv_tpu.ops.spmv_chunked import pack_chunks as jpack_chunks
from hispmv_tpu.ops.spmv_chunked import (
    spmv_chunked_batched_pallas,
    spmv_chunked_pallas,
)
from hispmv_tpu.plan.blocks import build_block_plan as jbuild_block_plan
from hispmv_tpu_torch.ops.spmv_chunked import (
    VPT_CHOICES,
    chunk_for,
    pack_chunks,
    spmv_chunked,
    spmv_chunked_batched_plain,
    spmv_chunked_plain,
)
from hispmv_tpu_torch.plan.blocks import build_block_plan
from hispmv_tpu_torch.utils.errors import error_stats

CHUNK = 16  # small chunks keep interpret mode fast (tests/test_windowed.py)
CASES = list(small_matrix_cases())


@functools.lru_cache(maxsize=None)
def _case(name):
    return small_matrix_cases()[name]


def assert_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def assert_same_plan(a, b):
    for f in ("shape", "nnz", "block_h", "num_row_blocks", "num_col_blocks"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("data", "block_rows", "block_cols", "block_firsts",
              "block_lasts"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def assert_golden(y, coo, x, dtype):
    """y [nrb, bh] (rows past the matrix's are padding) within rtol 1e-3 of
    the float64 product, with the values rounded as the payload is."""
    vals = torch.from_numpy(coo.values).to(getattr(torch, dtype)).double()
    a = sp.coo_matrix((vals.numpy(), (coo.rows, coo.cols)), shape=coo.shape)
    want = a @ x[: coo.shape[1]].astype(np.float64)
    stats = error_stats(np.asarray(y).reshape(-1)[: coo.shape[0]], want,
                        rtol=1e-3)
    assert stats.ok, (stats.num_mismatches, stats.max_rel_error)


def x2d_for(plan, seed=0):
    x = np.zeros(plan.num_col_blocks * 128, np.float32)
    x[: plan.shape[1]] = np.random.default_rng(seed).standard_normal(
        plan.shape[1]
    )
    return x.reshape(-1, 128)


def run_both(plan, jplan, chunk, dtype="float32"):
    """(port y, JAX y) of B1 on the same packed arrays."""
    data3d, meta, _ = pack_chunks(plan, chunk)
    jdata, jmeta, _ = jpack_chunks(jplan, chunk, dtype=dtype)
    tdata = torch.from_numpy(data3d)
    if dtype == "bfloat16":
        tdata = tdata.to(torch.bfloat16)
    np.testing.assert_array_equal(
        tdata.float().numpy(), np.asarray(jdata, np.float32)
    )
    np.testing.assert_array_equal(meta, jmeta)
    x2d = x2d_for(plan)
    y = spmv_chunked_plain(tdata, torch.from_numpy(meta),
                           torch.from_numpy(x2d), plan.num_row_blocks,
                           plan.block_h, chunk)
    jy = spmv_chunked_pallas(jnp.asarray(jdata), jnp.asarray(jmeta),
                             jnp.asarray(x2d), plan.num_row_blocks,
                             plan.block_h, chunk, interpret=True)
    return y.numpy(), np.asarray(jy)


@pytest.mark.parametrize("bh", [1, 8])
@pytest.mark.parametrize("name", CASES)
def test_block_plan_and_pack_equal(name, bh):
    coo = _case(name)
    plan, jplan = build_block_plan(coo, bh), jbuild_block_plan(coo, bh)
    assert_same_plan(plan, jplan)
    chunk = chunk_for(bh)
    for a, b in zip(pack_chunks(plan, chunk), jpack_chunks(jplan, chunk)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh", [1, 8])
@pytest.mark.parametrize("name", ["banded", "random", "powerlaw", "tiny",
                                  "single_dense_row"])
def test_plain_b1_matches_pallas(name, bh, dtype):
    coo = _case(name)
    y, jy = run_both(build_block_plan(coo, bh), jbuild_block_plan(coo, bh),
                     CHUNK, dtype)
    assert_close(y, jy)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh", [1, 8, 64])
@pytest.mark.parametrize("name", CASES)
def test_b1_is_b2_at_one_vector(name, bh, dtype):
    """x2d [ncb, 128] is B2's xb [ncb, 128, 1] and y [nrb, bh] its y[..., 0]:
    the identity B1's CUDA route rests on, in the port's plain versions and
    in the JAX package's Pallas kernels on the same packed arrays."""
    coo = _case(name)
    plan, jplan = build_block_plan(coo, bh), jbuild_block_plan(coo, bh)
    data3d, meta, _ = pack_chunks(plan, CHUNK)
    jdata, jmeta, _ = jpack_chunks(jplan, CHUNK, dtype=dtype)
    tdata = torch.from_numpy(data3d).to(getattr(torch, dtype))
    x2d = x2d_for(plan)
    nrb = plan.num_row_blocks
    args = (tdata, torch.from_numpy(meta), torch.from_numpy(x2d))
    y1 = spmv_chunked_plain(*args, nrb, bh, CHUNK).numpy()
    y2 = spmv_chunked_batched_plain(*args[:2], args[2][:, :, None], nrb, bh,
                                    CHUNK)
    assert y2.shape == (nrb, bh, 1)
    jargs = (jnp.asarray(jdata), jnp.asarray(jmeta))
    jy1 = np.asarray(spmv_chunked_pallas(*jargs, jnp.asarray(x2d), nrb, bh,
                                         CHUNK, interpret=True))
    jy2 = np.asarray(spmv_chunked_batched_pallas(
        *jargs, jnp.asarray(x2d[:, :, None]), nrb, bh, CHUNK,
        interpret=True))
    assert jy2.shape == (nrb, bh, 1)
    for got in (y2[..., 0].numpy(), jy1, jy2[..., 0]):
        assert_close(got, y1)
    assert_golden(y1, coo, x2d.reshape(-1), dtype)


def test_b1_row_block_spans_chunks():
    # single_dense_row: row 50 touches all 16 column blocks, so at bh=8 and
    # chunk=8 its row-block runs across a chunk boundary unflushed
    coo = _case("single_dense_row")
    plan = build_block_plan(coo, 8)
    _, meta, _ = pack_chunks(plan, 8)
    rows, last = meta[:, 0, :] >> 1, meta[:, 0, :] & 1
    spans = (rows[:-1, -1] == rows[1:, 0]) & (last[:-1, -1] == 0)
    assert spans.any()
    y, jy = run_both(plan, jbuild_block_plan(coo, 8), 8)
    assert_close(y, jy)


def test_b1_padding_blocks():
    coo = _case("blocked")
    plan = build_block_plan(coo, 8)
    chunk = 40
    assert plan.num_blocks % chunk != 0
    data3d, meta, nch = pack_chunks(plan, chunk)
    pad = nch * chunk - plan.num_blocks
    flat_rows = meta[:, 0, :].reshape(-1)
    assert (flat_rows[-pad:] == plan.block_rows[-1] * 2).all()  # last=0
    assert not data3d.reshape(-1, 8, 128)[-pad:].any()
    y, jy = run_both(plan, jbuild_block_plan(coo, 8), chunk)
    assert_close(y, jy)


def _tensors(bh=8, chunk=CHUNK):
    plan = build_block_plan(_case("random"), bh)
    data3d, meta, _ = pack_chunks(plan, chunk)
    return (torch.from_numpy(data3d), torch.from_numpy(meta),
            torch.from_numpy(x2d_for(plan)), plan.num_row_blocks, bh, chunk)


def test_wrapper_on_cpu_takes_plain_version():
    args = _tensors()
    before = spmv_chunked.launches
    torch.testing.assert_close(spmv_chunked(*args),
                               spmv_chunked_plain(*args), rtol=0, atol=0)
    assert spmv_chunked.launches == before


def test_wrapper_rejects_bad_arguments():
    data, meta, x2d, nrb, bh, chunk = _tensors()
    with pytest.raises(TypeError):
        spmv_chunked(data.double(), meta, x2d, nrb, bh, chunk)
    with pytest.raises(TypeError):
        spmv_chunked(data, meta.long(), x2d, nrb, bh, chunk)
    with pytest.raises(ValueError):
        spmv_chunked(data, meta, x2d, nrb, bh, chunk * 2)
    with pytest.raises(ValueError):
        spmv_chunked(data, meta, x2d.reshape(-1, 64), nrb, bh, chunk)


def test_wrapper_off_cpu_never_takes_plain_version():
    data, meta, x2d, nrb, bh, chunk = _tensors()
    on_meta = [t.to("meta") for t in (data, meta, x2d)]
    with pytest.raises(ValueError, match="no kernel"):
        spmv_chunked(*on_meta, nrb, bh, chunk)


def test_wrapper_vpt_on_cpu():
    """``vpt`` takes what the launcher takes (0 picks; 1, 4 or 8 names V),
    which the plain version ignores, and nothing else."""
    args = _tensors()
    want = spmv_chunked_plain(*args)
    assert VPT_CHOICES == (0, 1, 4, 8)
    for vpt in VPT_CHOICES:
        torch.testing.assert_close(spmv_chunked(*args, vpt=vpt), want,
                                   rtol=0, atol=0)
    for vpt in (2, 3, 16, -1):
        with pytest.raises(ValueError, match=f"vpt={vpt}"):
            spmv_chunked(*args, vpt=vpt)
