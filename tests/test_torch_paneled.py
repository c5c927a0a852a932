"""B3 (the x-paneled chunked stream) in the port against the JAX package:
``pack_chunks_paneled`` gives identical arrays, and the plain PyTorch
version of the kernel matches ``spmv_chunked_paneled_pallas`` in interpret
mode on the same arrays, with a small ``panel_ncb`` so that a matrix has
several panels, for f32 and bf16 payloads.  B3 is B1 on global col ids
(its CUDA kernel is B1's with each chunk's panel offset added to its x
rows), on paneled streams and on the ring segments of the sharded chunked
plan, and both packages hold that identity.

Port against JAX: rtol=1e-5, atol=1e-5*max(1, max|y|) (fp32 accumulation on
both sides, only the order of summation differs).  Against the float64
golden (of the bf16-rounded values for a bf16 payload): rtol=1e-3."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from conftest import small_matrix_cases

from hispmv_tpu.formats.synth import powerlaw_coo as jpowerlaw_coo
from hispmv_tpu.ops.spmv_chunked import (
    pack_chunks_paneled as jpack_chunks_paneled,
)
from hispmv_tpu.ops.spmv_chunked import (
    spmv_chunked_paneled_pallas,
    spmv_chunked_pallas,
)
from hispmv_tpu.plan.blocks import build_block_plan as jbuild_block_plan
from hispmv_tpu_torch.dist import build_sharded_chunked_plan
from hispmv_tpu_torch.formats.synth import powerlaw_coo
from hispmv_tpu_torch.ops.spmv_chunked import (
    pack_chunks_paneled,
    spmv_chunked_paneled,
    spmv_chunked_paneled_plain,
    spmv_chunked_plain,
)
from hispmv_tpu_torch.plan.blocks import build_block_plan
from hispmv_tpu_torch.utils.errors import error_stats

CHUNK = 16
CASES = list(small_matrix_cases())


@functools.lru_cache(maxsize=None)
def _case(name):
    if name == "wide_powerlaw":  # several panels at panel_ncb 2-4
        return powerlaw_coo(600, 3000, 25_000, seed=30)
    return small_matrix_cases()[name]


def assert_close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float64)
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _x2d(plan, panel_ncb, seed=0):
    npanels = -(-plan.num_col_blocks // panel_ncb)
    x = np.zeros(npanels * panel_ncb * 128, np.float32)
    x[: plan.shape[1]] = np.random.default_rng(seed).standard_normal(
        plan.shape[1])
    return x.reshape(-1, 128)


@pytest.mark.parametrize("panel_ncb", [2, 3, 4])
@pytest.mark.parametrize("name", CASES + ["wide_powerlaw"])
def test_pack_chunks_paneled_equal(name, panel_ncb):
    coo = _case(name)
    plan, jplan = build_block_plan(coo, 8), jbuild_block_plan(coo, 8)
    got = pack_chunks_paneled(plan, CHUNK, panel_ncb)
    want = jpack_chunks_paneled(jplan, CHUNK, panel_ncb)
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("panel_ncb", [2, 4])
@pytest.mark.parametrize("name", ["wide_powerlaw", "wide", "single_dense_row",
                                  "banded", "tiny"])
def test_plain_b3_matches_pallas(name, panel_ncb, dtype):
    coo = _case(name)
    plan, jplan = build_block_plan(coo, 8), jbuild_block_plan(coo, 8)
    data3d, meta, panels, _ = pack_chunks_paneled(plan, CHUNK, panel_ncb)
    jdata, jmeta, jpanels, _ = jpack_chunks_paneled(jplan, CHUNK, panel_ncb,
                                                    dtype=dtype)
    tdata = torch.from_numpy(data3d)
    if dtype == "bfloat16":
        tdata = tdata.to(torch.bfloat16)
    np.testing.assert_array_equal(tdata.float().numpy(),
                                  np.asarray(jdata, np.float32))
    x2d = _x2d(plan, panel_ncb)
    y = spmv_chunked_paneled_plain(
        tdata, torch.from_numpy(meta), torch.from_numpy(panels),
        torch.from_numpy(x2d), plan.num_row_blocks, 8, CHUNK, panel_ncb)
    jy = spmv_chunked_paneled_pallas(
        jnp.asarray(jdata), jnp.asarray(jmeta), jnp.asarray(jpanels),
        jnp.asarray(x2d), plan.num_row_blocks, 8, CHUNK, panel_ncb,
        interpret=True)
    assert y.shape == (plan.num_row_blocks, 8)
    assert_close(y.numpy(), np.asarray(jy))
    if dtype == "float32":
        want = coo.to_scipy() @ x2d.reshape(-1)[: coo.num_cols].astype(
            np.float64)
        assert_close(y.numpy().reshape(-1)[: coo.num_rows], want, rtol=1e-3)


def fold_panels(meta, panels, panel_ncb):
    """B3's meta with each chunk's panel offset folded into its col ids:
    the global col blocks B1 reads."""
    out = meta.copy()
    out[:, 1, :] += panels[:, None] * panel_ncb
    return out


def jax_b1_by_panel(jdata, gmeta, panels, x2d, nrb, bh, chunk):
    """B1 of the JAX package on the folded stream, one y per panel summed.

    The TPU's B1 stores a row-block's sum at its flush (``y[rb] =
    rowsum(acc)``), where the port's B1 adds it; a row-block with blocks
    in several panels flushes once in each.  So row-block r of panel p
    becomes row p*nrb + r, each (panel, row-block) run flushes once, and
    the rows that flush are summed over the panels (the others hold no
    value)."""
    npan = int(panels.max()) + 1
    m = gmeta.copy()
    rows = (m[:, 0, :] >> 1) + panels[:, None] * nrb
    m[:, 0, :] = rows * 2 + (m[:, 0, :] & 1)
    y = np.asarray(spmv_chunked_pallas(
        jnp.asarray(jdata), jnp.asarray(m), jnp.asarray(x2d), npan * nrb, bh,
        chunk, interpret=True))
    flushed = np.zeros(npan * nrb, bool)
    flushed[rows[(m[:, 0, :] & 1) == 1]] = True
    y = np.where(flushed[:, None], y, 0.0)
    return y.reshape(npan, nrb, bh).sum(0)


def assert_golden(y, coo, x, dtype):
    """y [nrb, bh] (rows past the matrix's are padding) within rtol 1e-3
    of the float64 product, with the values rounded as the payload is."""
    vals = torch.from_numpy(coo.values).to(getattr(torch, dtype)).double()
    a = sp.coo_matrix((vals.numpy(), (coo.rows, coo.cols)), shape=coo.shape)
    want = a @ x[: coo.shape[1]].astype(np.float64)
    stats = error_stats(np.asarray(y).reshape(-1)[: coo.shape[0]], want,
                        rtol=1e-3)
    assert stats.ok, (stats.num_mismatches, stats.max_rel_error)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh", [1, 8, 64])
@pytest.mark.parametrize("panel_ncb", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_b3_is_b1_on_global_col_ids(name, panel_ncb, bh, dtype):
    """B3 is B1 on the stream whose col ids carry their chunk's panel
    offset: the identity B3's CUDA route rests on, in the port's plain
    versions and in the JAX package's Pallas kernels on the same packed
    arrays (its B1 a y per panel, as ``jax_b1_by_panel`` says)."""
    coo = _case(name)
    plan, jplan = build_block_plan(coo, bh), jbuild_block_plan(coo, bh)
    data3d, meta, panels, _ = pack_chunks_paneled(plan, CHUNK, panel_ncb)
    jdata, jmeta, jpanels, _ = jpack_chunks_paneled(jplan, CHUNK, panel_ncb,
                                                    dtype=dtype)
    gmeta = fold_panels(meta, panels, panel_ncb)
    tdata = torch.from_numpy(data3d).to(getattr(torch, dtype))
    x2d = _x2d(plan, panel_ncb)
    nrb = plan.num_row_blocks
    y3 = spmv_chunked_paneled_plain(
        tdata, torch.from_numpy(meta), torch.from_numpy(panels),
        torch.from_numpy(x2d), nrb, bh, CHUNK, panel_ncb).numpy()
    y1 = spmv_chunked_plain(tdata, torch.from_numpy(gmeta),
                            torch.from_numpy(x2d), nrb, bh, CHUNK).numpy()
    jy3 = np.asarray(spmv_chunked_paneled_pallas(
        jnp.asarray(jdata), jnp.asarray(jmeta), jnp.asarray(jpanels),
        jnp.asarray(x2d), nrb, bh, CHUNK, panel_ncb, interpret=True))
    jy1 = jax_b1_by_panel(jdata, gmeta, panels, x2d, nrb, bh, CHUNK)
    for got in (y3, jy3, jy1):
        assert_close(got, y1)
    assert_golden(y1, coo, x2d.reshape(-1), dtype)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_b3_on_ring_segments_is_b1(name, D):
    """Each ring segment of the sharded chunked plan, with every panel id
    0, run by B3 equals B1 on the segment (in the JAX package on device
    0's D segments, one a ring step); an empty segment (all zeros:
    row-block 0, no last flag) adds nothing."""
    plan = build_sharded_chunked_plan(_case(name), D, chunk=CHUNK)
    nch, bh, nrb = plan.data5.shape[2], plan.block_h, plan.nrb_max
    per = plan.ncb_per_shard
    x2d = np.random.default_rng(D).standard_normal(
        (per, 128)).astype(np.float32)
    zeros = np.zeros(nch, np.int32)
    for d in range(D):
        for step in range(D):
            data3d, meta = plan.data5[d, step], plan.meta5[d, step]
            args = (torch.from_numpy(data3d), torch.from_numpy(meta))
            y3 = spmv_chunked_paneled_plain(
                *args, torch.from_numpy(zeros), torch.from_numpy(x2d), nrb,
                bh, CHUNK, per).numpy()
            y1 = spmv_chunked_plain(*args, torch.from_numpy(x2d), nrb, bh,
                                    CHUNK).numpy()
            got = [y3]
            if d == 0:
                got.append(np.asarray(spmv_chunked_paneled_pallas(
                    jnp.asarray(data3d), jnp.asarray(meta),
                    jnp.asarray(zeros), jnp.asarray(x2d), nrb, bh, CHUNK,
                    per, interpret=True)))
                got.append(jax_b1_by_panel(data3d, meta, zeros, x2d, nrb, bh,
                                           CHUNK))
            for g in got:
                assert_close(g, y1)
                if not data3d.any():
                    assert not g.any()


def test_ring_segments_include_empty_and_padded_ones():
    """tall (one col block) at D 4: device 0's steps 1-3 hold empty shards,
    and its nonempty segments end in padding blocks."""
    plan = build_sharded_chunked_plan(_case("tall"), 4, chunk=CHUNK)
    bh = plan.block_h
    blocks = plan.data5.reshape(4, 4, -1, bh * 128).any(-1)  # [d, step, nb]
    assert blocks[0, 0].any() and not blocks[0, 1:].any()
    used = blocks.sum(-1)
    assert ((used > 0) & (used < blocks.shape[-1])).any()


def test_wide_powerlaw_has_several_panels():
    plan = build_block_plan(_case("wide_powerlaw"), 8)
    _, _, panels, _ = pack_chunks_paneled(plan, CHUNK, 4)
    assert len(np.unique(panels)) >= 4


def _tensors(panel_ncb=4):
    plan = build_block_plan(_case("wide_powerlaw"), 8)
    data3d, meta, panels, _ = pack_chunks_paneled(plan, CHUNK, panel_ncb)
    return (torch.from_numpy(data3d), torch.from_numpy(meta),
            torch.from_numpy(panels), torch.from_numpy(_x2d(plan, panel_ncb)),
            plan.num_row_blocks, 8, CHUNK, panel_ncb)


def test_out_adds_into_y():
    args = _tensors()
    y1 = spmv_chunked_paneled(*args)
    out = torch.ones_like(y1)
    got = spmv_chunked_paneled(*args, out=out)
    assert got is out
    torch.testing.assert_close(got, y1 + 1.0, rtol=1e-6, atol=1e-5)


def test_jax_reference_packs_the_same_matrix():
    # the port's synthetic generator gives the JAX package's matrix
    a, b = _case("wide_powerlaw"), jpowerlaw_coo(600, 3000, 25_000, seed=30)
    for f in ("rows", "cols", "values"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_wrapper_on_cpu_takes_plain_version():
    args = _tensors()
    before = spmv_chunked_paneled.launches
    torch.testing.assert_close(spmv_chunked_paneled(*args),
                               spmv_chunked_paneled_plain(*args), rtol=0,
                               atol=0)
    assert spmv_chunked_paneled.launches == before


def test_wrapper_rejects_bad_arguments():
    data, meta, panels, x2d, nrb, bh, chunk, pncb = _tensors()
    with pytest.raises(ValueError):
        spmv_chunked_paneled(data, meta, panels[1:], x2d, nrb, bh, chunk,
                             pncb)
    with pytest.raises(ValueError):
        spmv_chunked_paneled(data, meta, panels.long(), x2d, nrb, bh, chunk,
                             pncb)
    with pytest.raises(ValueError):
        spmv_chunked_paneled(data, meta, panels, x2d, nrb, bh, chunk, 0)
    with pytest.raises(ValueError):
        spmv_chunked_paneled(data, meta, panels, x2d, nrb, bh, chunk, pncb,
                             out=torch.zeros(nrb + 1, bh))
    with pytest.raises(TypeError):
        spmv_chunked_paneled(data.double(), meta, panels, x2d, nrb, bh,
                             chunk, pncb)


def test_wrapper_off_cpu_never_takes_plain_version():
    data, meta, panels, x2d, nrb, bh, chunk, pncb = _tensors()
    on_meta = [t.to("meta") for t in (data, meta, panels, x2d)]
    with pytest.raises(ValueError, match="no kernel"):
        spmv_chunked_paneled(*on_meta, nrb, bh, chunk, pncb)
