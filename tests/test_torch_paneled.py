"""B3 (the x-paneled chunked stream) in the port against the JAX package:
``pack_chunks_paneled`` gives identical arrays, and the plain PyTorch
version of the kernel matches ``spmv_chunked_paneled_pallas`` in interpret
mode on the same arrays, with a small ``panel_ncb`` so that a matrix has
several panels, for f32 and bf16 payloads.

Port against JAX: rtol=1e-5, atol=1e-5*max(1, max|y|) (fp32 accumulation on
both sides, only the order of summation differs).  Against the float64
golden: rtol=1e-3."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import small_matrix_cases

from hispmv_tpu.formats.synth import powerlaw_coo as jpowerlaw_coo
from hispmv_tpu.ops.spmv_chunked import (
    pack_chunks_paneled as jpack_chunks_paneled,
)
from hispmv_tpu.ops.spmv_chunked import spmv_chunked_paneled_pallas
from hispmv_tpu.plan.blocks import build_block_plan as jbuild_block_plan
from hispmv_tpu_torch.formats.synth import powerlaw_coo
from hispmv_tpu_torch.ops.spmv_chunked import (
    pack_chunks_paneled,
    spmv_chunked_paneled,
    spmv_chunked_paneled_plain,
)
from hispmv_tpu_torch.plan.blocks import build_block_plan

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
