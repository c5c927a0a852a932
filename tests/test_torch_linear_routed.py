"""Batched ``linear()`` of the routed format in the port against the JAX
package.

- The plain PyTorch version of B10 against ``spmv_routed_stream_batched_
  pallas`` in interpret mode, on identical packed arrays (``tchunk=4``, as
  ``tests/test_torch_routed.py`` runs B9) at lmax 1 (the merged ``bm``
  word), 2 and 4 and l1 1 and 5; each vector of the batch also equals B9's
  plain version alone.
- ``SpmvHandle.linear`` in original space (B10, one call per stream for
  the whole batch), with a COO and an ELLX residual, in rank space and on
  the banded cell grid (vector by vector), against the JAX package's
  ``linear`` (and, on the banded grid, against ``run`` of each vector).

Tolerances as in ``tests/test_torch_linear.py``: rtol=1e-5,
atol=1e-5*max(1, max|y|) against JAX; ``error_stats`` at rtol=1e-3
against the float64 golden."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import small_matrix_cases
from test_torch_linear import assert_close, assert_golden, batch

from hispmv_tpu.api.handle import SpmvHandle as JSpmvHandle
from hispmv_tpu.config import SpmvConfig as JSpmvConfig
from hispmv_tpu.ops.spmv_routed import pack_stream as jpack_stream
from hispmv_tpu.ops.spmv_routed import spmv_routed_stream_batched_pallas
from hispmv_tpu_torch import SpmvConfig, SpmvHandle
from hispmv_tpu_torch.formats.matrix import COOMatrix
from hispmv_tpu_torch.formats.synth import random_coo
from hispmv_tpu_torch.ops.spmv_routed import (
    _bucket,
    pack_stream,
    spmv_routed_stream_batched,
    spmv_routed_stream_batched_plain,
    spmv_routed_stream_plain,
)
from hispmv_tpu_torch.plan import routed as R


@functools.lru_cache(maxsize=None)
def _case(name):
    return small_matrix_cases()[name]


# ---------------------------------------------------------------------------
# B10: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------


def _one_row():
    n = 3000  # one row across ~3 windows: every tile has one run (lmax 1)
    return COOMatrix((8, 4096), np.zeros(n), np.arange(n),
                     np.linspace(-1, 1, n).astype(np.float32))


# (matrix, the (l1, lmax) its first stream must have): lmax 1 (bm), 2 and
# 4; l1 1 and 5
B10_CASES = {
    "one_row": (_one_row, (1, 1)),
    "banded": (lambda: _case("banded"), (1, 2)),
    "wide": (lambda: _case("wide"), (5, 2)),
    "random900": (lambda: random_coo(900, 700, 8_000, seed=9), (5, 4)),
}


def _stacked_x(plan, C, B, seed=41):
    """B vectors, each padded to the JAX handle's bucketed window count,
    stacked as [B*nwinp*8, 128]."""
    xb = batch(B, C, seed)
    nwinp = _bucket(plan.num_windows)
    xp = np.zeros((B, nwinp * R.WINDOW), np.float32)
    xp[:, :C] = xb
    return xb, xp.reshape(-1, 128)


@pytest.mark.parametrize("name", list(B10_CASES))
def test_plain_b10_matches_pallas(name):
    make, (l1, lmax) = B10_CASES[name]
    coo = make()
    plan = R.build_routed_plan(coo)
    assert (plan.streams[0].l1, plan.streams[0].lmax) == (l1, lmax)
    B = 3
    xb, xb2d = _stacked_x(plan, coo.num_cols, B)
    nyt = plan.num_ytiles
    y = np.zeros((B, nyt * R.WINDOW), np.float64)
    jy = np.zeros_like(y)
    for s in plan.streams:
        for arrays, dims in jpack_stream(s, tchunk=4):
            packed = tuple(map(torch.from_numpy, arrays[:-1]))
            yp = spmv_routed_stream_batched_plain(
                packed, dims, torch.from_numpy(xb2d), nyt, B)
            yj = spmv_routed_stream_batched_pallas(
                tuple(map(jnp.asarray, arrays)), dims, jnp.asarray(xb2d),
                nyt, B, interpret=True)
            assert_close(yp.numpy(), np.asarray(yj))
            # each vector of the batch equals B9's plain version alone
            for b, x2d in enumerate(torch.from_numpy(xb2d).chunk(B)):
                assert_close(yp.numpy().reshape(B, -1)[b],
                             spmv_routed_stream_plain(packed, dims, x2d,
                                                      nyt).numpy().ravel())
            y += yp.numpy().reshape(B, -1)
            jy += np.asarray(yj).reshape(B, -1)
    for got in (y, jy):
        got = got[:, :coo.num_rows].copy()
        for b in range(B):
            np.add.at(got[b], plan.residual_rows,
                      plan.residual_vals.astype(np.float64)
                      * xb[b, plan.residual_cols])
        assert_golden(got, coo, xb)


def test_b10_wrapper_on_cpu_takes_plain_version_and_checks_arguments():
    coo = B10_CASES["random900"][0]()
    plan = R.build_routed_plan(coo)
    _, xb2d = _stacked_x(plan, coo.num_cols, 2)
    ((arrays, dims),) = pack_stream(plan.streams[0], tchunk=1, bucket=False)
    args = (tuple(map(torch.from_numpy, arrays)), dims,
            torch.from_numpy(xb2d), plan.num_ytiles, 2)
    before = spmv_routed_stream_batched.launches
    torch.testing.assert_close(spmv_routed_stream_batched(*args),
                               spmv_routed_stream_batched_plain(*args),
                               rtol=0, atol=0)
    assert spmv_routed_stream_batched.launches == before
    with pytest.raises(ValueError, match="B=3"):
        spmv_routed_stream_batched(*args[:4], 3)
    with pytest.raises(ValueError, match="no kernel"):
        spmv_routed_stream_batched(tuple(a.to("meta") for a in args[0]),
                                   dims, args[2].to("meta"), *args[3:])


# ---------------------------------------------------------------------------
# the handle
# ---------------------------------------------------------------------------


# routed, original space: one B10 call per stream for the whole batch
@pytest.mark.parametrize("name", ["banded", "powerlaw", "tiny", "wide"])
def test_routed_linear_matches_jax(name):
    coo = _case(name)
    jh = JSpmvHandle(coo, format="routed")
    h = SpmvHandle(coo, format="routed", device="cpu")
    xb = batch(2, coo.num_cols, seed=14)
    bias = np.linspace(-1, 1, coo.num_rows).astype(np.float32)
    y = h.linear(xb, bias)
    assert_close(y.numpy(), np.asarray(jh.linear(xb, bias)))
    assert_golden(y.numpy(), coo, xb, bias)


def _residual_coo(R_, n):
    """One nnz per macro cell: every tile demotes to the residual
    (tests/test_routed.py's residual case)."""
    rng = np.random.default_rng(54)
    rows = rng.integers(0, R_, n).astype(np.int64)
    cols = np.arange(n, dtype=np.int64) * 16384 + rng.integers(0, 1024, n)
    return COOMatrix((R_, int(cols.max()) + 1), rows, cols,
                     rng.standard_normal(n).astype(np.float32))


@pytest.mark.parametrize("R_,n,res", [(2000, 30, "coo"), (64, 60, "ellx")])
def test_routed_linear_residual_matches_jax(R_, n, res):
    coo = _residual_coo(R_, n)
    h = SpmvHandle(coo, format="routed", device="cpu")
    assert h._routed_meta["res_coo"] == (res == "coo")
    assert (h._routed_meta["res"] is not None) == (res == "ellx")
    jh = JSpmvHandle(coo, format="routed")
    xb = batch(3, coo.num_cols, seed=15)
    y = h.linear(xb)
    assert_close(y.numpy(), np.asarray(jh.linear(xb)))
    assert_golden(y.numpy(), coo, xb)


def test_routed_linear_ellx_residual_with_overflow():
    """A heavy residual row spills past the ELLX base into B2's stream
    (plan made by hand, as in tests/test_torch_routed.py)."""
    rng = np.random.default_rng(5)
    rows = np.concatenate([np.zeros(3000), np.arange(1, 4000)])
    cols = np.concatenate([np.arange(3000), rng.integers(0, 4096, 3999)])
    coo = COOMatrix((4096, 4096), rows, cols,
                    rng.standard_normal(6999).astype(np.float32))
    plan = R.RoutedPlan(
        shape=coo.shape, nnz=coo.nnz, num_windows=4, num_ytiles=4,
        s0=None, s1=None, s2=None, residual_rows=coo.rows,
        residual_cols=coo.cols, residual_vals=coo.values,
    )
    h = SpmvHandle.from_plan(plan, device="cpu")
    assert h._routed_meta["res"] is not None and "r_odata" in h._d
    xb = batch(4, 4096, seed=16)
    y = h.linear(xb, np.ones(4096, np.float32))
    assert_golden(y.numpy(), coo, xb, np.ones(4096))
    for b in range(4):
        assert_close(y[b].numpy(), h.run(xb[b]).numpy() + 1.0)


def test_rank_space_linear_matches_jax():
    coo = _case("powerlaw")
    jh = JSpmvHandle(coo, JSpmvConfig(rank_sort=True), format="routed")
    h = SpmvHandle(coo, SpmvConfig(rank_sort=True), "routed", device="cpu")
    assert h._routed_meta["xperm"] is not None
    xb = batch(2, coo.num_cols, seed=17)
    y = h.linear(xb)
    assert_close(y.numpy(), np.asarray(jh.linear(xb)))
    assert_golden(y.numpy(), coo, xb)


@pytest.mark.parametrize("rank_sort", [False, True])
def test_banded_routed_linear(rank_sort):
    """The banded cell grid runs vector by vector, as in the JAX package;
    each row of the batch equals ``run`` of that vector."""
    from test_torch_routed import _banded_matrix

    coo = _banded_matrix()
    h = SpmvHandle(coo, SpmvConfig(rank_sort=rank_sort), "routed",
                   device="cpu")
    assert isinstance(h.plan, R.BandedRoutedPlan)
    xb = batch(2, coo.num_cols, seed=18)
    bias = np.full(coo.num_rows, 0.5, np.float32)
    y = h.linear(xb, bias)
    jh = JSpmvHandle(coo, JSpmvConfig(rank_sort=rank_sort), format="routed")
    assert_close(y.numpy(), np.asarray(jh.linear(xb, bias)))
    assert_golden(y.numpy(), coo, xb, bias)
    for b in range(2):
        assert_close(y[b].numpy(), h.run(xb[b]).numpy() + 0.5)
