"""Batched ``linear()`` of the routed format in the port against the JAX
package.

- The plain PyTorch version of B10 against ``spmv_routed_stream_batched_
  pallas`` in interpret mode, on identical packed arrays (``tchunk=4``, as
  ``tests/test_torch_routed.py`` runs B9) at lmax 1 (the merged ``bm``
  word), 2, 4 and 16 and l1 1, 2 and 5, and on the eight small matrices at
  B 1, 3, 8 and 64, the port's x and y vector-minor; each vector of the
  batch also equals B9's plain version alone.
- B10's run decode against a decode of the packed words in numpy (lmax 1
  to 32, l1 1 to 5, padded tiles), its run sums against the prefix form,
  two streams adding into one y, and the runs counted.
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
from hispmv_tpu_torch.formats.synth import powerlaw_coo, random_coo
from hispmv_tpu_torch.ops.spmv_routed import (
    PIECE,
    _bucket,
    _routed_plain,
    decode_runs,
    pack_stream,
    spmv_routed_stream_batched,
    spmv_routed_stream_batched_plain,
    spmv_routed_stream_plain,
    stream_array_names,
    stream_runs,
)
from hispmv_tpu_torch.plan import routed as R
from hispmv_tpu_torch.utils.trace import tracing


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


# (matrix, the (l1, lmax) its first stream must have): lmax 1 (bm), 2, 4
# and 16 (layer groups past the first four); l1 1, 2 and 5
B10_CASES = {
    "one_row": (_one_row, (1, 1)),
    "banded": (lambda: _case("banded"), (1, 2)),
    "wide": (lambda: _case("wide"), (5, 2)),
    "random900": (lambda: random_coo(900, 700, 8_000, seed=9), (5, 4)),
    "tall_lmax16": (lambda: random_coo(16000, 256, 1500, seed=1), (2, 16)),
}


def _stacked_x(plan, C, B, seed=41):
    """B vectors, each padded to the JAX handle's bucketed window count,
    stacked as [B*nwinp*8, 128] (the JAX kernel's layout)."""
    xb = batch(B, C, seed)
    nwinp = _bucket(plan.num_windows)
    xp = np.zeros((B, nwinp * R.WINDOW), np.float32)
    xp[:, :C] = xb
    return xb, xp.reshape(-1, 128)


def _vector_minor(xb2d, B):
    """The port's B10 layout of the same vectors: xt [nwinp*8, 128, B]."""
    return torch.from_numpy(xb2d).reshape(B, -1, 128).permute(1, 2, 0)


def _b10_zero_y(nyt, B):
    return torch.zeros((nyt * R.WINDOW, B), dtype=torch.float32)


# the five cases above at B 3, and the eight small matrices at B 1, 3, 8, 64
B10_PALLAS = [(n, 3) for n in B10_CASES] + [
    (n, B) for n in small_matrix_cases() for B in (1, 3, 8, 64)]
# The JAX kernel interprets each vector on its own (~3.6 s a vector and
# stream on "wide"), so at B 64 it runs on these vectors of the batch
# alone; every vector is held to B9's plain version and the golden.
PALLAS_AT_64 = (0, 31, 63)


@pytest.mark.parametrize("name,B", B10_PALLAS)
def test_plain_b10_matches_pallas(name, B):
    if name in B10_CASES:
        make, (l1, lmax) = B10_CASES[name]
        coo = make()
        plan = R.build_routed_plan(coo)
        assert (plan.streams[0].l1, plan.streams[0].lmax) == (l1, lmax)
    else:
        coo = _case(name)
        plan = R.build_routed_plan(coo)
    xb, xb2d = _stacked_x(plan, coo.num_cols, B)
    xt = _vector_minor(xb2d, B)
    nyt = plan.num_ytiles
    y = _b10_zero_y(nyt, B)
    jvec = list(PALLAS_AT_64) if B == 64 else list(range(B))
    jx2d = xb2d.reshape(B, -1, 128)[jvec].reshape(-1, 128)
    jy = np.zeros((len(jvec), nyt * R.WINDOW), np.float64)
    for s in plan.streams:
        for arrays, dims in jpack_stream(s, tchunk=4):
            packed = tuple(map(torch.from_numpy, arrays[:-1]))
            lt = torch.from_numpy(arrays[-1])
            yp = spmv_routed_stream_batched_plain(packed, dims, xt,
                                                  _b10_zero_y(nyt, B), lt)
            yj = spmv_routed_stream_batched_pallas(
                tuple(map(jnp.asarray, arrays)), dims, jnp.asarray(jx2d),
                nyt, len(jvec), interpret=True)
            yj = np.asarray(yj).reshape(len(jvec), -1)
            assert_close(yp.numpy().T[jvec], yj)
            # each vector of the batch equals B9's plain version alone
            for b, x2d in enumerate(torch.from_numpy(xb2d).chunk(B)):
                assert_close(yp[:, b].numpy(),
                             spmv_routed_stream_plain(packed, dims, x2d,
                                                      nyt).numpy().ravel())
            # adding into the stream's sum so far
            spmv_routed_stream_batched_plain(packed, dims, xt, y, lt)
            jy += yj
    for got, xs in ((y.numpy().T.astype(np.float64), xb), (jy, xb[jvec])):
        got = got[:, :coo.num_rows].copy()
        for b in range(len(xs)):
            np.add.at(got[b], plan.residual_rows,
                      plan.residual_vals.astype(np.float64)
                      * xs[b, plan.residual_cols])
        assert_golden(got, coo, xs)


def _numpy_runs(arrays, dims, lt, nyt):
    """The runs of one packed stream decoded from its words in numpy, one
    cell at a time through its live layers, merging the pairs of one y
    tile that chain through a shared entry: (tile, y row, first, length)
    each."""
    nch, tchunk, W, l1, lmax = dims
    Tp = nch * tchunk
    if lmax == 1:
        bm = arrays[3].reshape(Tp, 8, 128).view(np.uint32)
    else:
        bl = arrays[3].reshape(Tp, -1, 8, 128).view(np.uint32)
        bs = arrays[4].reshape(Tp, -1, 8, 128).view(np.uint32)
    byt = arrays[-1].reshape(Tp, lmax)
    runs = []

    def out(t, yt, cell, a, b):
        runs.append((t, int(yt) * 1024 + cell, min(a, b) + 1, a - b))

    for t in range(Tp):
        for s in range(8):
            for j in range(128):
                pend, cur = None, None
                for k in range(int(lt[t])):
                    if not 0 <= byt[t, k] < nyt:
                        continue
                    if byt[t, k] != cur and pend is not None:
                        out(t, cur, s * 128 + j, *pend)
                        pend = None
                    cur = byt[t, k]
                    if lmax == 1:
                        raw = int(bm[t, s, j])
                    else:
                        raw = int(bl[t, k // 2, s, j]) >> (14 * (k % 2))
                    a, b = raw & 127, (raw >> 7) & 127
                    if lmax == 1:
                        sa = (int(bm[t, s, a]) >> 14) & 7
                        sb = (int(bm[t, s, b]) >> 17) & 7
                    else:
                        sh = 8 * (k % 4)
                        sa = (int(bs[t, k // 4, s, a]) >> sh) & 7
                        sb = (int(bs[t, k // 4, s, b]) >> (sh + 4)) & 7
                    ea, eb = sa * 128 + a, sb * 128 + b
                    if ea == eb:
                        continue
                    if pend is not None and pend[1] == ea:
                        pend = (pend[0], eb)
                    elif pend is not None and pend[0] == eb:
                        pend = (ea, pend[1])
                    else:
                        if pend is not None:
                            out(t, cur, s * 128 + j, *pend)
                        pend = (ea, eb)
                        continue
                    if pend[0] == pend[1]:
                        pend = None
                if pend is not None:
                    out(t, cur, s * 128 + j, *pend)
    return runs


@pytest.mark.parametrize("name", ["tiny", "one_row", "banded", "wide",
                                  "random900", "tall_l1_5_lmax16",
                                  "tall_lmax32"])
def test_b10_run_decode_equals_the_words_and_the_prefix_form(name):
    """lmax 1 to 32 and l1 1 to 5 (tests/test_torch_routed.py's B9
    cases), each stream packed with one padded (lt 0) tile past its last
    tile: :func:`decode_runs` gives exactly the runs of a decode of the
    words cell by cell (the (cell, live layer) pairs whose end and start
    entries differ, chained pairs of one y tile merged), no run repeats a
    (tile, y row), and the run sums equal the prefix form exactly on small
    integers, where fp32 sums are exact."""
    from test_torch_routed import KERNEL_CASES

    make, (l1, lmax) = KERNEL_CASES[name]
    coo = make()
    plan = R.build_routed_plan(coo)
    assert (plan.streams[0].l1, plan.streams[0].lmax) == (l1, lmax)
    nyt = plan.num_ytiles
    rng = np.random.default_rng(3)
    B = 2
    x3 = torch.from_numpy(rng.integers(-4, 5, (
        B, plan.num_windows * 8, 128)).astype(np.float32))
    xt = x3.permute(1, 2, 0).contiguous()
    for s in plan.streams:
        ((arrays, dims),) = pack_stream(s, tchunk=s.num_tiles + 1,
                                        bucket=False)
        Tp = dims[0] * dims[1]
        assert Tp == s.num_tiles + 1
        lt = np.zeros(Tp, np.int32)
        lt[:s.num_tiles] = s.lt
        arrays = list(arrays)
        vals = np.round(arrays[0] * 4).astype(np.float32)  # small integers
        arrays[0] = vals
        packed = tuple(map(torch.from_numpy, arrays))
        ltt = torch.from_numpy(lt)
        tile, yrow, first, length = decode_runs(packed, dims, nyt, ltt)
        got = sorted(zip(*(a.tolist() for a in (tile, yrow, first,
                                                length))))
        want = sorted(_numpy_runs(arrays, dims, lt, nyt))
        assert got == want
        assert len({(t, r) for t, r, _, _ in got}) == len(got)
        assert stream_runs(packed, dims, nyt, ltt, tiles_a_pass=2) \
            == len(want)
        y = spmv_routed_stream_batched_plain(packed, dims, xt,
                                             _b10_zero_y(nyt, B), ltt)
        prefix = _routed_plain(packed, dims, x3, nyt, torch.float32)
        torch.testing.assert_close(y, prefix.T, rtol=0, atol=0)


def test_b10_pieces_split_long_runs():
    """A run longer than PIECE slots (one row over whole tiles) is summed a
    piece at a time, each piece added into the same row."""
    coo = _one_row()
    plan = R.build_routed_plan(coo)
    ((arrays, dims),) = pack_stream(plan.streams[0], tchunk=1, bucket=False)
    packed = tuple(map(torch.from_numpy, arrays))
    _, _, _, length = decode_runs(packed, dims, plan.num_ytiles)
    assert int(length.abs().max()) > 4 * PIECE
    xb, xb2d = _stacked_x(plan, coo.num_cols, 5)
    y = spmv_routed_stream_batched_plain(
        packed, dims, _vector_minor(xb2d, 5), _b10_zero_y(plan.num_ytiles, 5))
    for b, x2d in enumerate(torch.from_numpy(xb2d).chunk(5)):
        assert_close(y[:, b].numpy(), spmv_routed_stream_plain(
            packed, dims, x2d, plan.num_ytiles).numpy().ravel())


def test_b10_streams_add_into_one_y():
    """Each stream adds into the y it is given: two streams into one y
    (holding values) equal the y's values plus each stream alone."""
    coo = powerlaw_coo(4000, 4000, 60_000, seed=7)
    plan = R.build_routed_plan(coo)
    assert len(plan.streams) >= 2
    B = 4
    _, xb2d = _stacked_x(plan, coo.num_cols, B)
    xt = _vector_minor(xb2d, B)
    nyt = plan.num_ytiles
    y0 = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (nyt * R.WINDOW, B)).astype(np.float32))
    y = y0.clone()
    want = y0.clone()
    for s in plan.streams[:2]:
        ((arrays, dims),) = pack_stream(s, tchunk=1, bucket=False)
        packed = tuple(map(torch.from_numpy, arrays))
        lt = torch.from_numpy(s.lt.astype(np.int32))
        runs = stream_runs(packed, dims, nyt, lt)
        assert spmv_routed_stream_batched(packed, dims, xt, y, lt, runs) is y
        want += spmv_routed_stream_batched_plain(packed, dims, xt,
                                                 _b10_zero_y(nyt, B), lt)
    assert_close(y.numpy(), want.numpy())


def test_b10_wrapper_on_cpu_takes_plain_version_and_checks_arguments():
    coo = B10_CASES["random900"][0]()
    plan = R.build_routed_plan(coo)
    _, xb2d = _stacked_x(plan, coo.num_cols, 2)
    ((arrays, dims),) = pack_stream(plan.streams[0], tchunk=1, bucket=False)
    xt = _vector_minor(xb2d, 2).contiguous()
    packed = tuple(map(torch.from_numpy, arrays))
    lt = torch.from_numpy(plan.streams[0].lt.astype(np.int32))
    nyt = plan.num_ytiles
    runs = stream_runs(packed, dims, nyt, lt)
    before = (spmv_routed_stream_batched.launches,
              spmv_routed_stream_batched.runs)
    counted = torch.full((1,), 5, dtype=torch.int64)
    with tracing() as tr:
        y = spmv_routed_stream_batched(packed, dims, xt, _b10_zero_y(nyt, 2),
                                       lt, runs, counted)
    torch.testing.assert_close(y, spmv_routed_stream_batched_plain(
        packed, dims, xt, _b10_zero_y(nyt, 2), lt), rtol=0, atol=0)
    # the card's counters stay; the tracer counts the pack's runs, and
    # counted gets the plain version's own decode
    assert (spmv_routed_stream_batched.launches,
            spmv_routed_stream_batched.runs) == before
    assert tr.tallies == {"kernel.B10.runs": runs}
    assert runs > 0 and int(counted) == 5 + runs
    # rows that are not whole (8, 128) windows of the stream's x, the
    # vector-major layout, a y of another batch, shape, dtype or layout, an
    # lt of another length, a counter of another dtype, size or device, and
    # a device with no kernel
    y = _b10_zero_y(nyt, 2)
    with pytest.raises(ValueError, match=r"\[nwin\*8, 128, B\]"):
        spmv_routed_stream_batched(packed, dims, xt[:-1], y, lt, runs)
    with pytest.raises(ValueError, match=r"\[nwin\*8, 128, B\]"):
        spmv_routed_stream_batched(packed, dims, torch.from_numpy(xb2d), y,
                                   lt, runs)
    for bad in (_b10_zero_y(nyt, 3), y[:-1], y.double(), y.T.contiguous().T,
                torch.zeros(nyt * R.WINDOW * 2)):
        with pytest.raises(ValueError, match="y must be"):
            spmv_routed_stream_batched(packed, dims, xt, bad, lt, runs)
    with pytest.raises(ValueError, match="lt must be"):
        spmv_routed_stream_batched(packed, dims, xt, y, lt[:-1], runs)
    for bad in (torch.zeros(1, dtype=torch.int32),
                torch.zeros(2, dtype=torch.int64),
                torch.zeros(1, dtype=torch.int64, device="meta")):
        with pytest.raises(ValueError, match="counted must be"):
            spmv_routed_stream_batched(packed, dims, xt, y, lt, runs, bad)
    with pytest.raises(ValueError, match="no kernel"):
        spmv_routed_stream_batched(tuple(a.to("meta") for a in packed),
                                   dims, xt.to("meta"), y.to("meta"),
                                   lt.to("meta"), runs)


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


def test_routed_linear_counts_b10_runs():
    """The handle counts each stream's runs when it packs them (the
    decode's count) and ``linear`` adds them to the tracer's tally."""
    coo = powerlaw_coo(4000, 4000, 60_000, seed=7)
    h = SpmvHandle(coo, format="routed", device="cpu")
    meta = h._routed_meta
    assert len(meta["runs"]) == len(meta["streams"]) >= 2
    for i, dims in enumerate(meta["streams"]):
        p = f"s{i}_"
        packed = tuple(h._d[p + n] for n in stream_array_names(dims[4])) + (
            h._d[p + "base"], h._d[p + "byt"])
        tile, *_ = decode_runs(packed, dims, meta["nyt"], meta["lts"][i])
        assert meta["runs"][i] == tile.numel() > 0
    xb = batch(3, coo.num_cols, seed=19)
    with tracing() as tr:
        y = h.linear(xb)
        h.linear(xb)
    assert tr.tallies["kernel.B10.runs"] == 2 * sum(meta["runs"])
    assert tr.counts["kernel.B10"] == 2 * len(meta["streams"])
    assert_golden(y.numpy(), coo, xb)


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
