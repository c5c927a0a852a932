"""The routed format in the port against the JAX package.

- The native planning routines equal their numpy / Python versions.
- ``build_routed_plan``, ``build_ranked_routed_plan`` and
  ``build_banded_routed_plan`` give arrays equal to the JAX planner's
  (every ``RoutedStream`` field, the residual, ``col_perms``, ``row_perms``).
- ``pack_stream(bucket=True)`` equals the JAX packer (without its unused
  ``lt`` table).
- The plain PyTorch version of B9 matches ``spmv_routed_stream_pallas`` in
  interpret mode on identical packed arrays (``tchunk=4``, as
  ``tests/test_routed.py`` runs it): rtol=1e-5, atol=1e-5*max(1, max|y|)
  (the port's prefix is fp64, the TPU's fp32; the prefix sums and the y
  additions run in other orders).  Both are also held to the float64
  golden at rtol=1e-3.  A small row behind a large prefix keeps its
  digits in the port (where an fp32 prefix loses them).
- ``SpmvHandle(format="routed")`` matches the float64 golden (``error_stats``
  at rtol=1e-3, the reference's acceptance) in original space, rank space,
  with a COO and an ELLX residual, and on the banded cell grid; a plan
  carried over from the JAX package with ``plan_from_reference`` runs the
  same.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import small_matrix_cases

from hispmv_tpu.api.handle import SpmvHandle as JSpmvHandle
from hispmv_tpu.config import SpmvConfig as JSpmvConfig
from hispmv_tpu.ops.spmv_routed import pack_stream as jpack_stream
from hispmv_tpu.ops.spmv_routed import spmv_routed_stream_pallas
from hispmv_tpu.plan import routed as JR
from hispmv_tpu_torch import SpmvConfig, SpmvHandle
from hispmv_tpu_torch import native
from hispmv_tpu_torch.formats.matrix import COOMatrix
from hispmv_tpu_torch.formats.synth import (
    powerlaw_coo,
    random_coo,
    rmat_coo,
)
from hispmv_tpu_torch.ops.spmv_routed import (
    MAX_STREAMS,
    pack_stream,
    routed_table,
    segment_lts,
    spmv_routed_stream,
    spmv_routed_stream_batched_plain,
    spmv_routed_stream_plain,
    spmv_routed_streams,
    spmv_routed_streams_plain,
)
from hispmv_tpu_torch.plan import routed as R
from hispmv_tpu_torch.plan.convert import plan_from_reference
from hispmv_tpu_torch.utils.errors import error_stats

# the power-law / R-MAT / random cases of tests/test_routed.py (ranked)
EXTRA = {
    "powerlaw4000": lambda: powerlaw_coo(4000, 4000, 60_000, seed=7),
    "rmat4096": lambda: rmat_coo(4096, 4096, 50_000, seed=8),
    "random900": lambda: random_coo(900, 700, 8_000, seed=9),
}
PLAN_CASES = list(small_matrix_cases()) + list(EXTRA)


def _one_row():
    n = 3000  # one row across ~3 windows: every tile has one run (lmax 1)
    return COOMatrix((8, 4096), np.zeros(n), np.arange(n),
                     np.linspace(-1, 1, n).astype(np.float32))


# (matrix, the (l1, lmax) its first stream must have): lmax 1 to 32, l1 1
# and 5, and a window span of 8
KERNEL_CASES = {
    "tiny": (lambda: small_matrix_cases()["tiny"], (1, 1)),
    "one_row": (_one_row, (1, 1)),
    "banded": (lambda: small_matrix_cases()["banded"], (1, 2)),
    "wide": (lambda: small_matrix_cases()["wide"], (5, 2)),
    "random900": (EXTRA["random900"], (5, 4)),
    "tall_l1_5_lmax16": (lambda: random_coo(33000, 1024, 3000, seed=1),
                         (5, 16)),
    "tall_lmax32": (lambda: random_coo(33000, 128, 2000, seed=1), (1, 32)),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    if name in EXTRA:
        return EXTRA[name]()
    if name in KERNEL_CASES:
        return KERNEL_CASES[name][0]()
    return small_matrix_cases()[name]


def assert_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def assert_same_routed_plan(p, jp):
    for f in ("shape", "nnz", "num_windows", "num_ytiles"):
        assert getattr(p, f) == getattr(jp, f), f
    assert len(p.streams) == len(jp.streams)
    for s, js in zip(p.streams, jp.streams):
        for f in dataclasses.fields(s):
            np.testing.assert_array_equal(getattr(s, f.name),
                                          getattr(js, f.name),
                                          err_msg=f.name)
    for f in ("residual_rows", "residual_cols", "residual_vals"):
        np.testing.assert_array_equal(getattr(p, f), getattr(jp, f),
                                      err_msg=f)
    assert jp.gathered is None and p.gathered is None
    for f in ("col_perms", "row_perms"):
        a, b = getattr(p, f), getattr(jp, f)
        assert (a is None) == (b is None), f
        for x, y in zip(a or [], b or []):
            np.testing.assert_array_equal(x, y, err_msg=f)


def golden(coo, x):
    return coo.matvec(np.asarray(x, np.float64))


# ---------------------------------------------------------------------------
# native routines against their plain versions
# ---------------------------------------------------------------------------


def test_native_greedy_cell_merge_matches_python():
    rng = np.random.default_rng(9)
    strip = np.sort(rng.integers(0, 200, 20_000)).astype(np.int64)
    bc = rng.integers(1, 6, 20_000).astype(np.int64)
    np.testing.assert_array_equal(native.greedy_cell_merge(strip, bc, 32),
                                  R._greedy_merge_py(strip, bc, 32))


@pytest.mark.parametrize("bits", [12, 40, 63])
def test_native_radix_argsort_is_a_stable_sort(bits):
    rng = np.random.default_rng(bits)
    keys = rng.integers(0, 1 << bits, 50_000, dtype=np.uint64)
    keys[::7] = keys[0]  # many equal keys: stability shows
    np.testing.assert_array_equal(native.radix_argsort(keys),
                                  np.argsort(keys, kind="stable"))


def test_native_sort_mrc_matches_lexsort():
    coo = _case("powerlaw4000")
    mcell = (coo.cols >> 10) * 4 + (coo.rows >> 10) // 32
    order = R._sort_mrc(mcell.astype(np.int32), coo.rows, coo.cols,
                        *coo.shape)
    np.testing.assert_array_equal(order,
                                  np.lexsort((coo.cols, coo.rows, mcell)))


@pytest.mark.parametrize("width", [8, 512])
def test_native_distinct_rank_matches_numpy(width):
    rng = np.random.default_rng(width)
    group = rng.integers(0, 3000, 40_000).astype(np.int64)
    val = rng.integers(0, width, 40_000).astype(np.int64)
    np.testing.assert_array_equal(R._distinct_rank(group, val, width),
                                  R._distinct_rank_py(group, val, width))


def test_native_tile_stats_match_numpy():
    rng = np.random.default_rng(3)
    T0, nyt = 40, 50
    p_win = rng.integers(0, 64, T0 * 1024).astype(np.int32)
    p_band = rng.integers(0, nyt, T0 * 1024).astype(np.int32)
    real = rng.random(T0 * 1024) < 0.8
    tile_of = np.arange(T0 * 1024, dtype=np.int32) >> 10
    got = native.routed_tile_stats(p_win, p_band, ~real)
    want = R._tile_stats_py(T0, tile_of, p_win, p_band, real, nyt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_native_build_failure_raises_with_compiler_output(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setenv("CXX", "false")  # a "compiler" that always fails
    with pytest.raises(RuntimeError, match="native planning library"):
        native.build()


# ---------------------------------------------------------------------------
# planners
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ranked", [False, True])
@pytest.mark.parametrize("name", PLAN_CASES)
def test_routed_plans_equal_jax(name, ranked):
    coo = _case(name)
    build = R.build_ranked_routed_plan if ranked else R.build_routed_plan
    jbuild = JR.build_ranked_routed_plan if ranked else JR.build_routed_plan
    plan = build(coo)
    assert_same_routed_plan(plan, jbuild(coo))
    x = np.random.default_rng(10).standard_normal(coo.num_cols)
    np.testing.assert_allclose(R.routed_matvec_numpy(plan, x),
                               golden(coo, x), rtol=1e-3, atol=1e-4)


def _stretched_rmat(base_nnz=12_000):
    """tests/test_routed.py's banded case: an R-MAT scattered along the
    diagonal of a 1.1M x 1.1M index space (fails routed_vmem_ok)."""
    coo = rmat_coo(2048, 2048, base_nnz, seed=23)
    rows = coo.rows.astype(np.int64) + (coo.cols.astype(np.int64) % 7) \
        * 150_000
    cols = coo.cols.astype(np.int64) + (coo.rows.astype(np.int64) % 5) \
        * 200_000
    return COOMatrix((1_100_000, 1_100_000), rows, cols, coo.values)


@functools.lru_cache(maxsize=None)
def _banded_matrix():
    return _stretched_rmat()


@pytest.mark.parametrize("rank_sort", [False, True])
def test_banded_plans_equal_jax(rank_sort):
    coo = _banded_matrix()
    assert not R.routed_vmem_ok(coo.shape)
    plan = R.build_banded_routed_plan(coo, rank_sort=rank_sort)
    jplan = JR.build_banded_routed_plan(coo, rank_sort=rank_sort)
    for f in ("shape", "nnz", "band_rows", "panel_cols"):
        assert getattr(plan, f) == getattr(jplan, f)
    assert plan.num_bands == 3 and plan.num_panels == 2
    assert len(plan.cells) == len(jplan.cells)
    for c, jc in zip(plan.cells, jplan.cells):
        assert (c.r0, c.c0, c.nrows, c.ncols) == (jc.r0, jc.c0, jc.nrows,
                                                  jc.ncols)
        assert_same_routed_plan(c.plan, jc.plan)
    for f in ("col_perms", "row_perms"):
        a, b = getattr(plan, f), getattr(jplan, f)
        assert (a is None) == (b is None) == (not rank_sort)
        for x, y in zip(a or [], b or []):
            np.testing.assert_array_equal(x, y)


def test_cost_model_matches_jax():
    coo = _case("powerlaw4000")
    table = R.winband_table(coo.rows, coo.cols, coo.shape)
    for a, b in zip(table, JR.winband_table(coo.rows, coo.cols, coo.shape)):
        np.testing.assert_array_equal(a, b)
    for sw in (2, 8, 32):
        assert R.estimate_routed_cost_ns(
            coo.rows, coo.cols, coo.shape, strip_windows=sw,
            conflict_sample=True,
        ) == JR.estimate_routed_cost_ns(
            coo.rows, coo.cols, coo.shape, strip_windows=sw,
            conflict_sample=True,
        )
    assert R.plan_cost_ns(R.build_routed_plan(coo)) == JR.plan_cost_ns(
        JR.build_routed_plan(coo))


# ---------------------------------------------------------------------------
# B9: the packer and the plain version against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_pack_stream_bucketed_equals_jax(name):
    plan = R.build_routed_plan(_case(name))
    for s in plan.streams:
        for tchunk in (0, 4):
            segs, jsegs = pack_stream(s, tchunk), jpack_stream(s, tchunk)
            assert [d for _, d in segs] == [d for _, d in jsegs]
            for (arrays, _), (jarrays, _) in zip(segs, jsegs):
                assert len(arrays) == len(jarrays) - 1  # no lt table
                for a, b in zip(arrays, jarrays):
                    np.testing.assert_array_equal(a, b)


def _x2d(plan, C, seed=33):
    x = np.random.default_rng(seed).standard_normal(C).astype(np.float32)
    xp = np.zeros(plan.num_windows * R.WINDOW, np.float32)
    xp[:C] = x
    return x, xp.reshape(-1, 128)


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_plain_b9_matches_pallas(name):
    coo = _case(name)
    plan = R.build_routed_plan(coo)
    l1, lmax = KERNEL_CASES[name][1]
    assert (plan.streams[0].l1, plan.streams[0].lmax) == (l1, lmax)
    x, x2d = _x2d(plan, coo.num_cols)
    y = np.zeros(plan.num_ytiles * R.WINDOW, np.float64)
    jy = np.zeros_like(y)
    for s in plan.streams:
        for arrays, dims in jpack_stream(s, tchunk=4):
            yp = spmv_routed_stream_plain(
                tuple(map(torch.from_numpy, arrays[:-1])), dims,
                torch.from_numpy(x2d), plan.num_ytiles)
            yj = spmv_routed_stream_pallas(
                tuple(map(jnp.asarray, arrays)), dims, jnp.asarray(x2d),
                plan.num_ytiles, interpret=True)
            assert_close(yp.numpy(), np.asarray(yj))
            y += yp.numpy().reshape(-1)
            jy += np.asarray(yj).reshape(-1)
    for got in (y, jy):
        got = got[: coo.num_rows].copy()
        np.add.at(got, plan.residual_rows,
                  plan.residual_vals.astype(np.float64)
                  * x[plan.residual_cols])
        assert error_stats(got, golden(coo, x), rtol=1e-3).ok


def test_plain_b9_on_unbucketed_single_tile_chunks():
    """The handle's packing (exact W and lmax, one tile per chunk) gives the
    same y as the bucketed TPU packing."""
    coo = _case("random900")
    plan = R.build_routed_plan(coo)
    _, x2d = _x2d(plan, coo.num_cols)
    xt = torch.from_numpy(x2d)
    for s in plan.streams:
        ((arrays, dims),) = pack_stream(s, tchunk=1, bucket=False)
        assert dims == (s.num_tiles, 1, s.wmax, s.l1, s.lmax)
        y = spmv_routed_stream_plain(tuple(map(torch.from_numpy, arrays)),
                                     dims, xt, plan.num_ytiles)
        ((jarrays, jdims),) = jpack_stream(s, tchunk=4, bucket=False)
        yb = spmv_routed_stream_plain(
            tuple(map(torch.from_numpy, jarrays[:-1])), jdims, xt,
            plan.num_ytiles)
        assert_close(y.numpy(), yb.numpy())


def _small_rows_case():
    """random900 with every seventh row scaled to 1e-3 and the others to
    1e3: small rows share their tiles with large ones, so the tile prefix
    at a small row's run is ~1e4 times its sum."""
    coo = _case("random900")
    small = coo.rows % 7 == 0
    vals = np.where(small, 1e-3, 1e3).astype(np.float32) * coo.values
    return (COOMatrix(coo.shape, coo.rows, coo.cols, vals),
            np.unique(coo.rows[small]))


def small_row_errors(plan, coo, x, xt, b9):
    """|y - golden| / sum |a_rj x_j| on the small rows (tiles by ``b9``
    on each stream's arrays, the residual in float64)."""
    coo, small = coo
    y = np.zeros(plan.num_ytiles * R.WINDOW)
    for s in plan.streams:
        ((arrays, dims),) = pack_stream(s, tchunk=1, bucket=False)
        packed = tuple(torch.as_tensor(a, device=xt.device) for a in arrays)
        y += b9(packed, dims, xt, plan.num_ytiles).cpu().numpy().reshape(-1)
    y = y[: coo.num_rows]
    np.add.at(y, plan.residual_rows,
              plan.residual_vals.astype(np.float64) * x[plan.residual_cols])
    terms = np.zeros(coo.num_rows)
    np.add.at(terms, coo.rows, np.abs(coo.values.astype(np.float64)
                                      * x[coo.cols]))
    return (np.abs(y - golden(coo, x)) / np.maximum(terms, 1e-30))[small]


def test_plain_b9_small_rows_keep_their_digits():
    """B9's plain version sums each tile's prefix in fp64: a small row's
    run, the difference of two prefixes ~1e4 times larger, errs by a few
    fp32 roundings of its own terms.  The same arithmetic with an fp32
    prefix (B10's plain version at one vector) misses by orders more."""
    case = _small_rows_case()
    plan = R.build_routed_plan(case[0])
    x, x2d = _x2d(plan, case[0].num_cols)
    xt = torch.from_numpy(x2d)
    rel = small_row_errors(plan, case, x, xt, spmv_routed_stream_plain)
    assert rel.max() < 1e-6

    def fp32_prefix(packed, dims, x2d, nyt):
        return spmv_routed_stream_batched_plain(packed, dims,
                                                x2d[:, :, None], nyt)
    assert small_row_errors(plan, case, x, xt, fp32_prefix).max() > 1e-3


def _b9_args(name="random900"):
    coo = _case(name)
    plan = R.build_routed_plan(coo)
    _, x2d = _x2d(plan, coo.num_cols)
    ((arrays, dims),) = pack_stream(plan.streams[0], tchunk=1, bucket=False)
    return (tuple(map(torch.from_numpy, arrays)), dims,
            torch.from_numpy(x2d), plan.num_ytiles)


def test_b9_wrapper_on_cpu_takes_plain_version():
    args = _b9_args()
    before = spmv_routed_streams.launches
    torch.testing.assert_close(spmv_routed_stream(*args),
                               spmv_routed_stream_plain(*args), rtol=0,
                               atol=0)
    assert spmv_routed_streams.launches == before


def test_b9_wrapper_rejects_bad_arguments():
    packed, dims, x2d, nyt = _b9_args()
    with pytest.raises(ValueError, match="arrays for lmax"):
        spmv_routed_stream(packed[:-1], dims, x2d, nyt)
    with pytest.raises(TypeError):
        spmv_routed_stream((packed[0].double(),) + packed[1:], dims, x2d,
                           nyt)
    with pytest.raises(ValueError, match="shape"):
        spmv_routed_stream(packed, (dims[0] + 1,) + dims[1:], x2d, nyt)
    with pytest.raises(ValueError, match="caps"):
        spmv_routed_stream(packed, dims[:2] + (65,) + dims[3:], x2d, nyt)
    with pytest.raises(ValueError):
        spmv_routed_stream(packed, dims, x2d.reshape(-1, 64), nyt)


def test_b9_wrapper_off_cpu_never_takes_plain_version():
    packed, dims, x2d, nyt = _b9_args()
    with pytest.raises(ValueError, match="no kernel"):
        spmv_routed_stream(tuple(t.to("meta") for t in packed), dims,
                           x2d.to("meta"), nyt)


# ---------------------------------------------------------------------------
# B9 on a stream table: every stream of a plan in one launch
# ---------------------------------------------------------------------------


def _tables(entries, nyt):
    """``entries`` as tables of at most MAX_STREAMS streams each."""
    return [routed_table(entries[i: i + MAX_STREAMS], nyt)
            for i in range(0, len(entries), MAX_STREAMS)]


@pytest.mark.parametrize("name", list(small_matrix_cases()))
def test_plain_b9_table_equals_pallas_sum(name):
    """The plain B9 on a table of every packed segment of a plan equals the
    sum of the Pallas kernel (interpret mode) over the same segments, fed
    the JAX packer's arrays, its lt table included: rtol 1e-5 (fp32 both,
    other summation orders); and the float64 golden at rtol 1e-3."""
    coo = _case(name)
    plan = R.build_routed_plan(coo)
    x, x2d = _x2d(plan, coo.num_cols)
    nyt = plan.num_ytiles
    entries = []
    jy = np.zeros(nyt * R.WINDOW, np.float64)
    for s in plan.streams:
        segs = jpack_stream(s, tchunk=4)
        for (arrays, dims), lt in zip(segs, segment_lts(s, segs)):
            np.testing.assert_array_equal(lt, arrays[-1])  # the JAX lt
            entries.append((tuple(map(torch.from_numpy, arrays[:-1])), dims,
                            torch.from_numpy(arrays[-1])))
            jy += np.asarray(spmv_routed_stream_pallas(
                tuple(map(jnp.asarray, arrays)), dims, jnp.asarray(x2d), nyt,
                interpret=True)).reshape(-1)
    y = torch.zeros((nyt * 8, 128))
    for table in _tables(entries, nyt):
        assert spmv_routed_streams(table, torch.from_numpy(x2d), y) is y
    assert_close(y.numpy().reshape(-1), jy)
    got = y.numpy().reshape(-1)[: coo.num_rows].astype(np.float64)
    np.add.at(got, plan.residual_rows,
              plan.residual_vals.astype(np.float64) * x[plan.residual_cols])
    assert error_stats(got, golden(coo, x), rtol=1e-3).ok


@pytest.mark.parametrize("ranked", [False, True])
@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("name", list(small_matrix_cases()))
def test_layers_past_lt_are_padding(name, bucket, ranked):
    """B9 on the card runs only the layers k < lt[t]: every layer past them
    must be all-zero boundary words with byt 0, so that it adds P[0][0] -
    P[0][0] = 0 and the skip is exact (padding tiles: lt 0, all zero)."""
    coo = _case(name)
    plan = (R.build_ranked_routed_plan if ranked else R.build_routed_plan)(
        coo)
    for s in plan.streams:
        segs = pack_stream(s, 4 if bucket else 1, bucket=bucket)
        for (arrays, dims), lt in zip(segs, segment_lts(s, segs)):
            nch, tchunk, _, _, lmax = dims
            Tp = nch * tchunk
            assert lt.shape == (Tp,) and (lt <= s.lmax).all()
            byt = arrays[-1].reshape(Tp, lmax)
            k = np.arange(lmax)
            dead = k[None, :] >= lt[:, None]  # [Tp, lmax]
            assert (byt[dead] == 0).all()
            if lmax == 1:
                bm = arrays[3].reshape(Tp, -1)
                assert (bm[lt == 0] == 0).all()
                continue
            bl = arrays[3].reshape(Tp, -(-lmax // 2), 1024).view(np.uint32)
            bs = arrays[4].reshape(Tp, -(-lmax // 4), 1024).view(np.uint32)
            for kk in range(lmax):
                lanes = (bl[:, kk // 2] >> np.uint32(14 * (kk % 2))) \
                    & np.uint32(0x3FFF)
                subs = (bs[:, kk // 4] >> np.uint32(8 * (kk % 4))) \
                    & np.uint32(0xFF)
                rows = dead[:, kk]
                assert (lanes[rows] == 0).all() and (subs[rows] == 0).all()


def _table_entries(name="random900"):
    coo = _case(name)
    plan = R.build_routed_plan(coo)
    _, x2d = _x2d(plan, coo.num_cols)
    entries = []
    for s in plan.streams:
        ((arrays, dims),) = pack_stream(s, tchunk=1, bucket=False)
        entries.append((tuple(map(torch.from_numpy, arrays)), dims,
                        torch.from_numpy(s.lt.astype(np.int32))))
    return entries, torch.from_numpy(x2d), plan.num_ytiles


def test_b9_table_adds_into_y_and_equals_the_streams():
    """The table's y is the sum of the single-stream calls, added into the
    y it is given; the first tiles run end to end."""
    entries, x2d, nyt = _table_entries()
    table = routed_table(entries, nyt)
    lmax = [d[4] for _, d, _ in table.streams]
    assert lmax == sorted(lmax, reverse=True)  # the longest loops first
    assert table.words[:, 12].tolist() == np.cumsum(
        [0] + [d[0] * d[1] for _, d, _ in table.streams])[:-1].tolist()
    assert table.num_tiles == sum(d[0] * d[1] for _, d, _ in entries)
    y0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (nyt * 8, 128)).astype(np.float32))
    want = y0.clone()
    for packed, dims, _ in entries:
        want += spmv_routed_stream(packed, dims, x2d, nyt)
    before = spmv_routed_streams.launches
    got = spmv_routed_streams(table, x2d, y0.clone())
    assert spmv_routed_streams.launches == before
    assert_close(got.numpy(), want.numpy())
    assert_close(spmv_routed_streams_plain(table, x2d).numpy(),
                 (want - y0).numpy())


def test_b9_table_rejects_bad_arguments():
    entries, x2d, nyt = _table_entries()
    packed, dims, lt = entries[0]
    with pytest.raises(TypeError):  # a wrong dtype
        routed_table([((packed[0].double(),) + packed[1:], dims, lt)], nyt)
    with pytest.raises(ValueError, match="lt must be int32"):
        routed_table([(packed, dims, lt.long())], nyt)
    with pytest.raises(ValueError, match="caps"):  # dims outside the caps
        routed_table([(packed, dims[:2] + (65,) + dims[3:], lt)], nyt)
    with pytest.raises(ValueError, match="caps"):
        routed_table([(packed, dims[:4] + (33,), lt)], nyt)
    with pytest.raises(ValueError, match="tensors on"):  # a mixed device
        routed_table([(packed[:-1] + (packed[-1].to("meta"),), dims, lt)],
                     nyt)
    with pytest.raises(ValueError, match="tensors on"):
        routed_table([(packed, dims, lt.to("meta"))], nyt)
    with pytest.raises(ValueError, match="streams"):
        routed_table([entries[0]] * (MAX_STREAMS + 1), nyt)
    with pytest.raises(ValueError, match="num_ytiles"):
        routed_table(entries, 0)
    table = routed_table(entries, nyt)
    with pytest.raises(ValueError):  # each call checks x and y
        spmv_routed_streams(table, x2d.reshape(-1, 64))
    with pytest.raises(TypeError):
        spmv_routed_streams(table, x2d.double())
    with pytest.raises(ValueError):
        spmv_routed_streams(table, x2d.to("meta"))
    with pytest.raises(ValueError, match="y must be"):
        spmv_routed_streams(table, x2d, torch.zeros((nyt * 8 + 8, 128)))


# ---------------------------------------------------------------------------
# the handle
# ---------------------------------------------------------------------------


def _check_handle(h, coo, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(coo.num_cols).astype(np.float32)
    y_in = rng.standard_normal(coo.num_rows).astype(np.float32)
    y = h.run(x, y_in, 1.5, -0.5)
    assert y.dtype == torch.float32 and y.shape == (coo.num_rows,)
    want = 1.5 * golden(coo, x) - 0.5 * y_in
    assert error_stats(y.numpy(), want, rtol=1e-3).ok
    return x


@pytest.mark.parametrize("rank_sort", [False, True])
@pytest.mark.parametrize("name", ["banded", "powerlaw", "single_dense_row",
                                  "tiny", "wide", "tall", "powerlaw4000"])
def test_routed_handle_matches_golden(name, rank_sort):
    coo = _case(name)
    h = SpmvHandle(coo, SpmvConfig(rank_sort=rank_sort), "routed",
                   device="cpu")
    assert h.format == "routed"
    assert (h._routed_meta["xperm"] is not None) == rank_sort
    _check_handle(h, coo)
    assert h.verify().ok
    # the JAX package's plan, carried over, runs the same
    jplan = (JR.build_ranked_routed_plan if rank_sort
             else JR.build_routed_plan)(coo)
    h2 = SpmvHandle.from_plan(plan_from_reference(jplan), device="cpu")
    assert h2.format == "routed"
    x = np.random.default_rng(3).standard_normal(coo.num_cols)
    assert_close(h2.run(x).numpy(), h.run(x).numpy())


@pytest.mark.parametrize("R_,n,res", [(2000, 30, "coo"), (512, 60, "coo"),
                                      (64, 60, "ellx"), (2, 60, "ellx")])
def test_routed_handle_with_residual(R_, n, res):
    """tests/test_routed.py's residual cases (one nnz per macro cell at
    every auto strip width, so every tile demotes to the residual), plus
    row counts that take the row-granular ELLX residual."""
    rng = np.random.default_rng(54)
    rows = rng.integers(0, R_, n).astype(np.int64)
    cols = (np.arange(n, dtype=np.int64) * 16384
            + rng.integers(0, 1024, n))
    coo = COOMatrix((R_, int(cols.max()) + 1), rows, cols,
                    rng.standard_normal(n).astype(np.float32))
    h = SpmvHandle(coo, format="routed", device="cpu")
    assert h.plan.num_tiles == 0
    assert h._routed_meta["res_coo"] == (res == "coo")
    assert (h._routed_meta["res"] is not None) == (res == "ellx")
    _check_handle(h, coo)


def test_routed_handle_ellx_residual_with_overflow():
    """A heavy residual row spills past the ELLX base into B1's stream
    (the plan is made by hand: the planner keeps such rows in tiles)."""
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
    _check_handle(h, coo)


@pytest.mark.parametrize("rank_sort", [True, False])
def test_banded_routed_handle_matches_golden(rank_sort):
    coo = _banded_matrix()
    h = SpmvHandle(coo, SpmvConfig(rank_sort=rank_sort), "routed",
                   device="cpu")
    assert isinstance(h.plan, R.BandedRoutedPlan)
    assert h.padded_cols == coo.num_cols
    x = _check_handle(h, coo, seed=24)
    jplan = JR.build_banded_routed_plan(coo, rank_sort=rank_sort)
    h2 = SpmvHandle.from_plan(plan_from_reference(jplan), device="cpu")
    assert_close(h2.run(x).numpy(), h.run(x).numpy())


@pytest.mark.parametrize("kind", ["original", "rank", "banded",
                                  "banded_rank"])
def test_routed_handle_run_matches_jax_handle(kind):
    """One B9 launch a routed part (a table over every stream) gives the
    JAX handle's ``run`` (interpret mode, one kernel a stream segment) at
    rtol 1e-5, in original space, rank space and on the banded grid."""
    rank = kind.endswith("rank")
    coo = _banded_matrix() if kind.startswith("banded") else _case("powerlaw")
    h = SpmvHandle(coo, SpmvConfig(rank_sort=rank), "routed", device="cpu")
    jh = JSpmvHandle(coo, JSpmvConfig(rank_sort=rank), "routed",
                     interpret=True)
    metas = ([c["meta"] for c in h._routed_meta["cells"]]
             if kind.startswith("banded") else [h._routed_meta])
    assert all(m["table"] is not None for m in metas)
    assert h.device_bytes == sum(int(t.nbytes) for t in h._d.values()) + sum(
        m["table"].lt_nbytes for m in metas)
    x = np.random.default_rng(7).standard_normal(coo.num_cols).astype(
        np.float32)
    y = h.run(x).numpy()
    assert_close(y, np.asarray(jh.run(x))[: coo.num_rows])
    assert error_stats(y, golden(coo, x), rtol=1e-3).ok
