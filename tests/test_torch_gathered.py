"""The gathered side-plan of the routed format in the port against the JAX
package.

- ``build_gathered_plan`` gives the JAX planner's plan field for field
  (and the same spills) on the cases of ``tests/test_gathered.py``: the
  parametrised golden cases, zipf hub columns, the spill rules and the
  wide-matrix guard; ``gathered_matvec_numpy`` agrees.
- ``pack_gathered`` equals the JAX packer but for its padding (the JAX
  package pads to a pow-2 chunk count); the port's functions also take the
  JAX package's arrays.
- The plain PyTorch version of B12 equals ``s1_gather_pallas`` in
  interpret mode bit for bit, and the full gather (B12, B11, B11) equals
  the JAX package's and ``gather_x_numpy`` exactly: a gather does no
  arithmetic.
- The plain version of B13 matches ``spmv_gathered_tiles_pallas`` at
  rtol=1e-5 plus 1e-5*max|y| (the prefix sums and the y additions run in
  other orders), on planned tiles and on random 26-bit words with shared
  y tiles and a short xg, and the float64 golden at rtol=1e-3.
- With cheap gathered constants (``GATH_TILE_NS``, ``GATH_STAGE_NS`` and
  ``GATH_LAUNCH_NS`` lowered on the JAX package's ``plan.gathered``, and
  the same values in the port's profile, ``gath_*_ns``), the
  routed planner diverts tiles to a side-plan equal to the JAX planner's,
  and the routed handle gives the JAX handle's y (same tolerance) and the
  golden's (rtol 1e-3), in ``run``, ``linear`` and from a plan carried
  over with ``plan_from_reference``.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hispmv_tpu.plan.gathered as JG
import hispmv_tpu_torch.plan.gathered as G
from hispmv_tpu.api.handle import SpmvHandle as JSpmvHandle
from hispmv_tpu.ops.spmv_gathered import (
    gathered_gather_apply as jgathered_gather_apply,
)
from hispmv_tpu.ops.spmv_gathered import pack_gathered as jpack_gathered
from hispmv_tpu.ops.spmv_gathered import (
    s1_gather_pallas,
    spmv_gathered_tiles_pallas,
)
from hispmv_tpu.plan import routed as JR
from hispmv_tpu_torch import SpmvHandle
from hispmv_tpu_torch.formats.matrix import COOMatrix
from hispmv_tpu_torch.ops.spmv_chunked import check_aligned
from hispmv_tpu_torch.ops.spmv_gathered import (
    gathered_gather_apply,
    pack_gathered,
    s1_gather,
    s1_gather_plain,
    spmv_gathered_tiles,
    spmv_gathered_tiles_plain,
)
from hispmv_tpu_torch.plan import routed as R
from hispmv_tpu_torch.plan.convert import plan_from_reference
from hispmv_tpu_torch.tune.cost import V5E


def _rand_coo(R, C, n, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, R, n)
    cols = rng.integers(0, C, n)
    k = np.unique(rows.astype(np.int64) * C + cols)
    rows, cols = k // C, k % C
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return rows, cols, vals


def _zipf():
    rng = np.random.default_rng(9)
    R = C = 16384
    rows = rng.integers(0, R, 100000)
    cols = (rng.zipf(1.3, 100000) - 1) % C
    k = np.unique(rows.astype(np.int64) * C + cols)
    rows, cols = k // C, k % C
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return rows, cols, vals, (R, C), 16


def _spill():
    R = C = 4096
    rng = np.random.default_rng(4)
    rows = np.concatenate([np.full(600, 7), np.array([0, 1024, 2048]),
                           rng.integers(0, R, 2000)])
    cols = rng.integers(0, C, len(rows))
    k = np.unique(rows.astype(np.int64) * C + cols)
    rows, cols = k // C, k % C
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return rows, cols, vals, (R, C), 4


def _wide():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 4096, 5000).astype(np.int64)
    cols = rng.integers(0, 4096, 5000).astype(np.int64)
    vals = rng.standard_normal(5000).astype(np.float32)
    return rows, cols, vals, (4096, 2 ** 21), 2048


# (rows, cols, vals, shape, K) of tests/test_gathered.py
PLAN_CASES = {
    "golden_8192": lambda: (*_rand_coo(8192, 8192, 20000, 0), (8192, 8192),
                            8),
    "golden_4096x16384": lambda: (*_rand_coo(4096, 16384, 60000, 1),
                                  (4096, 16384), 16),
    "golden_2048": lambda: (*_rand_coo(2048, 2048, 3000, 2), (2048, 2048),
                            2),
    "zipf_hubs": _zipf,
    "spill_rules": _spill,
    "wide_guard": _wide,
}
KERNEL_CASES = ["golden_8192", "golden_4096x16384", "zipf_hubs"]


@functools.lru_cache(maxsize=None)
def _plans(name):
    rows, cols, vals, shape, K = PLAN_CASES[name]()
    return (G.build_gathered_plan(rows, cols, vals, shape, K),
            JG.build_gathered_plan(rows, cols, vals, shape, K),
            (rows, cols, vals, shape))


def assert_same_gathered_plan(p, jp):
    assert (p is None) == (jp is None)
    if p is None:
        return
    assert p.num_panels == jp.num_panels
    for f in dataclasses.fields(jp):
        a, b = getattr(p, f.name), getattr(jp, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def assert_close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float64)
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _x(shape, K, seed=1):
    """x of the matrix's width, and the executor's padded x2d [K*8, 128]."""
    x = np.random.default_rng(seed).standard_normal(shape[1]).astype(
        np.float32)
    xp = np.zeros(K * 1024, np.float32)
    n = min(shape[1], K * 1024)
    xp[:n] = x[:n]
    return x, xp.reshape(-1, 128)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_build_gathered_plan_equals_jax(name):
    (p, sr, sc, sv), (jp, jsr, jsc, jsv), _ = _plans(name)
    assert_same_gathered_plan(p, jp)
    for a, b in ((sr, jsr), (sc, jsc), (sv, jsv)):
        np.testing.assert_array_equal(a, b)


def test_wide_matrix_guard_spills_everything():
    (p, sr, _, _), _, (rows, _, _, _) = _plans("wide_guard")
    assert p is None
    np.testing.assert_array_equal(np.sort(sr), np.sort(rows))


@pytest.mark.parametrize("name", ["golden_8192", "golden_4096x16384",
                                  "golden_2048", "zipf_hubs", "spill_rules"])
def test_gathered_matvec_numpy_equals_jax_and_golden(name):
    (p, sr, sc, sv), (jp, _, _, _), (rows, cols, vals, shape) = _plans(name)
    x, _ = _x(shape, p.num_windows, seed=100)
    y = G.gathered_matvec_numpy(p, x)
    np.testing.assert_array_equal(y, JG.gathered_matvec_numpy(jp, x))
    gold = np.zeros(shape[0])
    np.add.at(gold, rows, vals.astype(np.float64) * x[cols])
    np.add.at(gold, sr, -(sv.astype(np.float64) * x[sc]))
    assert np.abs(y - gold).max() / np.abs(gold).max() < 1e-5


@pytest.mark.parametrize("tchunk", [1, 4, 32])
@pytest.mark.parametrize("name", KERNEL_CASES)
def test_pack_gathered_equals_jax_but_for_padding(name, tchunk):
    (p, *_), _, _ = _plans(name)
    arrays, meta = pack_gathered(p, tchunk=tchunk)
    jarrays, jmeta = jpack_gathered(p, tchunk=tchunk)
    for k in ("K", "P", "panel_tiles", "T", "tchunk"):
        assert meta[k] == jmeta[k], k
    assert meta["nch"] == -(-p.num_tiles // tchunk) <= jmeta["nch"]
    assert sorted(arrays) == sorted(jarrays)
    for k in arrays:
        a, b = arrays[k], jarrays[k]
        assert a.dtype == b.dtype, k
        if k != "byt":
            a, b = a.reshape(-1, 128), b.reshape(-1, 128)
        np.testing.assert_array_equal(a, b[: len(a)], err_msg=k)
        assert not b[len(a):].any(), k  # the JAX package's padding


def test_pack_gathered_exact_has_no_padding_tile():
    (p, *_), _, _ = _plans("golden_4096x16384")
    arrays, meta = pack_gathered(p)
    assert meta["nch"] * meta["tchunk"] == meta["nch3"] * meta["tc3"] \
        == p.num_tiles
    assert arrays["vals"].shape == (p.num_tiles, 8, 128)


# ---------------------------------------------------------------------------
# B12, the full gather and B13 against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_plain_b12_equals_pallas(name):
    (p, *_), _, (_, _, _, shape) = _plans(name)
    arrays, meta = pack_gathered(p)
    _, x2d = _x(shape, meta["K"])
    P, K = meta["P"], meta["K"]
    got = s1_gather_plain(torch.from_numpy(arrays["s1"]),
                          torch.from_numpy(x2d), P, K)
    want = s1_gather_pallas(jnp.asarray(arrays["s1"]), jnp.asarray(x2d), P,
                            K, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("packer", ["port", "jax"])
@pytest.mark.parametrize("name", KERNEL_CASES)
def test_gathered_gather_apply_is_exact(name, packer):
    """On the port's arrays, and on the JAX package's (S3 in chunks of up
    to 16 windows), fed to both packages."""
    (p, *_), _, (_, _, _, shape) = _plans(name)
    pack = pack_gathered if packer == "port" else jpack_gathered
    arrays, meta = pack(p, tchunk=4)
    d = {k: torch.from_numpy(v) for k, v in arrays.items()}
    x, x2d = _x(shape, meta["K"])
    xg = gathered_gather_apply(d, meta, "", torch.from_numpy(x2d))
    assert xg.shape == (p.num_tiles * 8, 128)
    np.testing.assert_array_equal(xg.numpy().reshape(-1),
                                  G.gather_x_numpy(p, x))
    if packer == "jax":
        jd = {k: jnp.asarray(v) for k, v in arrays.items()}
        jxg = jgathered_gather_apply(jd, meta, "", jnp.asarray(x2d),
                                     interpret=True)
        np.testing.assert_array_equal(xg.numpy(), np.asarray(jxg))


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_plain_b13_matches_pallas_and_golden(name):
    """On the JAX package's arrays: tiles in chunks of 4, padded with
    zero-route tiles to a pow-2 chunk count."""
    (p, *_), _, (_, _, _, shape) = _plans(name)
    arrays, meta = jpack_gathered(p, tchunk=4)
    x, x2d = _x(shape, meta["K"])
    xg = G.gather_x_numpy(p, x).reshape(-1, 128)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    y = spmv_gathered_tiles_plain(t["vals"], t["word"], t["byt"],
                                  torch.from_numpy(xg), p.num_ytiles,
                                  meta["nch"], meta["tchunk"])
    jy = spmv_gathered_tiles_pallas(
        jnp.asarray(arrays["vals"]), jnp.asarray(arrays["word"]),
        jnp.asarray(arrays["byt"]), jnp.asarray(xg), p.num_ytiles,
        meta["nch"], meta["tchunk"], interpret=True)
    assert y.shape == (p.num_ytiles * 8, 128)
    assert_close(y.numpy(), np.asarray(jy))
    want = G.gathered_matvec_numpy(p, x)
    assert_close(y.numpy().reshape(-1)[: shape[0]], want, rtol=1e-3)


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_plain_b13_is_the_float64_row_sum_rounded_once(name):
    """B13 takes each row's sum as the difference of two fp64 prefixes of
    the whole tile, so a short row keeps its digits: an fp32 prefix errs by
    ~1e-5 of the tile's running sum, which a small row's sum cannot
    carry."""
    (p, *_), _, (_, _, _, shape) = _plans(name)
    arrays, meta = pack_gathered(p)
    x, _ = _x(shape, meta["K"])
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    xg = torch.from_numpy(G.gather_x_numpy(p, x).reshape(-1, 128))
    y = spmv_gathered_tiles_plain(t["vals"], t["word"], t["byt"], xg,
                                  p.num_ytiles, meta["nch"], meta["tchunk"])
    want = G.gathered_matvec_numpy(p, x)
    np.testing.assert_allclose(y.numpy().reshape(-1)[: shape[0]], want,
                               rtol=1e-6, atol=1e-9)


def _random_tiles(Tp, nyt, seed):
    """Random B13 arrays that no planner built: vals, 26-bit words (two
    random 13-bit routes) and byt with repeats inside [0, nyt)."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((Tp, 8, 128)).astype(np.float32)
    word = rng.integers(0, 1 << 26, (Tp, 8, 128), dtype=np.int32)
    byt = rng.integers(0, nyt, Tp).astype(np.int32)
    byt[-1] = byt[0]  # a repeat, whatever the draw
    return vals, word, byt


@pytest.mark.parametrize("short", [0, 3])
@pytest.mark.parametrize("tchunk", [1, 32])
def test_plain_b13_matches_pallas_on_random_words(tchunk, short):
    """Random routes, y tiles shared by several tiles, and xg short by
    ``short`` rows (read as 0): the Clos composition of the plain version
    is the TPU kernel's."""
    Tp, nyt = max(tchunk, 5), 3
    vals, word, byt = _random_tiles(Tp, nyt, tchunk + short)
    assert len(np.unique(byt)) < Tp
    xg = np.random.default_rng(7).standard_normal(
        (Tp * 8 - short, 128)).astype(np.float32)
    nch = Tp // tchunk
    v3 = vals.reshape(nch, tchunk * 8, 128)
    w3 = word.reshape(nch, tchunk * 8, 128)
    y = spmv_gathered_tiles_plain(torch.from_numpy(v3), torch.from_numpy(w3),
                                  torch.from_numpy(byt), torch.from_numpy(xg),
                                  nyt, nch, tchunk)
    jy = spmv_gathered_tiles_pallas(jnp.asarray(v3), jnp.asarray(w3),
                                    jnp.asarray(byt), jnp.asarray(xg), nyt,
                                    nch, tchunk, interpret=True)
    assert y.shape == (nyt * 8, 128)
    assert_close(y.numpy(), np.asarray(jy))


def _tile_tensors():
    (p, *_), _, (_, _, _, shape) = _plans("golden_8192")
    arrays, meta = pack_gathered(p)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    x, x2d = _x(shape, meta["K"])
    return p, meta, t, torch.from_numpy(x2d)


def test_wrappers_on_cpu_take_plain_versions():
    p, meta, t, x2d = _tile_tensors()
    b12, b13 = s1_gather.launches, spmv_gathered_tiles.launches
    P, K = meta["P"], meta["K"]
    torch.testing.assert_close(s1_gather(t["s1"], x2d, P, K),
                               s1_gather_plain(t["s1"], x2d, P, K), rtol=0,
                               atol=0)
    xg = gathered_gather_apply(t, meta, "", x2d)
    args = (t["vals"], t["word"], t["byt"], xg, p.num_ytiles, meta["nch"],
            meta["tchunk"])
    torch.testing.assert_close(spmv_gathered_tiles(*args),
                               spmv_gathered_tiles_plain(*args), rtol=0,
                               atol=0)
    assert (s1_gather.launches, spmv_gathered_tiles.launches) == (b12, b13)


@pytest.mark.parametrize("name", ["s1", "s2", "s3", "vals", "word"])
def test_alignment_check_on_packed_arrays(name):
    """The packer's arrays start on a 16-byte boundary (B12 reads its
    words, B11 its routes and values by 16 bytes); a view one element in
    is refused."""
    _, _, t, x2d = _tile_tensors()
    a = t[name]
    check_aligned("s1_gather", a, x2d)
    flat = a.reshape(-1)
    with pytest.raises(ValueError, match="s1_gather.*16-byte"):
        check_aligned("s1_gather", flat[1:])
    check_aligned("s1_gather", flat[4:])


def test_wrappers_reject_bad_arguments():
    p, meta, t, x2d = _tile_tensors()
    P, K = meta["P"], meta["K"]
    with pytest.raises(ValueError):
        s1_gather(t["s1"], x2d[8:], P, K)
    with pytest.raises(TypeError):
        s1_gather(t["s1"].float(), x2d, P, K)
    xg = gathered_gather_apply(t, meta, "", x2d)
    good = (t["vals"], t["word"], t["byt"], xg)
    dims = (p.num_ytiles, meta["nch"], meta["tchunk"])
    with pytest.raises(ValueError):
        spmv_gathered_tiles(*good[:2], t["byt"][1:], xg, *dims)
    with pytest.raises(ValueError):
        spmv_gathered_tiles(*good[:3], torch.cat([xg, xg[:8]]), *dims)
    with pytest.raises(TypeError):
        spmv_gathered_tiles(t["vals"], t["word"].float(), *good[2:], *dims)
    with pytest.raises(ValueError):
        spmv_gathered_tiles(*good, 0, *dims[1:])


def test_wrappers_off_cpu_never_take_plain_versions():
    p, meta, t, x2d = _tile_tensors()
    m = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError, match="no kernel"):
        s1_gather(m["s1"], x2d.to("meta"), meta["P"], meta["K"])
    xg = torch.zeros((p.num_tiles * 8, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        spmv_gathered_tiles(m["vals"], m["word"], m["byt"], xg, p.num_ytiles,
                            meta["nch"], meta["tchunk"])


# ---------------------------------------------------------------------------
# the routed planner and handle with cheap gathered constants
# ---------------------------------------------------------------------------

ROUTED_N = (16384, 150_000)  # rows = cols, nonzeros before dedup


@pytest.fixture
def cheap_gathered(monkeypatch):
    """The gathered executor's modelled cost lowered on both packages, so
    that the routed planner's gate diverts this small matrix's tiles: the
    JAX package's module constants, and the port's profile (returned)."""
    monkeypatch.setattr(JG, "GATH_TILE_NS", 1.0)
    monkeypatch.setattr(JG, "GATH_STAGE_NS", 1.0)
    monkeypatch.setattr(JG, "GATH_LAUNCH_NS", 0.0)
    return dataclasses.replace(V5E, gath_tile_ns=1.0, gath_stage_ns=1.0,
                               gath_launch_ns=0.0)


def _routed_coo():
    n, nnz = ROUTED_N
    rows, cols, vals = _rand_coo(n, n, nnz, 3)
    return COOMatrix((n, n), rows, cols, vals)


def test_routed_plan_with_gathered_side_plan_equals_jax(cheap_gathered):
    coo = _routed_coo()
    p = R.build_routed_plan(coo, profile=cheap_gathered)
    jp = JR.build_routed_plan(coo)
    assert p.gathered is not None and p.gathered.num_tiles > 100
    assert_same_gathered_plan(p.gathered, jp.gathered)
    assert len(p.streams) == len(jp.streams)
    for s, js in zip(p.streams, jp.streams):
        for f in dataclasses.fields(s):
            np.testing.assert_array_equal(getattr(s, f.name),
                                          getattr(js, f.name))
    for f in ("residual_rows", "residual_cols", "residual_vals"):
        np.testing.assert_array_equal(getattr(p, f), getattr(jp, f))
    x = np.random.default_rng(4).standard_normal(coo.num_cols).astype(
        np.float32)
    y = R.routed_matvec_numpy(p, x)
    np.testing.assert_array_equal(y, JR.routed_matvec_numpy(jp, x))
    gold = coo.matvec(x.astype(np.float64))
    assert np.abs(y - gold).max() / np.abs(gold).max() < 1e-4


def test_routed_handle_with_gathered_side_plan(cheap_gathered):
    coo = _routed_coo()
    h = SpmvHandle(coo, format="routed", device="cpu",
                   profile=cheap_gathered)
    assert h.plan.gathered is not None
    assert h._routed_meta["gathered"]["T"] == h.plan.gathered.num_tiles
    jh = JSpmvHandle(coo, format="routed", interpret=True)
    assert_same_gathered_plan(h.plan.gathered,
                              jh._routed_plan_meta.gathered)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(coo.num_cols).astype(np.float32)
    y = h.run(x).numpy()
    gold = coo.matvec(x.astype(np.float64))
    assert_close(y, np.asarray(jh.run(x))[: coo.num_rows])
    assert_close(y, gold, rtol=1e-3)
    # linear: the per-vector loop, as the JAX handle runs it
    xb = rng.standard_normal((3, coo.num_cols)).astype(np.float32)
    bias = rng.standard_normal(coo.num_rows).astype(np.float32)
    yb = h.linear(xb, bias).numpy()
    for b in range(3):
        assert_close(yb[b], h.run(xb[b]).numpy() + bias)
    assert_close(yb, (coo.to_scipy() @ xb.astype(np.float64).T).T + bias,
                 rtol=1e-3)
    # the JAX package's plan, carried over, runs the same
    h2 = SpmvHandle.from_plan(plan_from_reference(jh._routed_plan_meta),
                              device="cpu", profile=cheap_gathered)
    assert_close(h2.run(x).numpy(), y)
