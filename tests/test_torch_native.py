"""The port's native MatrixMarket parser and block packer against their
numpy versions and the JAX package's (mirrors of tests/test_native.py),
and ``fetch_suite`` on a local tarball.

- ``native.pack_blocks`` gives ``plan/blocks.py::_pack_blocks_numpy``'s
  block ids and payloads exactly (duplicates summed in COO order, so even
  summed payloads are bit-equal), and the JAX package's native packer's;
  ``build_block_plan`` gives the JAX package's plan.
- ``native.parse_mtx_body`` gives ``formats/mtx.py::_parse_body_numpy``'s
  entries, and ``load_mtx`` over real / integer / pattern / symmetric /
  skew-symmetric files gives the numpy branch's and the JAX package's
  matrix; a body the native parser does not take goes to the numpy branch,
  which reads it or raises.
"""

import io
import os
import tarfile
import time

import numpy as np
import pytest

from hispmv_tpu import native as jnative
from hispmv_tpu.formats import load_mtx as jload_mtx
from hispmv_tpu.plan import blocks as JB
from hispmv_tpu_torch import native
from hispmv_tpu_torch.formats.matrix import COOMatrix
from hispmv_tpu_torch.formats.mtx import _parse_body_numpy, load_mtx, save_mtx
from hispmv_tpu_torch.formats.synth import (
    SUITE_URLS,
    blocked_coo,
    fetch_suite,
    powerlaw_coo,
    random_coo,
)
from hispmv_tpu_torch.plan.blocks import (
    LANES,
    _pack_blocks_numpy,
    build_block_plan,
    degree_column_perm,
)

MATRICES = {
    "blocked": lambda: blocked_coo(500, 700, 20_000, seed=0),
    "powerlaw": lambda: powerlaw_coo(1000, 1000, 30_000, seed=1),
}


def _with_duplicates(seed=5):
    """Every nonzero of a random matrix twice or three times over."""
    coo = random_coo(300, 500, 4000, seed=seed)
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, coo.nnz, 3000)
    return COOMatrix(coo.shape, np.concatenate([coo.rows, coo.rows[pick]]),
                     np.concatenate([coo.cols, coo.cols[pick]]),
                     np.concatenate([coo.values,
                                     rng.standard_normal(3000)]))


def _numpy_plan(monkeypatch, coo, **kw):
    """``build_block_plan`` with ``native.pack_blocks`` swapped for its
    plain version."""
    with monkeypatch.context() as m:
        m.setattr(native, "pack_blocks", _pack_blocks_numpy)
        return build_block_plan(coo, **kw)


def _numpy_load(monkeypatch, src):
    """``load_mtx`` with the native parser refusing every body, so that
    the numpy branch parses it."""
    with monkeypatch.context() as m:
        m.setattr(native, "parse_mtx_body", lambda *a: None)
        return load_mtx(src)


def _assert_packs_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bh", [1, 8, 16])
@pytest.mark.parametrize("name", list(MATRICES) + ["duplicates"])
def test_pack_blocks_matches_numpy(name, bh):
    coo = _with_duplicates() if name == "duplicates" else MATRICES[name]()
    ncb = -(-coo.num_cols // LANES)
    got = native.pack_blocks(coo.rows, coo.cols, coo.values, bh, ncb)
    _assert_packs_equal(got, _pack_blocks_numpy(coo.rows, coo.cols,
                                                coo.values, bh, ncb))
    # the JAX package's native packer (std::sort over (key, index) pairs)
    _assert_packs_equal(got, jnative.pack_blocks(coo.rows, coo.cols,
                                                 coo.values, bh, ncb))


def test_pack_blocks_of_no_nonzeros():
    e = np.zeros(0, np.int32)
    br, bc, data = native.pack_blocks(e, e, np.zeros(0, np.float32), 8, 4)
    assert br.shape == bc.shape == (0,) and data.shape == (0, 8, 128)


def test_pack_blocks_rejects_bad_indices():
    r = np.array([0, 1], np.int64)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        native.pack_blocks(r, np.array([0, 1 << 31]), np.ones(2), 8, 4)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        native.pack_blocks(np.array([-1, 0]), r, np.ones(2), 8, 4)
    with pytest.raises(ValueError, match="length"):
        native.pack_blocks(r, r[:1], np.ones(2), 8, 4)


@pytest.mark.parametrize("perm", [False, True])
@pytest.mark.parametrize("bh", [8, 16])
@pytest.mark.parametrize("name", list(MATRICES) + ["duplicates"])
def test_build_block_plan_uses_native_and_agrees(name, bh, perm,
                                                 monkeypatch):
    coo = _with_duplicates() if name == "duplicates" else MATRICES[name]()
    cp = degree_column_perm(coo) if perm else None
    plan = build_block_plan(coo, block_h=bh, col_perm=cp)
    for other in (_numpy_plan(monkeypatch, coo, block_h=bh, col_perm=cp),
                  JB.build_block_plan(coo, block_h=bh, col_perm=cp)):
        for f in ("data", "block_rows", "block_cols", "block_firsts",
                  "block_lasts", "col_perm"):
            a, b = getattr(plan, f), getattr(other, f)
            assert (a is None) == (b is None) == (f == "col_perm"
                                                  and not perm)
            if a is not None:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=f)
        assert (plan.num_row_blocks, plan.num_col_blocks, plan.nnz) == (
            other.num_row_blocks, other.num_col_blocks, other.nnz)


def test_build_block_plan_calls_the_native_packer(monkeypatch):
    calls = []
    orig = native.pack_blocks
    monkeypatch.setattr(native, "pack_blocks",
                        lambda *a: calls.append(1) or orig(*a))
    build_block_plan(MATRICES["blocked"](), block_h=8)
    assert calls == [1]


def test_native_pack_speed():
    """tests/test_native.py's guard: a high-fill matrix (small payload), so
    this times the sort and fill loops themselves."""
    coo = blocked_coo(100_000, 100_000, 5_000_000, seed=3)
    ncb = -(-coo.num_cols // LANES)
    t0 = time.perf_counter()
    native.pack_blocks(coo.rows, coo.cols, coo.values, 8, ncb)
    dt = time.perf_counter() - t0
    assert dt < 10.0, f"native pack too slow: {dt:.1f}s"


def test_parse_mtx_body():
    body = b"1 2 3.5\n2 1 -1.25e2\n3 3 0.125\n"
    r, c, v = native.parse_mtx_body(body, 3, True)
    np.testing.assert_array_equal(r, [0, 1, 2])
    np.testing.assert_array_equal(c, [1, 0, 2])
    np.testing.assert_allclose(v, [3.5, -125.0, 0.125])
    assert (r.dtype, c.dtype, v.dtype) == (np.int32, np.int32, np.float32)
    r2, c2, v2 = _parse_body_numpy(body.decode(), 3, "real")
    np.testing.assert_array_equal(r, r2)
    np.testing.assert_array_equal(c, c2)
    np.testing.assert_array_equal(v, v2)


@pytest.mark.parametrize("body,expect,has_value", [
    (b"1 2 3.5 9\n2 1 4\n", 2, True),  # a token past the value
    (b"1 2 3.5\n2 1\n", 2, True),  # a value missing
    (b"1 2\n2 x\n", 2, False),  # not a number
    (b"1 2 3.5\n", 2, True),  # fewer entries than the size line says
    (b"1 2 3\n2 1 4\n", 2, False),  # a value in a pattern body
])
def test_parse_mtx_body_refuses_what_it_cannot_read(body, expect, has_value):
    assert native.parse_mtx_body(body, expect, has_value) is None


FILES = {
    "real": "%%MatrixMarket matrix coordinate real general\n% c\n"
            "3 4 4\n1 1 2.5\n3 4 -1.0\n2 2 7\n1 4 0.0\n",
    "integer": "%%MatrixMarket matrix coordinate integer general\n"
               "3 3 3\n1 1 2\n3 2 -5\n2 3 11\n",
    "pattern": "%%MatrixMarket matrix coordinate pattern general\n"
               "2 3 3\n1 2\n2 1\n2 3\n",
    "symmetric": "%%MatrixMarket matrix coordinate real symmetric\n"
                 "3 3 3\n1 1 1.0\n2 1 2.0\n3 2 3.0\n",
    "skew": "%%MatrixMarket matrix coordinate real skew-symmetric\n"
            "3 3 2\n2 1 4.0\n3 1 -1.5e-3\n",
    "crlf_tabs": "%%MatrixMarket matrix coordinate real general\r\n"
                 "2 2 2\r\n1\t1\t1.5\r\n2 2  -2 \r\n",
    # four tokens a line: the numpy branch reads the first three
    "extra_column": "%%MatrixMarket matrix coordinate real general\n"
                    "2 2 2\n1 1 1.5 0\n2 2 -2 0\n",
}


def _coo_equal(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.cols, b.cols)
    np.testing.assert_array_equal(a.values, b.values)
    assert a.values.dtype == b.values.dtype == np.float32


@pytest.mark.parametrize("name", list(FILES))
def test_load_mtx_native_equals_numpy_and_jax(name, monkeypatch):
    text = FILES[name]
    m = load_mtx(io.StringIO(text))
    _coo_equal(m, _numpy_load(monkeypatch, io.StringIO(text)))
    _coo_equal(m, jload_mtx(io.StringIO(text)))


def test_load_mtx_takes_the_native_parser(monkeypatch):
    calls = []
    orig = native.parse_mtx_body
    monkeypatch.setattr(native, "parse_mtx_body",
                        lambda *a: calls.append(1) or orig(*a))
    load_mtx(io.StringIO(FILES["real"]))
    assert calls == [1]


@pytest.mark.parametrize("numpy_only", [False, True])
def test_malformed_body_still_raises(numpy_only, monkeypatch):
    text = ("%%MatrixMarket matrix coordinate real general\n3 3 3\n"
            "1 1 1.0\n2 2\n")
    load = (lambda src: _numpy_load(monkeypatch, src)) if numpy_only \
        else load_mtx
    with pytest.raises(ValueError, match="Malformed"):
        load(io.StringIO(text))


def test_mtx_roundtrip_uses_native(tmp_path, monkeypatch):
    coo = random_coo(50, 60, 300, seed=4)
    p = str(tmp_path / "m.mtx")
    save_mtx(p, coo)
    loaded = load_mtx(p)
    np.testing.assert_array_equal(loaded.rows, coo.rows)
    np.testing.assert_array_equal(loaded.cols, coo.cols)
    np.testing.assert_array_equal(loaded.values, coo.values)  # %.9g
    _coo_equal(loaded, _numpy_load(monkeypatch, p))
    _coo_equal(loaded, jload_mtx(p))


def test_fetch_suite_from_a_local_tarball(tmp_path):
    src = tmp_path / "src"
    (src / "demo").mkdir(parents=True)
    coo = random_coo(20, 30, 60, seed=9)
    save_mtx(str(src / "demo" / "demo.mtx"), coo)
    tgz = tmp_path / "demo.tar.gz"
    with tarfile.open(tgz, "w:gz") as tar:
        tar.add(src / "demo", arcname="demo")
    out = tmp_path / "suite"
    paths = fetch_suite(str(out), urls=[tgz.as_uri()])
    assert paths == [str(out / "demo" / "demo.mtx")]
    assert not os.path.exists(out / "demo.tar.gz")
    _coo_equal(load_mtx(paths[0]), load_mtx(str(src / "demo" / "demo.mtx")))
    # already there: not fetched again
    os.remove(tgz)
    assert fetch_suite(str(out), urls=[tgz.as_uri()]) == paths


def test_suite_urls_are_the_reference_list():
    from hispmv_tpu.formats.synth import SUITE_URLS as JURLS

    assert SUITE_URLS == JURLS and len(SUITE_URLS) == 20
