"""``save_plan`` / ``load_plan`` of the port, and plan files that move
between the port and the JAX package.

- Round trip, for every plan type of the port built by its planners (block
  with and without a column permutation, window, stream, ELLX with and
  without its overflow, split with a routed and an ELLX body, routed in
  original and rank space, with its gathered side-plan, and banded): every
  array bit-equal with its dtype, every scalar, tuple and ``None`` equal;
  ``from_plan(load_plan(p), device="cpu").run`` gives exactly the y of the
  handle of the original plan, and the float64 golden at rtol 1e-3.
- Between packages: a file of the JAX package's ``save_plan`` loads in the
  port with arrays equal to the port planner's plan and, for each
  top-level plan type at its smallest matrix, runs within rtol 1e-5 +
  1e-5*max|y| of the JAX handle on the same plan (Pallas in interpret
  mode); a file of the port loads in the JAX package with arrays equal to
  the JAX planner's plan of the same COO.
- A corrupted file raises on load.
- Mirrors of ``tests/test_api.py::test_plan_serialization_roundtrip`` and
  ``::test_from_plan_preserves_col_perm`` and of
  ``tests/test_gathered.py::test_routed_plan_diversion_and_serialize``.
"""

import dataclasses
import functools
import json
import struct
import zipfile
import zlib

import numpy as np
import pytest
from conftest import small_matrix_cases

import hispmv_tpu.plan.gathered as JG
import hispmv_tpu.plan.serialize as JS
from hispmv_tpu.api.handle import SpmvHandle as JSpmvHandle
from hispmv_tpu.ops.spmv_ellx import build_ellx_plan as jbuild_ellx_plan
from hispmv_tpu.plan import blocks as JB
from hispmv_tpu.plan import partition as JP
from hispmv_tpu.plan import routed as JR
from hispmv_tpu.plan import split as JSP
from hispmv_tpu.plan import windows as JW
from hispmv_tpu_torch import SpmvHandle
from hispmv_tpu_torch.formats.matrix import COOMatrix
from hispmv_tpu_torch.formats.synth import powerlaw_coo, random_coo, rmat_coo
from hispmv_tpu_torch.ops.spmv_ellx import EllxPlan, build_ellx_plan
from hispmv_tpu_torch.plan import blocks as B
from hispmv_tpu_torch.plan import load_plan, save_plan
from hispmv_tpu_torch.plan import partition as P
from hispmv_tpu_torch.plan import routed as R
from hispmv_tpu_torch.plan import split as SP
from hispmv_tpu_torch.plan import windows as W
from hispmv_tpu_torch.plan.serialize import _PLAN_TYPES
from hispmv_tpu_torch.tune.cost import V5E

MATRICES = list(small_matrix_cases())


def _full_k(bp):
    return int(np.bincount(bp.block_rows, minlength=bp.num_row_blocks).max())


# plan kind -> (the port's planner, the JAX package's planner)
KINDS = {
    "block": (lambda m: B.build_block_plan(m, 8),
              lambda m: JB.build_block_plan(m, 8)),
    "block_col_perm": (
        lambda m: B.build_block_plan(m, 8, B.degree_column_perm(m)),
        lambda m: JB.build_block_plan(m, 8, JB.degree_column_perm(m))),
    "window": (lambda m: W.build_window_plan(m, 8),
               lambda m: JW.build_window_plan(m, 8)),
    "stream": (lambda m: P.build_plan(m), lambda m: JP.build_plan(m)),
    "ellx_overflow": (
        lambda m: build_ellx_plan(B.build_block_plan(m, 8), k_base=1),
        lambda m: jbuild_ellx_plan(JB.build_block_plan(m, 8), k_base=1)),
    "ellx_no_overflow": (
        lambda m: build_ellx_plan(B.build_block_plan(m, 8),
                                  k_base=_full_k(B.build_block_plan(m, 8))),
        lambda m: jbuild_ellx_plan(JB.build_block_plan(m, 8),
                                   k_base=_full_k(B.build_block_plan(m, 8)))),
    "split_routed": (lambda m: SP.build_split_plan(m, body_format="routed"),
                     lambda m: JSP.build_split_plan(m, body_format="routed")),
    "split_ellx": (lambda m: SP.build_split_plan(m, body_format="ellx"),
                   lambda m: JSP.build_split_plan(m, body_format="ellx")),
    "routed": (R.build_routed_plan, JR.build_routed_plan),
    "routed_rank": (R.build_ranked_routed_plan, JR.build_ranked_routed_plan),
}


def _stretched_rmat():
    """tests/test_torch_routed.py's banded case: an R-MAT scattered along
    the diagonal of a 1.1M x 1.1M index space (a banded routed plan)."""
    coo = rmat_coo(2048, 2048, 12_000, seed=23)
    rows = coo.rows.astype(np.int64) + (coo.cols.astype(np.int64) % 7) \
        * 150_000
    cols = coo.cols.astype(np.int64) + (coo.rows.astype(np.int64) % 5) \
        * 200_000
    return COOMatrix((1_100_000, 1_100_000), rows, cols, coo.values)


def _rand_coo(n, nnz, seed):
    """tests/test_gathered.py's ``_rand_coo``: n x n, ``nnz`` uniform
    positions before dedup."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    k = np.unique(rows.astype(np.int64) * n + cols)
    rows, cols = k // n, k % n
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return COOMatrix((n, n), rows, cols, vals)


def _gathered_coo():
    """tests/test_torch_gathered.py's routed case (16384^2, 150,000
    nonzeros before dedup): diverts to a gathered side-plan when the
    gathered costs are lowered."""
    return _rand_coo(16384, 150_000, 3)


# larger plans: (matrix, port planner, JAX planner, needs cheap gathered)
LARGE = {
    "routed_rank_streams": (
        lambda: powerlaw_coo(4000, 4000, 60_000, seed=7),
        R.build_ranked_routed_plan, JR.build_ranked_routed_plan, False),
    "routed_gathered": (_gathered_coo, R.build_routed_plan,
                        JR.build_routed_plan, True),
    "banded_routed": (_stretched_rmat, R.build_banded_routed_plan,
               JR.build_banded_routed_plan, False),
    "banded_routed_rank": (_stretched_rmat,
                    lambda m: R.build_banded_routed_plan(m, rank_sort=True),
                    lambda m: JR.build_banded_routed_plan(m, rank_sort=True),
                    False),
}


assert not set(LARGE) & set(MATRICES)


@functools.lru_cache(maxsize=None)
def _matrix(name):
    if name in LARGE:
        return LARGE[name][0]()
    return small_matrix_cases()[name]


@pytest.fixture
def cheap_gathered(monkeypatch):
    """The gathered executor's modelled cost lowered on both packages (as
    tests/test_torch_gathered.py does), so that the routed planner diverts
    tiles to a gathered side-plan: the JAX package's module constants, and
    the port's profile (returned)."""
    monkeypatch.setattr(JG, "GATH_TILE_NS", 1.0)
    monkeypatch.setattr(JG, "GATH_STAGE_NS", 1.0)
    monkeypatch.setattr(JG, "GATH_LAUNCH_NS", 0.0)
    return dataclasses.replace(V5E, gath_tile_ns=1.0, gath_stage_ns=1.0,
                               gath_launch_ns=0.0)


def _large_plans(name, request, jax=False):
    coo, build, jbuild, cheap = LARGE[name]
    if cheap:
        profile = request.getfixturevalue("cheap_gathered")
        build = functools.partial(build, profile=profile)
    plan = (jbuild if jax else build)(_matrix(name))
    return _matrix(name), plan


def assert_same_plan(a, b, where="plan"):
    """Every dataclass field equal: arrays bit for bit with their dtype and
    shape, lists and nested plans field by field, the rest by ==."""
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)], where
    for f in dataclasses.fields(a):
        _assert_same(getattr(a, f.name), getattr(b, f.name),
                     f"{where}.{f.name}")


def _assert_same(u, v, where):
    if isinstance(u, np.ndarray):
        assert isinstance(v, np.ndarray), where
        assert u.dtype == v.dtype and u.shape == v.shape, where
        assert u.tobytes() == v.tobytes(), where
    elif dataclasses.is_dataclass(u):
        assert type(u).__name__ == type(v).__name__, where
        assert_same_plan(u, v, where)
    elif isinstance(u, list):
        assert isinstance(v, list) and len(u) == len(v), where
        for i, (p, q) in enumerate(zip(u, v)):
            _assert_same(p, q, f"{where}[{i}]")
    elif isinstance(u, tuple):
        assert isinstance(v, tuple) and u == v, where
    elif u is None:
        assert v is None, where
    else:
        assert u == v and not isinstance(v, (list, tuple, np.ndarray)), where


def assert_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def _x(coo, seed=21):
    return np.random.default_rng(seed).standard_normal(coo.num_cols).astype(
        np.float32)


def _golden(coo, x):
    return coo.matvec(x.astype(np.float64))


def _check_round_trip(plan, coo, path, compress=True):
    save_plan(path, plan, compress=compress)
    loaded = load_plan(path)
    assert type(loaded) is type(plan)
    assert_same_plan(loaded, plan)
    x = _x(coo)
    y0 = SpmvHandle.from_plan(plan, device="cpu").run(x).numpy()
    h = SpmvHandle.from_plan(loaded, device="cpu")
    assert h.nnz == coo.nnz and h.shape == tuple(coo.shape)
    y = h.run(x).numpy()
    np.testing.assert_array_equal(y, y0)
    np.testing.assert_allclose(y, _golden(coo, x), rtol=1e-3, atol=1e-4)
    return loaded


@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_round_trip(tmp_path, kind, matrix):
    coo = _matrix(matrix)
    plan = KINDS[kind][0](coo)
    if kind == "ellx_no_overflow":
        assert plan.overflow is None
    if kind == "ellx_overflow" and _full_k(B.build_block_plan(coo, 8)) > 1:
        assert plan.overflow is not None
    if kind == "block_col_perm":
        assert plan.col_perm is not None
    if kind == "split_routed" and plan.body is not None:
        assert isinstance(plan.body, R.RoutedPlan)
    if kind == "split_ellx" and plan.body is not None:
        assert isinstance(plan.body, EllxPlan)
    if kind == "routed_rank":
        assert plan.col_perms is not None and plan.row_perms is not None
    _check_round_trip(plan, coo, str(tmp_path / "plan.npz"))


@pytest.mark.parametrize("name", list(LARGE))
def test_round_trip_larger_plans(tmp_path, request, name):
    coo, plan = _large_plans(name, request)
    if name == "routed_rank_streams":
        assert len(plan.streams) >= 2 and plan.col_perms is not None
    if name == "routed_gathered":
        assert plan.gathered is not None and plan.gathered.num_tiles > 100
        assert isinstance(plan.gathered.panel_tiles, tuple)
    if name.startswith("banded_routed"):
        rank = name.endswith("rank")  # rank space fills one cell here
        assert isinstance(plan, R.BandedRoutedPlan)
        assert len(plan.cells) >= (1 if rank else 2)
        assert (plan.col_perms is not None) == rank
    loaded = _check_round_trip(plan, coo, str(tmp_path / "plan.npz"),
                               compress=False)
    if name == "routed_gathered":
        assert isinstance(loaded.gathered.panel_tiles, tuple)


# one matrix a kind for the files between packages
CROSS = {kind: "powerlaw" for kind in KINDS}
CROSS["ellx_overflow"] = "blocked"
# the kinds whose JAX handle also runs here, Pallas in interpret mode: each
# top-level plan type at its smallest matrix.  A JAX run of rank space or
# of a larger plan costs 12-19 s; those files are held array for array to
# the port planner's plan instead (test_round_trip_larger_plans runs the
# port's handles of those plans), and tests/test_torch_routed.py holds
# their handles to the JAX package's.
JAX_RUNS = set(KINDS) - {"routed_rank"}


def _cross_cases():
    return ([(k, m) for k, m in CROSS.items()]
            + [(k, k) for k in LARGE])


def _plans_of(kind, matrix, request, jax):
    if kind in LARGE:
        return _large_plans(kind, request, jax=jax)
    coo = _matrix(matrix)
    return coo, KINDS[kind][1 if jax else 0](coo)


@pytest.mark.parametrize("kind,matrix", _cross_cases())
def test_jax_file_runs_in_the_port(tmp_path, request, kind, matrix):
    coo, jplan = _plans_of(kind, matrix, request, jax=True)
    path = str(tmp_path / "jax_plan.npz")
    JS.save_plan(path, jplan)
    plan = load_plan(path)
    assert type(plan) is _PLAN_TYPES[JS._type_name(jplan)]
    _, own = _plans_of(kind, matrix, request, jax=False)
    assert_same_plan(plan, own)
    x = _x(coo, seed=5)
    y = SpmvHandle.from_plan(plan, device="cpu").run(x).numpy()
    if kind in JAX_RUNS:
        jy = np.asarray(JSpmvHandle.from_plan(JS.load_plan(path),
                                              interpret=True).run(x))
        assert_close(y, jy[: coo.num_rows])
    np.testing.assert_allclose(y, _golden(coo, x), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("kind,matrix", _cross_cases())
def test_port_file_loads_in_jax(tmp_path, request, kind, matrix):
    coo, plan = _plans_of(kind, matrix, request, jax=False)
    _, jplan = _plans_of(kind, matrix, request, jax=True)
    path = str(tmp_path / "port_plan.npz")
    save_plan(path, plan)
    loaded = JS.load_plan(path)
    assert type(loaded) is type(jplan)
    assert_same_plan(loaded, jplan)


@pytest.mark.parametrize("kind", ["block", "split_ellx", "routed_rank"])
def test_both_packages_write_the_same_meta(tmp_path, kind):
    """The same plan written by either package holds the same keys and the
    same ``__meta__`` bytes."""
    coo = _matrix("powerlaw")
    save_plan(str(tmp_path / "p.npz"), KINDS[kind][0](coo))
    JS.save_plan(str(tmp_path / "j.npz"), KINDS[kind][1](coo))
    with np.load(str(tmp_path / "p.npz")) as p, \
            np.load(str(tmp_path / "j.npz")) as j:
        assert p.files == j.files
        assert p["__meta__"].tobytes() == j["__meta__"].tobytes()
        for k in p.files:
            assert p[k].dtype == j[k].dtype
            np.testing.assert_array_equal(p[k], j[k])


@pytest.mark.parametrize("kind", ["block_col_perm", "ellx_overflow",
                                  "split_routed", "routed_rank", "stream"])
def test_compressed_and_plain_files_load_the_same(tmp_path, kind):
    coo = _matrix("powerlaw")
    plan = KINDS[kind][0](coo)
    save_plan(str(tmp_path / "z.npz"), plan, compress=True)
    save_plan(str(tmp_path / "s.npz"), plan, compress=False)
    a, b = load_plan(str(tmp_path / "z.npz")), load_plan(str(tmp_path /
                                                            "s.npz"))
    assert_same_plan(a, b)
    assert_same_plan(a, plan)


def test_numpy_scalars_are_written_as_numbers(tmp_path):
    coo = _matrix("random")
    plan = B.build_block_plan(coo, 8)
    plan = dataclasses.replace(plan, nnz=np.int64(plan.nnz),
                               num_row_blocks=np.int32(plan.num_row_blocks),
                               shape=(np.int64(coo.num_rows), coo.num_cols))
    p = str(tmp_path / "plan.npz")
    save_plan(p, plan)
    with np.load(p) as z:
        meta = json.loads(z["__meta__"].tobytes().decode())
    assert meta["nnz"] == coo.nnz and type(meta["nnz"]) is int
    assert meta["shape"] == list(coo.shape)
    for loaded in (load_plan(p), JS.load_plan(p)):
        assert loaded.nnz == coo.nnz and type(loaded.nnz) is int
        assert loaded.shape == tuple(coo.shape)


@pytest.mark.parametrize("obj", [object(), np.zeros(3),
                                 COOMatrix((2, 2), [0], [1], [1.0])])
def test_unknown_plan_type_raises(tmp_path, obj):
    with pytest.raises(TypeError, match="unknown plan type"):
        save_plan(str(tmp_path / "bad.npz"), obj)


def test_plan_serialization_roundtrip(tmp_path):
    """Mirror of tests/test_api.py::test_plan_serialization_roundtrip."""
    coo = random_coo(300, 400, 5000, seed=20)
    x = np.random.default_rng(21).standard_normal(400).astype(np.float32)
    want = _golden(coo, x)
    for plan in [B.build_block_plan(coo, block_h=8),
                 W.build_window_plan(coo, block_h=8),
                 P.build_plan(coo)]:
        p = str(tmp_path / "plan.npz")
        save_plan(p, plan)
        h = SpmvHandle.from_plan(load_plan(p), device="cpu")
        assert h.nnz == coo.nnz and h.shape == coo.shape
        np.testing.assert_allclose(h.run(x).numpy(), want, rtol=1e-3,
                                   atol=1e-4)


def test_from_plan_preserves_col_perm(tmp_path):
    """Mirror of tests/test_api.py::test_from_plan_preserves_col_perm."""
    coo = powerlaw_coo(600, 600, 12_000, seed=30)
    plan = B.build_block_plan(coo, block_h=8,
                              col_perm=B.degree_column_perm(coo))
    p = str(tmp_path / "perm_plan.npz")
    save_plan(p, plan)
    h = SpmvHandle.from_plan(load_plan(p), device="cpu")
    assert "perm" in h._d
    x = np.random.default_rng(31).standard_normal(600).astype(np.float32)
    np.testing.assert_allclose(h.run(x).numpy(), _golden(coo, x), rtol=1e-3,
                               atol=1e-4)


def test_routed_plan_diversion_and_serialize(tmp_path, monkeypatch):
    """Mirror of tests/test_gathered.py::test_routed_plan_diversion_and_
    serialize: with cheap gathered constants the routed planner diverts
    its expensive tiles; the combined plan reproduces the golden matvec
    and survives serialization."""
    rng = np.random.default_rng(3)
    n = 65536
    coo = _rand_coo(n, 600000, 3)
    plan = R.build_routed_plan(coo, profile=dataclasses.replace(
        V5E, gath_tile_ns=1.0, gath_stage_ns=1.0))
    assert plan.gathered is not None
    x = rng.standard_normal(n).astype(np.float32)
    y = R.routed_matvec_numpy(plan, x)
    gold = coo.matvec(x.astype(np.float64))
    assert np.abs(y - gold).max() / np.abs(gold).max() < 1e-4
    pth = str(tmp_path / "plan.npz")
    save_plan(pth, plan, compress=False)
    plan2 = load_plan(pth)
    assert plan2.gathered is not None
    assert np.array_equal(R.routed_matvec_numpy(plan2, x), y)


@pytest.mark.parametrize("compress", [False, True])
def test_a_corrupted_file_raises(tmp_path, compress):
    """A byte flipped in the block payload fails the zip CRC check (or the
    inflate) on load, so bad indices or values never reach a handle."""
    plan = B.build_block_plan(_matrix("powerlaw"), 8)
    p = str(tmp_path / "plan.npz")
    save_plan(p, plan, compress=compress)
    with zipfile.ZipFile(p) as zf:
        info = zf.getinfo("data.npy")
    with open(p, "r+b") as f:
        f.seek(info.header_offset + 26)
        name_len, extra_len = struct.unpack("<HH", f.read(4))
        f.seek(info.header_offset + 30 + name_len + extra_len
               + info.compress_size // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises((zipfile.BadZipFile, zlib.error)):
        load_plan(p)
