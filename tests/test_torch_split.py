"""The split format in the port against the JAX package.

- ``build_split_plan`` gives plans array-equal to the JAX planner's (hub
  panels, and every array of the routed or ELLX body), the same body pick
  included, on every case of ``small_matrix_cases`` and on arrowhead,
  power-law and R-MAT matrices of 3000^2 with 45,000 nonzeros.
- ``split_matvec_numpy`` equals the JAX package's and the float64 golden.
- ``SpmvHandle(format="split", device="cpu")`` and ``from_plan`` of a
  plan carried over from the JAX package: ``run`` (alpha 2, beta 0.5) and
  ``linear`` (B 9, a bias) against the JAX split handle (Pallas in
  interpret mode) at rtol 1e-5, atol 1e-5 * max(1, max|y|), and against the
  float64 golden (``error_stats`` at rtol 1e-3), with routed and ELLX
  bodies.  The JAX handle's ``linear`` runs a routed body vector by vector
  through its ``run``; the comparison for that body takes the JAX ``run``
  of each vector (one compiled executable, where its ``linear`` traces the
  interpret-mode kernel once per vector).
"""

import dataclasses
import functools

import numpy as np
import pytest
from conftest import small_matrix_cases

from hispmv_tpu.api.handle import SpmvHandle as JSpmvHandle
from hispmv_tpu.formats import synth as jsynth
from hispmv_tpu.plan.split import build_split_plan as jbuild_split_plan
from hispmv_tpu.plan.split import split_matvec_numpy as jsplit_matvec_numpy
from hispmv_tpu_torch import SpmvConfig, SpmvHandle
from hispmv_tpu_torch.formats.matrix import COOMatrix
from hispmv_tpu_torch.ops.spmv_ellx import EllxPlan
from hispmv_tpu_torch.plan.convert import plan_from_reference
from hispmv_tpu_torch.plan.routed import RoutedPlan
from hispmv_tpu_torch.plan.split import (
    SplitPlan,
    build_split_plan,
    split_matvec_numpy,
)
from hispmv_tpu_torch.utils.errors import error_stats

N, NNZ = 3000, 45_000
GENERATED = {
    "arrowhead": (jsynth.arrowhead_coo, 5),
    "powerlaw": (jsynth.powerlaw_coo, 6),
    "rmat": (jsynth.rmat_coo, 7),
}
PLAN_CASES = list(small_matrix_cases()) + list(GENERATED)
BODIES = ["auto", "ellx", "routed"]
ALPHA, BETA = 2.0, 0.5
B = 9


@functools.lru_cache(maxsize=None)
def _jcoo(name):
    """The case as the JAX package's COOMatrix."""
    if name in GENERATED:
        gen, seed = GENERATED[name]
        return gen(N, N, NNZ, seed=seed)
    return small_matrix_cases()[name]


@functools.lru_cache(maxsize=None)
def _coo(name):
    j = _jcoo(name)
    return COOMatrix(j.shape, j.rows, j.cols, j.values)


@functools.lru_cache(maxsize=None)
def _plans(name, body):
    return (build_split_plan(_coo(name), block_h=1, body_format=body),
            jbuild_split_plan(_jcoo(name), block_h=1, body_format=body))


@functools.lru_cache(maxsize=None)
def _jhandle(name, body):
    return JSpmvHandle.from_plan(_plans(name, body)[1], interpret=True)


def assert_same(a, b, path="plan"):
    """Every field of the port's plan ``a`` equals the JAX plan ``b``'s,
    arrays element for element and dtype for dtype."""
    if a is None or b is None:
        assert a is None and b is None, path
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def assert_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def assert_golden(got, want):
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    st = error_stats(np.asarray(got), want, rtol=1e-3, atol=atol)
    assert st.ok, (st.num_mismatches, st.max_rel_error)


def _inputs(coo, seed=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(coo.num_cols).astype(np.float32)
    y_in = rng.standard_normal(coo.num_rows).astype(np.float32)
    xb = rng.standard_normal((B, coo.num_cols)).astype(np.float32)
    bias = rng.standard_normal(coo.num_rows).astype(np.float32)
    return x, y_in, xb, bias


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("name", PLAN_CASES)
def test_split_plan_equals_jax(name, body):
    p, jp = _plans(name, body)
    assert isinstance(p, SplitPlan)
    assert p.stats == jp.stats
    assert p.device_bytes == jp.device_bytes
    assert_same(p, jp)


@pytest.mark.parametrize("name", list(GENERATED))
def test_split_plan_finds_hubs_and_picks_routed(name):
    """The 3000^2 cases have hub columns and a body; ``auto`` picks the
    routed body on each, as the JAX planner does."""
    p, _ = _plans(name, "auto")
    assert p.stats["kc"] > 0 and p.stats["body_nnz"] > 0
    assert isinstance(p.body, RoutedPlan)
    assert isinstance(_plans(name, "ellx")[0].body, EllxPlan)


@pytest.mark.parametrize("body", ["ellx", "routed"])
@pytest.mark.parametrize("name", PLAN_CASES)
def test_split_nnz_partition_exact(name, body):
    """Every nonzero lands in exactly one part."""
    p, _ = _plans(name, body)
    coo = _coo(name)
    hc = 0 if p.hub_col_dense is None else np.count_nonzero(p.hub_col_dense)
    hr = 0 if p.hub_row_dense is None else np.count_nonzero(p.hub_row_dense)
    nb = 0
    if isinstance(p.body, EllxPlan):
        nb = np.count_nonzero(p.body.base_data)
        if p.body.overflow is not None:
            nb += np.count_nonzero(p.body.overflow.data)
    elif p.body is not None:
        nb = sum(np.count_nonzero(s.vals) for s in p.body.streams)
        nb += len(p.body.residual_vals)
        if p.body.gathered is not None:
            nb += np.count_nonzero(p.body.gathered.vals)
    # duplicate coordinates merge in the dense panels and block payloads
    assert hc + hr + nb == coo.to_scipy().tocsr().count_nonzero()


@pytest.mark.parametrize("body", ["ellx", "routed"])
@pytest.mark.parametrize("name", PLAN_CASES)
def test_split_matvec_numpy_agrees(name, body):
    p, jp = _plans(name, body)
    coo = _coo(name)
    x = np.random.default_rng(4).standard_normal(coo.num_cols).astype(
        np.float32)
    y = split_matvec_numpy(p, x)
    np.testing.assert_array_equal(y, jsplit_matvec_numpy(jp, x))
    assert_golden(y, coo.matvec(x.astype(np.float64)))


@pytest.mark.parametrize("body", ["auto", "ellx"])
@pytest.mark.parametrize("name", list(GENERATED))
def test_split_handle_run_matches_jax(name, body):
    coo = _coo(name)
    if body == "auto":
        h = SpmvHandle(coo, SpmvConfig(block_h=1), "split", device="cpu")
        assert isinstance(h.plan.body, RoutedPlan)
    else:
        h = SpmvHandle.from_plan(_plans(name, body)[0], device="cpu")
    assert h.format == "split" and h.padded_cols == -(-N // 128) * 128
    x, y_in, _, _ = _inputs(coo)
    y = h.run(x, y_in, ALPHA, BETA).numpy()
    jy = np.asarray(_jhandle(name, body).run(x))[:N]
    assert_close(y, ALPHA * jy + BETA * y_in)
    assert_golden(y, ALPHA * coo.matvec(x.astype(np.float64)) + BETA * y_in)
    if h.coo is not None:  # built from the matrix, not from a plan
        assert h.verify().ok


@pytest.mark.parametrize("body", ["auto", "ellx"])
@pytest.mark.parametrize("name", list(GENERATED))
def test_split_handle_linear_matches_jax(name, body):
    coo = _coo(name)
    h = SpmvHandle.from_plan(_plans(name, body)[0], device="cpu")
    _, _, xb, bias = _inputs(coo)
    y = h.linear(xb, bias).numpy()
    assert y.shape == (B, N)
    jh = _jhandle(name, body)
    if body == "ellx":
        jy = np.asarray(jh.linear(xb, bias))
    else:  # the JAX handle's linear of a routed body: its run per vector
        jy = np.stack([np.asarray(jh.run(v))[:N] for v in xb]) + bias
    assert_close(y, jy)
    assert_golden(y, (coo.to_scipy() @ xb.astype(np.float64).T).T + bias)
    assert_close(h.linear(xb[0]).numpy(), h.run(xb[0]).numpy())


@pytest.mark.parametrize("body", ["auto", "ellx"])
@pytest.mark.parametrize("name", list(GENERATED))
def test_split_from_converted_jax_plan(name, body):
    """A SplitPlan of the JAX package, carried over, runs the same."""
    p, jp = _plans(name, body)
    conv = plan_from_reference(jp)
    assert_same(conv, jp)
    h = SpmvHandle.from_plan(conv, device="cpu")
    h0 = SpmvHandle.from_plan(p, device="cpu")
    assert h.config.block_h == 1 and h.nnz == p.nnz and h.plan.body is not None
    x, _, _, _ = _inputs(_coo(name), seed=9)
    np.testing.assert_array_equal(h.run(x).numpy(), h0.run(x).numpy())
    assert_golden(h.run(x).numpy(), _coo(name).matvec(x.astype(np.float64)))


@pytest.mark.parametrize("name", list(GENERATED))
def test_split_device_dict(name):
    """ELLX body: the JAX handle's device dict, key for key and array for
    array.  Routed body: the JAX handle's hub arrays, the body under
    ``b_``, and ``device_bytes`` its tensors plus the B9 table's ``lt``
    arrays, as the routed handle counts them."""
    h = SpmvHandle.from_plan(_plans(name, "ellx")[0], device="cpu")
    jd = _jhandle(name, "ellx")._d
    assert sorted(h._d) == sorted(jd)
    for k in jd:
        np.testing.assert_array_equal(h._d[k].float().numpy(),
                                      np.asarray(jd[k]).astype(np.float32),
                                      err_msg=k)
    assert h.device_bytes == _jhandle(name, "ellx").device_bytes
    h = SpmvHandle.from_plan(_plans(name, "auto")[0], device="cpu")
    jd = _jhandle(name, "auto")._d
    hub = [k for k in jd if not k.startswith("b_")]
    assert sorted(k for k in h._d if not k.startswith("b_")) == sorted(hub)
    assert all(k.startswith("b_") for k in h._d if k not in hub)
    meta = h._split_body_routed_meta
    assert meta["table"] is not None
    assert h.device_bytes == sum(int(t.nbytes) for t in h._d.values()) + \
        meta["table"].lt_nbytes


def test_split_without_hubs_or_body():
    """A uniform matrix has no hubs (the body alone); a matrix of one
    dense row and one dense column has no body."""
    j = jsynth.random_coo(N, N, 15_000, seed=3)
    coo = COOMatrix(j.shape, j.rows, j.cols, j.values)
    h = SpmvHandle(coo, format="split", device="cpu")
    assert h.plan.hub_col_idx is None and h.plan.hub_row_idx is None
    x = np.random.default_rng(4).standard_normal(N).astype(np.float32)
    assert_golden(h.run(x).numpy(), coo.matvec(x.astype(np.float64)))
    others = np.delete(np.arange(500), 7)
    rows = np.concatenate([np.full(500, 7), others])
    cols = np.concatenate([np.arange(500), np.full(499, 3)])
    coo = COOMatrix((500, 500), rows, cols,
                    np.linspace(-1, 1, 999).astype(np.float32))
    h = SpmvHandle(coo, format="split", device="cpu")
    assert h.plan.body is None and h.plan.stats["kr"] == 1
    x = x[:500]
    assert_golden(h.run(x).numpy(), coo.matvec(x.astype(np.float64)))
    xb = np.stack([x, -x])
    assert_golden(h.linear(xb).numpy(),
                  (coo.to_scipy() @ xb.astype(np.float64).T).T)
