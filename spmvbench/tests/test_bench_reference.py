"""The float64 reference, the numbers compared, and the bfloat16 stand."""

import numpy as np
import pytest
import torch

from spmvbench.reference import Bf16Stand, CsrReference, rel_errors


def norm_rel_err(*args):
    return rel_errors(*args)["norm_rel_err"]


def l1_rel_err(*args):
    return rel_errors(*args)["l1_rel_err"]


def _coo(seed, n=300, m=200, k=3000):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, n * m, k))
    return (n, m), keys // m, keys % m, rng.standard_normal(
        keys.size).astype(np.float32)


def test_reference_equals_dense_product():
    shape, r, c, v = _coo(1)
    dense = np.zeros(shape)
    dense[r, c] = v
    ref = CsrReference(shape, r, c, v, "cpu")
    x = np.random.default_rng(2).standard_normal((5, shape[1]))
    got = ref.matmat(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, x @ dense.T, rtol=1e-12, atol=1e-12)
    got1 = ref.matmat(torch.from_numpy(x[0])).numpy()
    np.testing.assert_allclose(got1, dense @ x[0], rtol=1e-12, atol=1e-12)
    absd = np.abs(dense) @ np.abs(x[0])
    np.testing.assert_allclose(
        ref.matmat(torch.from_numpy(x[0]), absolute=True).numpy(), absd,
        rtol=1e-12)


def test_norm_rel_err_reads_zero_rounding_and_faults():
    shape, r, c, v = _coo(3)
    ref = CsrReference(shape, r, c, v, "cpu")
    x = torch.randn(shape[1], generator=torch.Generator().manual_seed(4))
    exact = ref.matmat(x)
    assert rel_errors(ref, x, exact) == {"norm_rel_err": 0.0,
                                         "l1_rel_err": 0.0}
    f32 = exact.float()
    assert 0 < norm_rel_err(ref, x, f32) < 1e-6
    assert 0 < l1_rel_err(ref, x, f32) < 1e-6
    wrong = f32.clone()
    wrong[int(f32.abs().argmax())] = 0.0
    assert norm_rel_err(ref, x, wrong) > 0.1
    nan = f32.clone()
    nan[0] = float("nan")
    assert norm_rel_err(ref, x, nan) == float("inf")
    assert l1_rel_err(ref, x, nan) == float("inf")
    # the y_in epilogue: alpha A x + beta y_in
    y_in = torch.randn(shape[0])
    y = (0.85 * exact + 0.15 * y_in.double()).float()
    assert norm_rel_err(ref, x, y, y_in, 0.85, 0.15) < 1e-6
    assert norm_rel_err(ref, x, y, y_in, 0.85, 0.0) > 1e-3


def test_zero_scale_needs_exact_zero():
    ref = CsrReference((2, 2), [0], [0], [1.0], "cpu")
    x = torch.tensor([0.0, 1.0])
    assert norm_rel_err(ref, x, torch.zeros(2)) == 0.0
    assert norm_rel_err(ref, x, torch.tensor([0.0, 1e-30])) == float("inf")
    assert l1_rel_err(ref, x, torch.tensor([0.0, 1e-30])) == float("inf")


def test_batch_reads_its_worst_vector():
    shape, r, c, v = _coo(5)
    ref = CsrReference(shape, r, c, v, "cpu")
    x = torch.randn(3, shape[1])
    y = ref.matmat(x).float()
    good = norm_rel_err(ref, x, y)
    y[2, 7] += 1.0
    assert norm_rel_err(ref, x, y) > 100 * good


@pytest.mark.parametrize("call", ["run", "linear"])
def test_bf16_stand_errs_at_bfloat16_rounding(call):
    shape, r, c, v = _coo(6, n=400, m=400, k=8000)
    ref = CsrReference(shape, r, c, v, "cpu")
    stand = Bf16Stand(shape, r, c, v, "cpu")
    x = torch.randn(2, shape[1])
    y = stand.linear(x) if call == "linear" else stand.run(x[0])
    err = norm_rel_err(ref, x if call == "linear" else x[0], y)
    assert 1e-4 < err < 2e-2


def test_l1_reads_a_fault_in_the_small_rows_that_the_widest_gap_misses():
    # one heavy row holds the widest scale (a restart, a hub); the bulk of
    # the rows hold little each, as in a PageRank iterate
    n = 2000
    r = torch.arange(n)
    ref = CsrReference((n, n), r, r, torch.ones(n), "cpu")
    x = torch.full((n,), 1e-4, dtype=torch.float64)
    x[0] = 0.5
    y = ref.matmat(x).float()
    small = y.clone()
    small[1000:] = 0.0  # half of the small rows lost
    assert norm_rel_err(ref, x, small) < 1e-3
    assert l1_rel_err(ref, x, small) > 0.1
