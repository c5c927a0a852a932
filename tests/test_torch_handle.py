"""The port's SpmvHandle / choose_format / Accelerator against the JAX
package's, on every case of ``small_matrix_cases`` and every ported format.

Port against JAX: rtol=1e-5, atol=1e-5*max(1, max|y|) (fp32 on both sides,
only the order of summation differs).  Port against the float64 golden:
``error_stats`` at rtol=1e-3, the reference's acceptance."""

import functools

import numpy as np
import pytest
import torch
from conftest import small_matrix_cases

from hispmv_tpu.api.handle import SpmvHandle as JSpmvHandle
from hispmv_tpu.api.handle import choose_format as jchoose_format
from hispmv_tpu.config import SpmvConfig as JSpmvConfig
from hispmv_tpu.ops.gemv import gemv_xla
from hispmv_tpu.ops.spmv_ref import spmv_xla
from hispmv_tpu.plan.partition import build_plan as jbuild_plan
from hispmv_tpu_torch import Accelerator, SpmvConfig, SpmvHandle, prepare
from hispmv_tpu_torch.api.handle import choose_format
from hispmv_tpu_torch.ops.gemv import gemv
from hispmv_tpu_torch.ops.spmv_ref import spmv_ref
from hispmv_tpu_torch.plan.convert import plan_from_reference
from hispmv_tpu_torch.plan.partition import build_plan
from hispmv_tpu_torch.utils.errors import error_stats

CASES = list(small_matrix_cases())
FORMATS = ["dense", "block", "window", "ellx", "stream", "auto"]
ALPHA, BETA = 1.5, -0.5


@functools.lru_cache(maxsize=None)
def _case(name):
    return small_matrix_cases()[name]


def assert_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def as_f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def assert_same_device_dict(d, jd):
    assert sorted(d) == sorted(jd)
    for k in jd:
        assert d[k].shape == tuple(jd[k].shape), k
        np.testing.assert_array_equal(as_f32(d[k]), as_f32(jd[k]),
                                      err_msg=k)


def inputs(coo, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(coo.num_cols).astype(np.float32)
    y_in = rng.standard_normal(coo.num_rows).astype(np.float32)
    return x, y_in


@pytest.mark.parametrize("block_h", [1, 8])
@pytest.mark.parametrize("name", CASES)
def test_choose_format_agrees(name, block_h):
    coo = _case(name)
    assert choose_format(coo, SpmvConfig(block_h=block_h)) == (
        jchoose_format(coo, JSpmvConfig(block_h=block_h))
    )


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", CASES)
def test_handle_matches_jax(name, fmt):
    coo = _case(name)
    jh = JSpmvHandle(coo, format=fmt)
    h = SpmvHandle(coo, format=fmt, device="cpu")
    assert h.format == jh.format
    if h.format == "dense":
        np.testing.assert_array_equal(h._dense.numpy(), np.asarray(jh._dense))
    else:
        assert_same_device_dict(h._d, jh._d)
    assert h.device_bytes == jh.device_bytes
    assert h.padded_cols == jh.padded_cols

    x, y_in = inputs(coo)
    y = h.run(x, y_in, ALPHA, BETA)
    assert y.dtype == torch.float32 and y.device.type == "cpu"
    jy = np.asarray(jh.run(x, y_in, ALPHA, BETA))
    assert_close(y.numpy(), jy)
    want = ALPHA * coo.matvec(x.astype(np.float64)) + BETA * y_in
    assert error_stats(y.numpy(), want, rtol=1e-3).ok
    assert h.verify().ok

    if h.format != "dense":
        # the JAX package's prepared plan, carried over, runs the same
        h2 = SpmvHandle.from_plan(plan_from_reference(jh.plan), device="cpu")
        assert h2.format == jh.format
        assert_same_device_dict(h2._d, jh._d)
        assert_close(h2.run(x, y_in, ALPHA, BETA).numpy(), jy)


@pytest.mark.parametrize("name", CASES)
def test_stream_plan_and_spmv_ref_match_jax(name):
    coo = _case(name)
    plan, jplan = build_plan(coo), jbuild_plan(coo)
    for f in ("vals", "cols", "round_starts", "seg_rows"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(jplan, f))
    x, y_in = inputs(coo, seed=1)
    args = [plan.vals, plan.cols, plan.round_ids(), plan.seg_rows]
    y = spmv_ref(*map(torch.from_numpy, args), plan.num_rounds,
                 coo.num_rows, torch.from_numpy(x), torch.from_numpy(y_in),
                 ALPHA, BETA)
    jy = spmv_xla(*args, jplan.num_rounds, coo.num_rows, x, y_in,
                  ALPHA, BETA)
    assert_close(y.numpy(), np.asarray(jy))


def test_gemv_epilogue_matches_jax():
    rng = np.random.default_rng(8)
    a = rng.standard_normal((48, 256)).astype(np.float32)
    x = rng.standard_normal(256).astype(np.float32)
    y_in = rng.standard_normal(48).astype(np.float32)
    y = gemv(torch.from_numpy(a), torch.from_numpy(x),
             torch.from_numpy(y_in), ALPHA, BETA)
    assert_close(y.numpy(), np.asarray(gemv_xla(a, x, y_in, ALPHA, BETA)))


@pytest.mark.parametrize("fmt", ["block", "window", "ellx"])
def test_bf16_payload_matches_jax(fmt):
    coo = _case("powerlaw" if fmt == "ellx" else "blocked")
    jh = JSpmvHandle(coo, JSpmvConfig(value_dtype="bfloat16"), format=fmt)
    h = SpmvHandle(coo, SpmvConfig(value_dtype="bfloat16"), format=fmt,
                   device="cpu")
    assert_same_device_dict(h._d, jh._d)
    value_key = "base_data" if fmt == "ellx" else "data"
    assert h._d[value_key].dtype == torch.bfloat16
    x, y_in = inputs(coo, seed=2)
    assert_close(h.run(x, y_in, ALPHA, BETA).numpy(),
                 np.asarray(jh.run(x, y_in, ALPHA, BETA)))


def test_block_col_reorder_matches_jax():
    coo = _case("powerlaw")
    jh = JSpmvHandle(coo, JSpmvConfig(col_reorder=True), format="block")
    h = SpmvHandle(coo, SpmvConfig(col_reorder=True), format="block",
                   device="cpu")
    assert "perm" in h._d
    assert_same_device_dict(h._d, jh._d)
    x, _ = inputs(coo)
    assert_close(h.run(x).numpy(), np.asarray(jh.run(x)))


def test_dense_array_handle_and_run_without_y_in():
    w = np.random.default_rng(3).standard_normal((37, 300)).astype(np.float32)
    h = prepare(w, device="cpu")
    assert h.format == "dense" and h.verify().ok
    x = np.linspace(-1, 1, 300).astype(np.float32)
    assert_close(h.run(torch.from_numpy(x), alpha=2.0).numpy(),
                 2.0 * (w.astype(np.float64) @ x))


def test_unported_and_unknown_formats_raise():
    coo = _case("random")
    with pytest.raises(ValueError):
        SpmvHandle(coo, format="nope", device="cpu")


def test_accelerator_select_and_run():
    coo = _case("banded")
    w = np.random.default_rng(5).standard_normal((64, 200)).astype(np.float32)
    acc = Accelerator(device="cpu")
    i = acc.create_sparse_handle(coo, format="window")
    j = acc.create_dense_handle(w)
    assert (i, j) == (0, 1)
    assert acc.resident_bytes == (acc.handle(i).device_bytes
                                  + acc.handle(j).device_bytes)
    acc.load_matrices()
    assert acc.loaded
    x, y_in = inputs(coo)
    assert_close(acc.run_kernel(x, y_in, ALPHA, BETA).numpy(),
                 acc.handle(i).run(x, y_in, ALPHA, BETA).numpy())
    acc.select_matrix(j)
    xd = np.ones(200, np.float32)
    assert_close(acc.run_kernel(xd).numpy(), w.astype(np.float64).sum(1))


def test_accelerator_budget_exhaustion_returns_minus_one():
    coo = _case("random")
    acc = Accelerator(budget_bytes=1, device="cpu")
    assert acc.create_sparse_handle(coo, format="block") == -1
    assert acc.resident_bytes == 0


def test_accelerator_unknown_id_raises_key_error():
    acc = Accelerator(device="cpu")
    acc.create_sparse_handle(_case("tiny"))
    with pytest.raises(KeyError):
        acc.select_matrix(7)


def test_accelerator_wrong_x_length_raises_value_error():
    coo = _case("random")
    acc = Accelerator(device="cpu")
    acc.create_sparse_handle(coo, format="ellx")
    with pytest.raises(ValueError):
        acc.run_kernel(np.ones(coo.num_cols + 1, np.float32))
