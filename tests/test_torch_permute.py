"""B11 (the within-window permutation stage) and the permutation planner in
the port against the JAX package.

A permutation does no arithmetic, so every comparison here is exact:
- the native colouring equals the Python walk ``_color_py``;
- the permutation plans' route arrays equal the JAX planner's;
- ``pack_stage`` equals the JAX packer;
- ``permute_stage_plain`` equals ``permute_stage_pallas`` in interpret mode
  bit for bit on identical arrays;
- ``permute_apply`` equals ``x[perm]`` bit for bit, also on a view that
  is not 16-byte aligned (the kernel reads by 16 bytes; ``permute_apply``
  copies such a view first);
- the wrapper's alignment check refuses a view off a 16-byte boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hispmv_tpu.ops.permute import pack_stage as jpack_stage
from hispmv_tpu.ops.permute import permute_stage_pallas
from hispmv_tpu.plan.permute import build_permute_plan as jbuild_permute_plan
from hispmv_tpu_torch import native
from hispmv_tpu_torch.ops.spmv_chunked import check_aligned
from hispmv_tpu_torch.ops.permute import (
    pack_permute_into,
    pack_permute_plan,
    pack_stage,
    panel_permute_apply_from,
    permute_apply,
    permute_stage,
    permute_stage_plain,
)
from hispmv_tpu_torch.plan.permute import (
    PANEL,
    WINDOW,
    _color_py,
    build_permute_plan,
    color_permutation,
    degree_rank_perms,
    permute_numpy,
)

SIZES = [1, 700, 1024, 4096, 9000]


def _perm(n):
    return np.random.default_rng(n).permutation(n)


def _assert_coloring(colors, sw, dw, d):
    for side in (sw, dw):
        key = side.astype(np.int64) * d + colors
        assert len(np.unique(key)) == len(key)  # distinct per vertex
    assert colors.min() >= 0 and colors.max() < d


@pytest.mark.parametrize("d,W", [(8, 16), (1024, 4), (4, 300)])
def test_native_coloring_equals_python_walk(d, W):
    """A d-regular bipartite multigraph over W vertices a side."""
    rng = np.random.default_rng(d + W)
    n = d * W
    sw = rng.permutation(np.repeat(np.arange(W), d))
    dw = np.repeat(np.arange(W), d)
    got = native.euler_color(sw, dw, d)
    np.testing.assert_array_equal(got, _color_py(sw.astype(np.int64),
                                                 dw.astype(np.int64), d))
    assert got.dtype == np.int32 and len(got) == n
    _assert_coloring(got, sw, dw, d)


def test_native_coloring_rejects_bad_input():
    with pytest.raises(ValueError, match="power of two"):
        native.euler_color(np.zeros(6), np.zeros(6), 6)
    with pytest.raises(ValueError, match="non-negative"):
        native.euler_color(np.array([-1, 0]), np.array([0, 0]), 2)
    assert len(color_permutation(np.zeros(0), np.zeros(0))) == 0


@pytest.mark.parametrize("n", SIZES)
def test_permute_plans_equal_jax(n):
    perm = _perm(n)
    plan, jplan = build_permute_plan(perm), jbuild_permute_plan(perm)
    assert (plan.n, plan.num_windows) == (jplan.n, jplan.num_windows)
    for s, js in ((plan.s1, jplan.s1), (plan.s2, jplan.s2),
                  (plan.s3, jplan.s3)):
        assert s.num_windows == js.num_windows
        np.testing.assert_array_equal(s.route, js.route)
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    np.testing.assert_array_equal(permute_numpy(plan, x), x[perm])


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("n", [700, 9000])
def test_pack_stage_equals_jax(n, bucket):
    plan = build_permute_plan(_perm(n))
    for s in (plan.s1, plan.s2, plan.s3):
        (route,), dims = pack_stage(s, bucket=bucket)
        (jroute,), jdims = jpack_stage(s, bucket=bucket)
        assert dims == jdims
        np.testing.assert_array_equal(route, jroute)


@pytest.mark.parametrize("n", [700, 9000])
def test_plain_b11_equals_pallas_bit_for_bit(n):
    plan = build_permute_plan(_perm(n))
    rng = np.random.default_rng(2)
    for s in (plan.s1, plan.s2, plan.s3):
        (route,), dims = jpack_stage(s)
        a = rng.standard_normal((dims[0] * dims[1] * 8, 128)).astype(
            np.float32)
        got = permute_stage_plain((torch.from_numpy(route),), dims,
                                  torch.from_numpy(a))
        want = permute_stage_pallas((jnp.asarray(route),), dims,
                                    jnp.asarray(a), interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", SIZES + [50_000])
def test_permute_apply_equals_gather(n):
    perm = _perm(n)
    dev = pack_permute_plan(build_permute_plan(perm), device="cpu")
    assert [d[1] for d in dev["dims"]] == [1, 1, 1]  # no padded window
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    y = permute_apply(dev, dev["arrays"], torch.from_numpy(x))
    np.testing.assert_array_equal(y.numpy(), x[perm])
    # extra entries past n are ignored
    longer = torch.from_numpy(np.concatenate([x, np.ones(5, np.float32)]))
    np.testing.assert_array_equal(
        permute_apply(dev, dev["arrays"], longer).numpy(), x[perm])


@pytest.mark.parametrize("offset", [1, 2, 3, 4])
def test_permute_apply_on_a_view_equals_gather(offset):
    """x a view ``offset`` elements into a longer array, n a whole number
    of windows, so that S1 reads the view without padding it."""
    n = 5 * WINDOW
    perm = _perm(n)
    dev = pack_permute_plan(build_permute_plan(perm), device="cpu")
    x = np.random.default_rng(offset).standard_normal(n + offset).astype(
        np.float32)
    view = torch.from_numpy(x)[offset:]
    assert (view.data_ptr() % 16 == 0) == (offset == 4)
    y = permute_apply(dev, dev["arrays"], view)
    np.testing.assert_array_equal(y.numpy(), x[offset:][perm])


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_alignment_check_refuses_views_off_16_bytes(dtype):
    base = torch.zeros(64, dtype=dtype)  # the allocator aligns to 64 bytes
    assert base.data_ptr() % 16 == 0
    check_aligned("permute_stage", base, base[4:], base[8:].view(7, 8))
    for off in (1, 2, 3, 5):
        with pytest.raises(ValueError, match="permute_stage.*16-byte"):
            check_aligned("permute_stage", base, base[off:])


def test_panel_permute_apply_from_equals_gather():
    """Panel-local rank permutations of an axis longer than one panel, as
    the rank-space handle applies them."""
    n = PANEL + 3000
    deg = np.random.default_rng(4).integers(0, 50, n)
    _, perms = degree_rank_perms(deg)
    assert [len(p) for p in perms] == [PANEL, 3000]
    d = {}
    metas = [pack_permute_into(d, build_permute_plan(p), f"xp{i}_", "cpu")
             for i, p in enumerate(perms)]
    x = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    y = panel_permute_apply_from(d, metas, "xp", torch.from_numpy(x))
    full = np.concatenate([perms[0], PANEL + perms[1]])
    np.testing.assert_array_equal(y.numpy(), x[full])


def _stage_args():
    plan = build_permute_plan(_perm(3000))
    (route,), dims = pack_stage(plan.s1)
    a = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (dims[0] * dims[1] * 8, 128)).astype(np.float32))
    return (torch.from_numpy(route),), dims, a


def test_b11_wrapper_on_cpu_takes_plain_version():
    args = _stage_args()
    before = permute_stage.launches
    torch.testing.assert_close(permute_stage(*args),
                               permute_stage_plain(*args), rtol=0, atol=0)
    assert permute_stage.launches == before


def test_b11_wrapper_rejects_bad_arguments():
    arrays, dims, a = _stage_args()
    with pytest.raises(TypeError):
        permute_stage((arrays[0].long(),), dims, a)
    with pytest.raises(TypeError):
        permute_stage(arrays, dims, a.double())
    with pytest.raises(ValueError):
        permute_stage(arrays, (dims[0] * 2, dims[1]), a)
    with pytest.raises(ValueError):
        permute_stage(arrays, dims, a[:8])


def test_b11_wrapper_off_cpu_never_takes_plain_version():
    arrays, dims, a = _stage_args()
    with pytest.raises(ValueError, match="no kernel"):
        permute_stage((arrays[0].to("meta"),), dims, a.to("meta"))


def test_window_count_limit():
    with pytest.raises(ValueError):
        build_permute_plan(np.arange(WINDOW * WINDOW + 1))
