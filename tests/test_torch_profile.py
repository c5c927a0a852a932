"""The device profiles (``hispmv_tpu_torch/profiles.py``) and the planners
that take them.

- ``device_profile`` gives ``V5E`` on the CPU and ``H100`` on a CUDA device
  (no card needed to ask).
- Under ``V5E`` every planner equals the JAX planner array for array on
  the cases of ``small_matrix_cases``: routed, banded (small cells, so
  that a case has several), the gathered cost and the routed planner's
  diversion to a gathered side-plan, ELLX's ``k_base``, split, the
  permutation's cost and the model-only search.
- Under ``H100`` the same planners build plans whose ``run`` and
  ``linear`` on the CPU match the float64 golden at rtol 1e-3, and a
  handle prepared with ``profile=H100`` takes H100's layout budgets and
  B2/B6 rule.
- No planner module keeps a cost of its own as a module global, and
  ``tune`` caches V5E's and H100's picks under different keys, V5E's
  under the JAX tuner's key.
"""

import dataclasses
import functools
import hashlib
import json
import re

import numpy as np
import pytest
import torch
from conftest import small_matrix_cases

import hispmv_tpu.plan.gathered as JG
from hispmv_tpu.ops.spmv_ellx import build_ellx_plan as jbuild_ellx_plan
from hispmv_tpu.ops.spmv_ellx import choose_k_base as jchoose_k_base
from hispmv_tpu.plan import blocks as JB
from hispmv_tpu.plan import permute as JP
from hispmv_tpu.plan import routed as JR
from hispmv_tpu.plan import split as JSP
from hispmv_tpu.tune import DSE as JDSE
from hispmv_tpu.tune.cost import V5E as JV5E
from hispmv_tpu.tune.dse import matrix_fingerprint as jmatrix_fingerprint
import hispmv_tpu_torch.api.handle as handle_mod
import hispmv_tpu_torch.ops.spmv_ellx as ellx_mod
import hispmv_tpu_torch.ops.spmv_routed as ops_routed_mod
import hispmv_tpu_torch.plan.gathered as G
import hispmv_tpu_torch.plan.permute as P
import hispmv_tpu_torch.plan.routed as R
import hispmv_tpu_torch.plan.split as SP
import hispmv_tpu_torch.tune.dse as dse_mod
from hispmv_tpu_torch import Accelerator, SpmvConfig, SpmvHandle
from hispmv_tpu_torch.cli import main as cli_main
from hispmv_tpu_torch.formats.matrix import COOMatrix
from hispmv_tpu_torch.formats.synth import blocked_coo, powerlaw_coo
from hispmv_tpu_torch.models import AcceleratorLayerManager
from hispmv_tpu_torch.ops.spmv_chunked import chunk_for
from hispmv_tpu_torch.ops.spmv_ellx import build_ellx_plan, choose_k_base
from hispmv_tpu_torch.plan.blocks import LANES, build_block_plan
from hispmv_tpu_torch.profiles import (
    H100,
    PROFILES,
    V5E,
    DeviceProfile,
    device_profile,
    profile_key,
)
from hispmv_tpu_torch.tune import DSE, tune
from hispmv_tpu_torch.tune import cost as cost_mod

CASES = sorted(small_matrix_cases())
RTOL = 1e-3


@functools.lru_cache(maxsize=None)
def _coo(name):
    j = small_matrix_cases()[name]
    return COOMatrix(j.shape, j.rows, j.cols, j.values)


def _same(a, b, where):
    """Equal field for field: arrays bit for bit, lists and dataclasses
    element by element, the rest by ==."""
    if dataclasses.is_dataclass(a):
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)], where
        for n in fa:
            _same(getattr(a, n), getattr(b, n), f"{where}.{n}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _same(u, v, f"{where}[{i}]")
    else:
        assert a == b, where


def _golden(coo, x):
    return coo.matvec(np.asarray(x, np.float64))


def _close(y, want, rtol=RTOL):
    np.testing.assert_allclose(y, want, rtol=rtol,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


# -- device_profile ----------------------------------------------------------


@pytest.mark.parametrize("device,want", [
    ("cpu", V5E), (torch.device("cpu"), V5E), ("cuda", H100),
    (torch.device("cuda"), H100), (torch.device("cuda", 0), H100),
    ("cuda:1", H100),
])
def test_device_profile(device, want):
    assert device_profile(device) is want


def test_device_profile_refuses_other_devices():
    with pytest.raises(ValueError, match="no device profile"):
        device_profile("meta")


def test_profiles_are_distinct_and_named():
    assert V5E == DeviceProfile() and V5E.name == "tpu-v5e"
    assert H100.name == "nvidia-h100-80gb-hbm3" and H100 != V5E
    assert PROFILES == {"tpu-v5e": V5E, "nvidia-h100-80gb-hbm3": H100}
    # tune/cost.py re-exports the profiles
    assert cost_mod.V5E is V5E and cost_mod.H100 is H100
    assert cost_mod.device_profile is device_profile


def test_v5e_holds_the_jax_packages_values():
    """Every field the JAX package keeps, from the file that keeps it."""
    j = dataclasses.asdict(JV5E)
    assert {k: getattr(V5E, k) for k in j} == j
    assert (V5E.tile_base_ns, V5E.tile_w_ns, V5E.tile_ov_ns, V5E.tile_wl_ns,
            V5E.tile_bnd_ns, V5E.residual_ns, V5E.launch_ns) == (
        JR.TILE_BASE_NS, JR.TILE_W_NS, JR.TILE_OV_NS, JR.TILE_WL_NS,
        JR.TILE_BND_NS, JR.RESIDUAL_NS, JR.LAUNCH_NS)
    assert (V5E.gath_tile_ns, V5E.gath_stage_ns, V5E.gath_launch_ns) == (
        JG.GATH_TILE_NS, JG.GATH_STAGE_NS, JG.GATH_LAUNCH_NS)
    assert (V5E.permute_window_ns, V5E.transpose_ns_per_mb) == (
        JP.STAGE_WINDOW_NS, JP.TRANSPOSE_NS_PER_MB)
    assert V5E.body_bytes_per_nnz == JSP._BODY_BYTES_PER_NNZ
    from hispmv_tpu.api.handle import SpmvHandle as JSpmvHandle
    from hispmv_tpu.ops import spmv_ellx as JE

    assert (V5E.ellx_choose_bytes_per_s, V5E.overflow_block_s,
            V5E.overflow_launch_s) == (JE._ELLX_BYTES_PER_S,
                                       JE._OVERFLOW_BLOCK_S,
                                       JE._OVERFLOW_LAUNCH_S)
    assert (V5E.chunked_budget_bytes, V5E.batched_budget_bytes,
            V5E.panel_ncb, V5E.panel_y_bytes) == (
        JSpmvHandle._CHUNKED_VMEM_BUDGET, JSpmvHandle._CHUNKED_VMEM_BUDGET,
        JSpmvHandle._PANEL_NCB, JSpmvHandle._PANEL_Y_BYTES)


def test_h100_has_a_value_for_every_field():
    for f in dataclasses.fields(DeviceProfile):
        v = getattr(H100, f.name)
        assert v is not None and (isinstance(v, str) or v >= 0), f.name
    # what the card lacks: a VMEM-sized plan budget
    assert H100.hbm_bytes > V5E.hbm_bytes


# -- under V5E, the JAX package's plans ---------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_routed_plan_under_v5e_equals_jax(name):
    coo = _coo(name)
    _same(R.build_routed_plan(coo, profile=V5E), JR.build_routed_plan(coo),
          "routed")
    _same(R.build_ranked_routed_plan(coo, profile=V5E),
          JR.build_ranked_routed_plan(coo), "ranked")
    rows, cols = coo.rows, coo.cols
    if coo.nnz:
        assert R.best_routed_estimate(rows, cols, coo.shape, profile=V5E) \
            == JR.best_routed_estimate(rows, cols, coo.shape)
    assert R.routed_vmem_ok(coo.shape, V5E) == JR.routed_vmem_ok(coo.shape)


@pytest.mark.parametrize("name", CASES)
def test_banded_plan_under_v5e_equals_jax(name):
    coo = _coo(name)
    kw = dict(band_rows=1024, panel_cols=2048)
    for rank in (False, True):
        _same(R.build_banded_routed_plan(coo, rank_sort=rank, profile=V5E,
                                         **kw),
              JR.build_banded_routed_plan(coo, rank_sort=rank, **kw),
              f"banded rank {rank}")
    assert R.estimate_banded_routed_ns(coo.rows, coo.cols, coo.shape,
                                       profile=V5E, **kw) == \
        JR.estimate_banded_routed_ns(coo.rows, coo.cols, coo.shape, **kw)


@pytest.mark.parametrize("name", CASES)
def test_gathered_cost_under_v5e_equals_jax(name):
    coo = _coo(name)
    T = max(coo.nnz // 1000, 1)
    K = max(-(-coo.num_cols // 1024), 1)
    for panels in (0, 1, 3):
        assert G.gathered_cost_ns(T, K, panels, profile=V5E) == \
            JG.gathered_cost_ns(T, K, panels)
    assert G.gathered_cost_ns(0, K, 1, profile=H100) == 0.0
    n = coo.num_cols
    assert P.estimate_permute_cost_ns(n, V5E) == \
        JP.estimate_permute_cost_ns(n)


def test_gathered_diversion_under_v5e_equals_jax(monkeypatch):
    """With the same cheap gathered costs in both packages the routed
    planner diverts the same tiles to the same side-plan."""
    n = 16384
    rng = np.random.default_rng(3)
    rows = rng.integers(0, n, 150_000)
    cols = rng.integers(0, n, 150_000)
    key = np.unique(rows.astype(np.int64) * n + cols)
    coo = COOMatrix((n, n), (key // n).astype(np.int32),
                    (key % n).astype(np.int32),
                    rng.standard_normal(len(key)).astype(np.float32))
    for k, v in (("GATH_TILE_NS", 1.0), ("GATH_STAGE_NS", 1.0),
                 ("GATH_LAUNCH_NS", 0.0)):
        monkeypatch.setattr(JG, k, v)
    cheap = dataclasses.replace(V5E, gath_tile_ns=1.0, gath_stage_ns=1.0,
                                gath_launch_ns=0.0)
    p = R.build_routed_plan(coo, profile=cheap)
    assert p.gathered is not None
    _same(p, JR.build_routed_plan(coo), "routed gathered")
    # V5E's own costs divert nothing here, as the JAX package's
    monkeypatch.undo()
    assert R.build_routed_plan(coo, profile=V5E).gathered is None
    assert JR.build_routed_plan(coo).gathered is None


@pytest.mark.parametrize("name", CASES)
def test_ellx_k_base_under_v5e_equals_jax(name):
    coo = _coo(name)
    for bh in (1, 8):
        bp = build_block_plan(coo, block_h=bh)
        counts = np.bincount(bp.block_rows, minlength=bp.num_row_blocks)
        assert choose_k_base(counts, bh, V5E) == jchoose_k_base(counts, bh)
        _same(build_ellx_plan(bp, profile=V5E),
              jbuild_ellx_plan(JB.build_block_plan(coo, block_h=bh)),
              f"ellx bh {bh}")


@pytest.mark.parametrize("name", CASES)
def test_split_plan_under_v5e_equals_jax(name):
    coo = _coo(name)
    _same(SP.build_split_plan(coo, profile=V5E), JSP.build_split_plan(coo),
          "split")


@pytest.mark.parametrize("name", CASES)
def test_dse_under_v5e_equals_jax(name):
    res, jres = DSE(V5E).explore(_coo(name)), JDSE().explore(_coo(name))
    assert (res.format, dataclasses.asdict(res.config)) == (
        jres.format, dataclasses.asdict(jres.config))
    assert [c[0] for c in res.candidates] == [c[0] for c in jres.candidates]
    np.testing.assert_allclose([c[1] for c in res.candidates],
                               [c[1] for c in jres.candidates], rtol=1e-9)


# -- under H100, plans that run ----------------------------------------------


H100_FORMATS = ["routed", "ellx", "split", "block", "window", "auto"]


@pytest.mark.parametrize("fmt", H100_FORMATS)
@pytest.mark.parametrize("name", CASES)
def test_h100_handles_match_the_golden(name, fmt):
    coo = _coo(name)
    h = SpmvHandle(coo, format=fmt, device="cpu", profile=H100)
    assert h.profile is H100
    rng = np.random.default_rng(7)
    x = rng.standard_normal(coo.num_cols).astype(np.float32)
    _close(h.run(x).numpy(), _golden(coo, x))
    xb = rng.standard_normal((3, coo.num_cols)).astype(np.float32)
    _close(h.linear(xb).numpy(), (coo.to_scipy() @ xb.astype(np.float64).T).T)


@pytest.mark.parametrize("name", CASES)
def test_h100_banded_and_tuned_plans_run(name):
    coo = _coo(name)
    x = np.random.default_rng(8).standard_normal(coo.num_cols).astype(
        np.float32)
    plan = R.build_banded_routed_plan(coo, rank_sort=True, band_rows=1024,
                                      panel_cols=2048, profile=H100)
    h = SpmvHandle.from_plan(plan, device="cpu", profile=H100)
    _close(h.run(x).numpy(), _golden(coo, x))
    res = tune(coo, device="cpu", profile=H100)
    h = SpmvHandle(coo, res.config, res.format, device="cpu", profile=H100)
    _close(h.run(x).numpy(), _golden(coo, x))


def test_h100_split_and_ellx_plans_hold_the_golden():
    coo = powerlaw_coo(3000, 3000, 60_000, seed=9)
    x = np.random.default_rng(9).standard_normal(3000).astype(np.float32)
    for plan in (SP.build_split_plan(coo, profile=H100),
                 build_ellx_plan(build_block_plan(coo, block_h=1),
                                 profile=H100)):
        h = SpmvHandle.from_plan(plan, device="cpu", profile=H100)
        _close(h.run(x).numpy(), _golden(coo, x))


def test_handle_takes_h100_layout_budgets_and_b2_rule():
    coo = blocked_coo(4000, 6000, 60_000, seed=10)
    h = SpmvHandle(coo, format="block", device="cpu", profile=H100)
    plan = h.plan
    need_c = ((plan.num_col_blocks * LANES + plan.num_row_blocks * 8) * 4
              + 2 * chunk_for(8) * 8 * LANES * 4)
    assert h._chunked == (need_c <= H100.chunked_budget_bytes)
    for B in (1, 8, 64, 4096):
        need_b = ((plan.num_col_blocks * LANES + plan.num_row_blocks * 8)
                  * B * 4 + 2 * chunk_for(8) * 8 * LANES * 4)
        assert h._block_uses_b2(B) == (
            h._chunked and need_b <= H100.batched_budget_bytes)
    # the same handle under budgets that force each layout and kernel
    tight = dataclasses.replace(H100, chunked_budget_bytes=0,
                                batched_budget_bytes=0)
    t = SpmvHandle(coo, format="block", device="cpu", profile=tight)
    assert t._tiled and not t._block_uses_b2(1)
    x = np.random.default_rng(10).standard_normal(6000).astype(np.float32)
    _close(t.run(x).numpy(), _golden(coo, x))


def test_entry_points_take_the_devices_profile():
    coo = _coo("blocked")
    assert SpmvHandle(coo, device="cpu").profile is V5E
    assert Accelerator(device="cpu").profile is V5E
    acc = Accelerator(device="cpu", profile=H100)
    mid = acc.create_sparse_handle(coo)
    assert acc.handle(mid).profile is H100
    mgr = AcceleratorLayerManager(Accelerator(device="cpu", profile=H100))
    assert mgr.accel.profile is H100
    plan = SpmvHandle(coo, format="ellx", device="cpu").plan
    assert SpmvHandle.from_plan(plan, device="cpu").profile is V5E
    assert SpmvHandle.from_plan(plan, device="cpu",
                                profile=H100).profile is H100


def test_cli_prints_the_active_profile(capsys):
    for args, name in (([], V5E.name), (["--profile", H100.name],
                                        H100.name)):
        assert cli_main(["@poli_large:0.2", "--format", "tune",
                         "--no-bench", "--device", "cpu", *args]) == 0
        out = capsys.readouterr().out
        assert f"model est ({name})" in out and f"profile={name}" in out


# -- no cost left in a module global; the cache keys ---------------------------


COST_NAME = re.compile(r"(_NS|_NS_PER_MB)$|^_ELLX_BYTES_PER_S$|^_OVERFLOW_"
                       r"|^_BODY_BYTES_PER_NNZ$")


@pytest.mark.parametrize("mod", [R, G, P, SP, ellx_mod, ops_routed_mod,
                                 handle_mod, dse_mod, cost_mod])
def test_no_planner_module_keeps_a_cost_global(mod):
    found = [n for n in vars(mod) if COST_NAME.search(n)]
    assert found == [], found
    for n in ("_CHUNKED_VMEM_BUDGET", "_PANEL_NCB", "_PANEL_Y_BYTES"):
        assert not hasattr(SpmvHandle, n)


def test_tune_caches_profiles_under_different_keys(tmp_path):
    coo = powerlaw_coo(1500, 1500, 30_000, seed=11)
    cache = str(tmp_path / "tune.json")
    r5 = tune(coo, cache_path=cache, profile=V5E)
    rh = tune(coo, cache_path=cache, profile=H100)
    with open(cache) as f:
        keys = sorted(json.load(f))
    assert len(keys) == 2
    assert {k.split(":")[1] for k in keys} == {V5E.name, H100.name}
    # V5E's key is the JAX tuner's: its fields hashed alone
    jpfp = hashlib.sha256(
        repr(dataclasses.astuple(JV5E)).encode()).hexdigest()[:8]
    assert f"{jmatrix_fingerprint(coo)}:{V5E.name}:{jpfp}" in keys
    assert profile_key(V5E) == jpfp != profile_key(H100)
    # a hit returns each profile's own pick
    assert tune(coo, cache_path=cache, profile=H100).candidates == [
        tuple(c) for c in rh.candidates]
    assert tune(coo, cache_path=cache, profile=V5E).est_seconds == \
        r5.est_seconds
    # a tune on a CUDA device plans under H100 without a card
    assert tune(coo, device="cuda").candidates == DSE(H100).explore(
        coo).candidates
