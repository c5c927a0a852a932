"""The port's tuner against the JAX package's.

- ``DSE.explore`` (model only, the TPU v5e profile of both packages) gives
  the JAX tuner's format and config, the same ranked candidate labels, and
  estimates equal to rtol 1e-9, on every case of ``small_matrix_cases``
  and on four suite stand-ins at scale 0.05; ``tune`` (model only) and
  ``hispmv_tpu_torch.tune`` likewise.
- The port's counterparts of ``tests/test_tune.py``: the stream-step and
  block-count estimators against the planners, the cache round trip, the
  fingerprint, the model-only pick that is never bf16, measured tuning on
  the CPU (``device="cpu"``), the measured cache's resume, and the sanity
  floor.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
from conftest import small_matrix_cases

from hispmv_tpu.formats import synth as jsynth
from hispmv_tpu.tune import DSE as JDSE
from hispmv_tpu.tune import tune as jtune
from hispmv_tpu.tune.dse import matrix_fingerprint as jmatrix_fingerprint
import hispmv_tpu_torch
from hispmv_tpu_torch import SpmvConfig
from hispmv_tpu_torch.formats.matrix import COOMatrix, coo_from_dense
from hispmv_tpu_torch.formats.synth import (
    banded_coo,
    blocked_coo,
    powerlaw_coo,
    random_coo,
)
from hispmv_tpu_torch.plan.blocks import build_block_plan
from hispmv_tpu_torch.plan.partition import build_plan, derive_split_threshold
from hispmv_tpu_torch.tune import DSE, TuneResult, tune
from hispmv_tpu_torch.tune import dse as dse_mod
from hispmv_tpu_torch.tune.cost import V5E
from hispmv_tpu_torch.tune.dse import (
    count_blocks,
    estimate_stream_steps,
    matrix_fingerprint,
    measure_candidates,
)

SUITE = ["trans5", "poli_large", "language", "TSOPF_RS_b2383"]
CASES = list(small_matrix_cases()) + [f"{n}:0.05" for n in SUITE]


@functools.lru_cache(maxsize=None)
def _jcoo(name):
    if ":" in name:
        n, scale = name.split(":")
        return jsynth.suite_matrix(n, float(scale), seed=0)
    return small_matrix_cases()[name]


@functools.lru_cache(maxsize=None)
def _coo(name):
    j = _jcoo(name)
    return COOMatrix(j.shape, j.rows, j.cols, j.values)


def assert_same_result(res, jres):
    assert res.format == jres.format
    assert dataclasses.asdict(res.config) == dataclasses.asdict(jres.config)
    assert [lbl for lbl, _ in res.candidates] == [
        lbl for lbl, _ in jres.candidates]
    np.testing.assert_allclose([s for _, s in res.candidates],
                               [s for _, s in jres.candidates], rtol=1e-9,
                               atol=0)
    np.testing.assert_allclose(res.est_seconds, jres.est_seconds, rtol=1e-9)
    assert not res.measured and res.n_measured == 0


@pytest.mark.parametrize("name", CASES)
def test_dse_explore_equals_jax(name):
    assert_same_result(DSE().explore(_coo(name)), JDSE().explore(_jcoo(name)))


@pytest.mark.parametrize("name", ["powerlaw", "single_dense_row",
                                  "trans5:0.05"])
def test_model_only_tune_equals_jax(name):
    res = tune(_coo(name), profile=V5E)
    assert_same_result(res, jtune(_jcoo(name)))
    # the package-level name reaches the same tuner, loaded lazily
    assert_same_result(
        hispmv_tpu_torch.__getattr__("tune")(_coo(name), profile=V5E),
        jtune(_jcoo(name)))


def test_default_profile_is_the_tpu_v5e():
    assert V5E.name == "tpu-v5e"
    assert DSE().model.p == V5E


def test_stream_step_estimator_matches_planner():
    for coo in [
        powerlaw_coo(500, 500, 20_000, seed=0),
        banded_coo(300, 300, 3000, seed=1),
        random_coo(257, 129, 2000, seed=2),
    ]:
        cfg = SpmvConfig()
        plan = build_plan(coo, cfg)
        thresh = cfg.split_threshold or derive_split_threshold(
            coo.nnz, cfg.num_pes
        )
        est = estimate_stream_steps(coo.row_lengths(), cfg.num_pes, thresh)
        assert est == plan.num_steps, (est, plan.num_steps)


def test_block_count_exact_when_unsampled():
    coo = powerlaw_coo(2000, 2000, 50_000, seed=3)
    for bh in (8, 16, 32):
        got = count_blocks(coo.rows, coo.cols, bh, coo.num_cols)
        plan = build_block_plan(coo, block_h=bh)
        # the planner inserts zero blocks for empty row-blocks
        assert got <= plan.num_blocks
        assert plan.num_blocks - got <= plan.num_row_blocks


def test_dse_picks_dense_for_dense_matrix():
    dense = np.random.default_rng(0).standard_normal(
        (256, 256)).astype(np.float32)
    assert DSE().explore(coo_from_dense(dense)).format == "dense"


def test_dse_hypersparse_guard():
    """No block or window candidate past 100 B a nonzero; a per-nonzero
    engine wins."""
    coo = random_coo(50_000, 1_000_000, 100_000, seed=5)
    res = DSE().explore(coo)
    assert res.format in ("ellx", "split", "routed"), res.candidates
    assert all(not lbl.startswith(("block", "win"))
               for lbl, _ in res.candidates)


def test_dse_candidates_ranked():
    res = DSE().explore(powerlaw_coo(5000, 5000, 100_000, seed=6))
    secs = [s for _, s in res.candidates]
    assert secs == sorted(secs)
    assert res.est_seconds == secs[0]
    assert res.est_gflops > 0


def test_tune_cache_roundtrip(tmp_path):
    coo = powerlaw_coo(1000, 1000, 20_000, seed=7)
    cache = str(tmp_path / "best_configs.json")
    r1 = tune(coo, cache_path=cache, profile=V5E)
    r2 = tune(coo, cache_path=cache, profile=V5E)  # a hit
    assert (r1.format, r1.config) == (r2.format, r2.config)
    assert abs(r1.est_seconds - r2.est_seconds) < 1e-12
    assert r2.candidates == [tuple(c) for c in r1.candidates]
    tune(random_coo(500, 500, 5000, seed=8), cache_path=cache, profile=V5E)
    with open(cache) as f:
        entries = json.load(f)
    assert len(entries) == 2
    key = f"{matrix_fingerprint(coo)}:{V5E.name}:"
    assert any(k.startswith(key) for k in entries)


def test_fingerprint_distinguishes_and_equals_jax():
    a = random_coo(100, 100, 1000, seed=9)
    b = random_coo(100, 100, 1000, seed=10)
    assert matrix_fingerprint(a) != matrix_fingerprint(b)
    assert matrix_fingerprint(a) == matrix_fingerprint(a)
    ja = jsynth.random_coo(100, 100, 1000, seed=9)
    assert matrix_fingerprint(a) == jmatrix_fingerprint(ja)


def test_measured_tune_cpu():
    """On the CPU the times rank the plain versions, not the card; the
    contract is that measured tuning completes, times each shortlisted
    candidate there, and returns an accuracy-guarded winner."""
    coo = blocked_coo(1000, 1000, 30_000, seed=30)
    res = tune(coo, measure=2, device="cpu")
    assert res.measured and res.n_measured >= 2
    assert res.format in ("block", "window", "dense", "ellx", "split",
                          "routed")
    assert res.est_seconds > 0
    times = [s for _, s in res.candidates[:res.n_measured]]
    assert times == sorted(times) and res.est_seconds == times[0]
    model = DSE().explore(coo)
    assert {lbl for lbl, _ in res.candidates} == {
        lbl for lbl, _ in model.candidates}


def test_model_only_pick_is_never_bf16():
    """bf16 payloads miss the rtol 1e-3 acceptance on general data; only
    measured tuning (accuracy-guarded) may pick one."""
    coo = blocked_coo(20_000, 20_000, 4_000_000, seed=40)
    res = DSE().explore(coo)
    assert res.config.value_dtype == "float32"
    assert any(lbl.endswith("-bf16") for lbl, _ in res.candidates)


def test_measured_cache_resumes_and_skips(tmp_path, monkeypatch):
    """Each measurement is written through to <cache>.measured, and a
    later measured tune reuses it without building a handle."""
    from hispmv_tpu_torch.api import handle as handle_mod

    coo = blocked_coo(1200, 1200, 40_000, seed=31)
    cache_path = str(tmp_path / "tune.json")
    builds = []
    orig = handle_mod.SpmvHandle

    class CountingHandle(orig):
        def __init__(self, *a, **kw):
            builds.append(kw.get("format"))
            super().__init__(*a, **kw)

    monkeypatch.setattr(handle_mod, "SpmvHandle", CountingHandle)
    res1 = tune(coo, cache_path=cache_path, measure=2, device="cpu")
    n1 = len(builds)
    assert n1 >= 1
    with open(cache_path + ".measured") as f:
        entries = json.load(f)
    assert any(v.get("t") is not None for v in entries.values())
    # the decision cache gone, the measurements kept: no new handle
    os.remove(cache_path)
    res2 = tune(coo, cache_path=cache_path, measure=2, device="cpu")
    assert len(builds) == n1
    assert res2.format == res1.format


def test_measured_winner_sanity_floor(monkeypatch):
    """A measured winner more than 4x slower than the model-best of an
    unmeasured family leaves the model's pick standing: here the
    model-best (routed) fails to measure and the stream candidate, within
    2.5x of it in the model and so shortlisted, measures 1 s."""
    coo = blocked_coo(800, 800, 20_000, seed=32)
    res = TuneResult(
        format="routed",
        config=SpmvConfig(),
        est_seconds=1e-6,  # unreachably fast
        est_gflops=1.0,
        candidates=[("routed", 1e-6), ("stream", 2e-6)],
    )
    timed = []

    def bench(h, x):
        timed.append(h.format)
        if h.format != "stream":
            raise RuntimeError("candidate cannot be timed")
        return 1.0, h.run(x).numpy()

    monkeypatch.setattr(dse_mod, "bench_spmv", bench)
    out = measure_candidates(coo, res, top=1, device="cpu")
    assert timed == ["routed", "stream"]
    assert out is res and not out.measured
    # the same measurement with the routed family measured stands
    monkeypatch.setattr(dse_mod, "bench_spmv",
                        lambda h, x: (1.0 if h.format == "stream" else 2.0,
                                      h.run(x).numpy()))
    out = measure_candidates(coo, res, top=1, device="cpu")
    assert out.measured and out.format == "stream" and out.n_measured == 2
