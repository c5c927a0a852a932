"""The sharded executors on a ``ProcessMesh``: one gloo rank a process.

D ranks (D = 2 and 4) join one gloo group through a ``file://`` store in
the test's temporary directory and run every executor in every ``x_mode``
(block replicated / gather, window replicated / gather, chunked ring /
replicated) on the ``blocked`` and ``powerlaw`` matrices of
``tests/test_torch_dist.py``, and at D = 4 on ``empty_shards`` (a rank
with an empty shard).  The ranks import only the port and write each
full y and their counters to an ``.npz``; this process, which has JAX on
the conftest's 8 virtual CPU devices, holds each rank's y

- equal to the one-process port's on ``make_mesh(devices=["cpu"] * D)``,
  bit for bit: a rank's shard, its x and the plain kernel are that form's
  at the same position, so only the exchange could differ;
- to the JAX package's executor on ``jshard.make_mesh(D)`` (Pallas in
  interpret mode, the call under ``jax.jit``) at rtol=1e-5, atol=1e-5*max(1, max|y|), as
  ``test_torch_dist.py::test_executor_matches_jax`` (fp32 on both sides,
  only the order of summation differs);
- to the float64 golden at rtol=1e-3, atol=1e-4.

It also checks each rank's D - 1 ring sends, that ``device_bytes`` counts
the rank's own shard only, the errors (a plan of the wrong D, an x of the
wrong length, no group joined, a gloo group given a card, a peer that
never joins), and ``python -m hispmv_tpu_torch.dist.dryrun --device cpu``
under ``torch.distributed.run --nproc-per-node 4``.
"""

import functools
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from hispmv_tpu.dist import shard as jshard
from hispmv_tpu.formats import synth as jsynth
from hispmv_tpu_torch.dist import (
    build_sharded_block_plan,
    build_sharded_chunked_plan,
    build_sharded_window_plan,
    local_device,
    make_mesh,
    make_process_mesh,
    spmv_sharded,
    spmv_sharded_chunked,
    spmv_sharded_window,
)
from hispmv_tpu_torch.dist.shard import _shard_arrays
from hispmv_tpu_torch.formats import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# seconds for every process of this file (a group's collectives time out
# after 60)
TIMEOUT_S = 180

# name -> (generator, args, seed): those of tests/test_torch_dist.py
MATRICES = {
    "blocked": ("blocked_coo", (800, 900, 20_000), 1),
    "powerlaw": ("powerlaw_coo", (900, 1100, 25_000), 7),
    "empty_shards": ("random_coo", (16, 200, 100), 5),
}
PAIRS = [("block", "replicated"), ("block", "gather"),
         ("window", "replicated"), ("window", "gather"),
         ("chunked", "ring"), ("chunked", "replicated")]
CASES = ([(D, name, kind, mode) for D in (2, 4)
          for name in ("blocked", "powerlaw") for kind, mode in PAIRS]
         + [(4, "empty_shards", kind, mode) for kind, mode in PAIRS])
PLANS = {  # the port's builder, the JAX package's
    "block": (build_sharded_block_plan, jshard.build_sharded_block_plan),
    "window": (build_sharded_window_plan, jshard.build_sharded_window_plan),
    "chunked": (lambda c, d: build_sharded_chunked_plan(c, d, chunk=16),
                lambda c, d: jshard.build_sharded_chunked_plan(c, d,
                                                               chunk=16)),
}
EXECUTORS = {
    "block": (spmv_sharded, jshard.spmv_sharded),
    "window": (spmv_sharded_window, jshard.spmv_sharded_window),
    "chunked": (spmv_sharded_chunked, jshard.spmv_sharded_chunked),
}

# One rank: joins the group, runs every case of its D, writes an .npz of
# each full y and a JSON of its counters and the errors it was shown.
RANK = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np, torch, torch.distributed as dist
    from hispmv_tpu_torch.dist import (
        ProcessMesh, build_sharded_block_plan, build_sharded_chunked_plan,
        build_sharded_window_plan, init_distributed, make_process_mesh,
        spmv_sharded, spmv_sharded_chunked, spmv_sharded_window, to_device)
    from hispmv_tpu_torch.dist.shard import device_bytes
    from hispmv_tpu_torch.formats import synth

    store, D, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \\
        sys.argv[4]
    matrices, cases = json.loads(sys.argv[5]), json.loads(sys.argv[6])
    builds = {"block": build_sharded_block_plan,
              "window": build_sharded_window_plan,
              "chunked": lambda c, d: build_sharded_chunked_plan(c, d,
                                                                 chunk=16)}
    runs = {"block": spmv_sharded, "window": spmv_sharded_window,
            "chunked": spmv_sharded_chunked}
    init_distributed(store, D, rank, backend="gloo",
                     timeout=datetime.timedelta(seconds=60))
    mesh = make_process_mesh("cpu")
    ys, meta, plans = {}, {"rank": mesh.rank, "size": mesh.size}, {}
    coos = {name: getattr(synth, gen)(*args, seed=seed)
            for name, (gen, args, seed) in matrices.items()}
    for name, kind, mode in cases:
        coo = coos[name]
        if (name, kind) not in plans:
            plans[name, kind] = builds[kind](coo, D)
            meta[f"bytes {name} {kind}"] = device_bytes(plans[name, kind],
                                                        mesh)
            meta[f"shards {name} {kind}"] = len(to_device(plans[name, kind],
                                                          mesh))
        x = np.random.default_rng(D).standard_normal(coo.num_cols)
        before = spmv_sharded_chunked.rotations
        y = runs[kind](plans[name, kind], x.astype(np.float32), mesh,
                       x_mode=mode)
        meta[f"sends {name} {kind} {mode}"] = (spmv_sharded_chunked.rotations
                                               - before)
        ys[f"{name} {kind} {mode}"] = y.numpy()
        meta[f"device {name} {kind} {mode}"] = str(y.device)
    coo = synth.blocked_coo(800, 900, 20_000, seed=1)
    x = np.zeros(coo.num_cols, np.float32)
    for label, call in (
            ("wrong D", lambda: spmv_sharded(build_sharded_block_plan(
                coo, D + 1), x, mesh)),
            ("wrong x", lambda: spmv_sharded(plans["blocked", "block"],
                                             x[:-1], mesh, x_mode="gather")),
            ("gloo on a card", lambda: ProcessMesh(
                dist.group.WORLD, rank, D, torch.device("cuda", 0)))):
        try:
            call()
            meta[label] = None
        except (ValueError, RuntimeError) as e:
            meta[label] = f"{type(e).__name__}: {e}"
    np.savez(out, meta=np.array(json.dumps(meta)), **ys)
    dist.destroy_process_group()
""")


def _env():
    env = dict(os.environ, PYTHONPATH=REPO)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        env.pop(var, None)
    return env


def _spawn(argv, log):
    """Start ``argv`` in a session of its own (torchrun's workers too),
    its output into ``log``."""
    with open(log, "w") as f:
        return subprocess.Popen(argv, cwd=REPO, env=_env(), stdout=f,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)


def _read(path):
    with open(path) as f:
        return f.read()


# a rank of two that joins alone: it must raise after its timeout
MISSING_PEER = textwrap.dedent("""
    import datetime, sys
    from hispmv_tpu_torch.dist import init_distributed
    try:
        init_distributed(sys.argv[1], 2, 0, backend="gloo",
                         timeout=datetime.timedelta(seconds=2))
    except RuntimeError as e:
        print("raised", e)
""")


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every process of this file, started at once: both groups (D = 2 and
    4), each rank running every case of its D, the dry run on four ranks
    under torchrun, and a rank whose peer never joins.  Returns {"ranks":
    {D: [(meta, ys) per rank]}, "torchrun": (rc, log), "missing peer":
    (rc, log)}."""
    tmp = tmp_path_factory.mktemp("ranks")
    procs, logs, outs = [], [], {}
    try:
        for D in (2, 4):
            cases = [c[1:] for c in CASES if c[0] == D]
            for r in range(D):
                outs[D, r] = str(tmp / f"rank{D}_{r}.npz")
                logs.append(str(tmp / f"rank{D}_{r}.log"))
                procs.append(_spawn(
                    [sys.executable, "-c", RANK, f"file://{tmp}/store{D}",
                     str(D), str(r), outs[D, r], json.dumps(MATRICES),
                     json.dumps(cases)], logs[-1]))
        logs += [str(tmp / "torchrun.log"), str(tmp / "missing.log")]
        procs.append(_spawn(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "4", "-m", "hispmv_tpu_torch.dist.dryrun",
             "--device", "cpu"], logs[-2]))
        procs.append(_spawn([sys.executable, "-c", MISSING_PEER,
                             f"file://{tmp}/store_missing"], logs[-1]))
        deadline = time.monotonic() + TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:  # stragglers and what they started
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    done = [(p.returncode, _read(log)) for p, log in zip(procs, logs)]
    for rc, text in done[:-2]:
        assert rc == 0, text[-4000:]
    res = {"ranks": {}, "torchrun": done[-2], "missing peer": done[-1]}
    for (D, r), path in outs.items():
        with np.load(path) as f:
            res["ranks"].setdefault(D, []).append(
                (json.loads(str(f["meta"])),
                 {k: f[k] for k in f.files if k != "meta"}))
    return res


@functools.lru_cache(maxsize=None)
def _coo(name, port=True):
    gen, args, seed = MATRICES[name]
    return getattr(synth if port else jsynth, gen)(*args, seed=seed)


@functools.lru_cache(maxsize=None)
def _plan(kind, name, D, port=True):
    return PLANS[kind][0 if port else 1](_coo(name, port), D)


def _x(coo, D):
    return np.random.default_rng(D).standard_normal(
        coo.num_cols).astype(np.float32)


def _rank_ys(spawned, D, name, kind, mode):
    return [(meta, ys[f"{name} {kind} {mode}"])
            for meta, ys in spawned["ranks"][D]]


@pytest.mark.parametrize("D,name,kind,mode", CASES)
def test_rank_y_equals_one_process_and_golden(spawned, D, name, kind,
                                               mode):
    coo = _coo(name)
    x = _x(coo, D)
    one = EXECUTORS[kind][0](_plan(kind, name, D), x,
                             make_mesh(devices=["cpu"] * D), x_mode=mode)
    golden = coo.to_scipy() @ x.astype(np.float64)
    got = _rank_ys(spawned, D, name, kind, mode)
    assert [meta["rank"] for meta, _ in got] == list(range(D))
    for meta, y in got:
        assert meta["size"] == D
        assert meta[f"device {name} {kind} {mode}"] == "cpu"
        assert y.dtype == np.float32 and y.shape == (coo.num_rows,)
        np.testing.assert_array_equal(y, one.numpy())
        np.testing.assert_allclose(y, golden, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("D,name,kind,mode", CASES)
def test_rank_y_matches_jax(spawned, D, name, kind, mode):
    if len(jax.devices()) < D:
        pytest.skip(f"needs {D} JAX devices")
    run, jplan, jmesh = (EXECUTORS[kind][1], _plan(kind, name, D, False),
                         jshard.make_mesh(D))
    # under jit: the eager call's values, in a third of the time
    jy = np.asarray(jax.jit(lambda x: run(jplan, x, jmesh, x_mode=mode,
                                          interpret=True))(
        _x(_coo(name, port=False), D)), np.float64)
    atol = 1e-5 * max(1.0, float(np.abs(jy).max(initial=0.0)))
    for _, y in _rank_ys(spawned, D, name, kind, mode):
        np.testing.assert_allclose(y, jy, rtol=1e-5, atol=atol)


def test_empty_shard_exists():
    plan = _plan("block", "empty_shards", 4)
    assert 0 in plan.blocks_per_dev or min(plan.nrb_per_dev) == 0


@pytest.mark.parametrize("D", [2, 4])
def test_ring_sends_d_minus_one_a_rank(spawned, D):
    for meta, _ in spawned["ranks"][D]:
        for (d, name, kind, mode) in CASES:
            if d == D and kind == "chunked":
                assert meta[f"sends {name} {kind} {mode}"] == (
                    D - 1 if mode == "ring" else 0), (name, mode)


@pytest.mark.parametrize("D", [2, 4])
def test_device_bytes_count_the_ranks_own_shard(spawned, D):
    for meta, _ in spawned["ranks"][D]:
        r = meta["rank"]
        for name, kind in {(c[1], c[2]) for c in CASES if c[0] == D}:
            own = sum(np.ascontiguousarray(a).nbytes for a in
                      _shard_arrays(_plan(kind, name, D), r).values())
            assert meta[f"shards {name} {kind}"] == 1
            assert meta[f"bytes {name} {kind}"] == own, (name, kind, r)


@pytest.mark.parametrize("D", [2, 4])
def test_rank_refuses_bad_inputs(spawned, D):
    """A plan of D + 1 shards and an x one entry short raise on every rank
    before any collective; a gloo group refuses a card."""
    for meta, _ in spawned["ranks"][D]:
        assert meta["wrong D"].startswith("ValueError") and \
            "shards" in meta["wrong D"]
        assert meta["wrong x"].startswith("ValueError") and \
            "columns" in meta["wrong x"]
        msg = meta["gloo on a card"]
        assert msg.startswith("RuntimeError") and "gloo" in msg and \
            "cuda:0" in msg


def test_make_process_mesh_without_a_group_raises():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_process_mesh("cpu")


def test_local_device():
    assert local_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            local_device()


def test_init_distributed_times_out_on_a_missing_peer(spawned):
    """Rank 0 of two joins alone: it raises after its timeout instead of
    waiting for a peer that never comes."""
    rc, text = spawned["missing peer"]
    assert rc == 0 and "raised" in text, text[-2000:]


def test_dryrun_module_under_torchrun(spawned):
    """``python -m hispmv_tpu_torch.dist.dryrun --device cpu`` on four gloo
    ranks under torchrun: each rank prints one JSON line, all ok, each
    with its 3 ring sends."""
    rc, text = spawned["torchrun"]
    assert rc == 0, text[-4000:]
    lines = [json.loads(ln) for ln in text.splitlines()
             if ln.startswith("{")]
    assert sorted(d["rank"] for d in lines) == [0, 1, 2, 3]
    for d in lines:
        assert d["ok"] and d["size"] == 4 and d["device"] == "cpu"
        assert d["ring_copies"] == 3
        for k in ("ring_balance", "window_balance", "block_balance"):
            assert d[k] < 1.3
