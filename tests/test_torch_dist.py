"""Multi-device sharding in the port (``hispmv_tpu_torch.dist``) against the
JAX package's ``hispmv_tpu.dist``:

- ``_split_boundaries`` and the three sharded plans are array-equal at
  D = 1, 2, 3, 4 and 8;
- each executor, in each ``x_mode``, on ``make_mesh(devices=["cpu"] * D)``
  matches JAX's on ``make_mesh(D)`` (the conftest's virtual CPU devices,
  Pallas in interpret mode) at rtol=1e-5, atol=1e-5*max(1, max|y|) (fp32
  on both sides, only the order of summation differs), and the float64
  golden at rtol=1e-3 (atol 1e-4, as the JAX package's own tests);
- the empty-shard case, the ring's copy count, ``make_mesh`` without cards,
  ``init_distributed`` and ``dryrun_multichip`` on four CPU positions."""

import functools
import os
import socket
import subprocess
import sys
import textwrap

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
    init_distributed,
    make_mesh,
    spmv_sharded,
    spmv_sharded_chunked,
    spmv_sharded_window,
    to_device,
)
from hispmv_tpu_torch.dist.dryrun import dryrun_multichip
from hispmv_tpu_torch.dist.shard import _split_boundaries, device_bytes
from hispmv_tpu_torch.formats import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (generator, args): the port's and the JAX package's generators
# give the same matrix
MATRICES = {
    "blocked": ("blocked_coo", (800, 900, 20_000), 1),
    "powerlaw": ("powerlaw_coo", (900, 1100, 25_000), 7),
    "empty_shards": ("random_coo", (16, 200, 100), 5),
}
PLANS = {
    "block": (build_sharded_block_plan, jshard.build_sharded_block_plan,
              ("data", "block_rows", "block_cols", "block_firsts",
               "block_lasts")),
    "window": (build_sharded_window_plan, jshard.build_sharded_window_plan,
               ("data", "subidx", "block_rows", "block_wins",
                "block_firsts", "block_lasts")),
    "chunked": (lambda c, d: build_sharded_chunked_plan(c, d, chunk=16),
                lambda c, d: jshard.build_sharded_chunked_plan(c, d,
                                                               chunk=16),
                ("data5", "meta5")),
}
SCALARS = ("shape", "nnz", "block_h", "num_devices", "nrb_per_dev",
           "nrb_max", "blocks_per_dev")


@functools.lru_cache(maxsize=None)
def _coo(name, port=True):
    gen, args, seed = MATRICES[name]
    return getattr(synth if port else jsynth, gen)(*args, seed=seed)


@functools.lru_cache(maxsize=None)
def _plans(kind, name, D):
    ours, theirs, _ = PLANS[kind]
    return ours(_coo(name), D), theirs(_coo(name, port=False), D)


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def assert_close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float64)
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def golden(coo, x):
    return coo.to_scipy() @ x.astype(np.float64)


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("counts", [
    [10, 1, 1, 1, 10, 1, 1, 10],
    [5],
    [0, 0, 3, 0, 9, 1],
    list(range(1, 40)),
])
def test_split_boundaries_equal(counts, parts):
    counts = np.asarray(counts, np.int64)
    np.testing.assert_array_equal(_split_boundaries(counts, parts),
                                  jshard._split_boundaries(counts, parts))


@pytest.mark.parametrize("D", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("kind", list(PLANS))
def test_sharded_plans_equal(kind, name, D):
    ours, theirs = _plans(kind, name, D)
    for f in SCALARS + (("num_windows",) if kind == "window" else
                        ("num_col_blocks",)):
        assert getattr(ours, f) == getattr(theirs, f), f
    if kind == "chunked":
        assert (ours.chunk, ours.ncb_per_shard) == (theirs.chunk,
                                                    theirs.ncb_per_shard)
    for f in PLANS[kind][2]:
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ours.balance == theirs.balance


EXECUTORS = {
    "block": (spmv_sharded, jshard.spmv_sharded),
    "window": (spmv_sharded_window, jshard.spmv_sharded_window),
    "chunked": (spmv_sharded_chunked, jshard.spmv_sharded_chunked),
}


@pytest.mark.parametrize("kind,x_mode", [
    ("block", "replicated"), ("block", "gather"),
    ("window", "replicated"), ("window", "gather"),
    ("chunked", "ring"), ("chunked", "replicated"),
])
@pytest.mark.parametrize("name,D", [("blocked", 4), ("powerlaw", 4),
                                    ("powerlaw", 3), ("empty_shards", 8)])
def test_executor_matches_jax(kind, x_mode, name, D):
    if len(jax.devices()) < D:
        pytest.skip(f"needs {D} JAX devices")
    coo = _coo(name)
    plan, jplan = _plans(kind, name, D)
    x = _x(coo.num_cols, seed=D)
    ours, theirs = EXECUTORS[kind]
    y = ours(plan, x, make_mesh(devices=["cpu"] * D), x_mode=x_mode)
    jy = theirs(jplan, x, jshard.make_mesh(D), x_mode=x_mode,
                interpret=True)
    assert y.device.type == "cpu" and y.dtype == torch.float32
    assert y.shape == (coo.num_rows,)
    assert_close(y.numpy(), np.asarray(jy))
    np.testing.assert_allclose(y.numpy(), golden(coo, x), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("D", [1, 2, 5])
@pytest.mark.parametrize("kind,x_mode", [
    ("block", "gather"), ("window", "gather"), ("chunked", "ring"),
])
def test_executor_matches_golden(kind, x_mode, D):
    coo = _coo("powerlaw")
    plan, _ = _plans(kind, "powerlaw", D)
    x = _x(coo.num_cols, seed=10 + D)
    y = EXECUTORS[kind][0](plan, x, make_mesh(devices=["cpu"] * D),
                           x_mode=x_mode)
    np.testing.assert_allclose(y.numpy(), golden(coo, x), rtol=1e-3,
                               atol=1e-4)


def test_empty_shards_exist():
    plan, _ = _plans("block", "empty_shards", 8)
    assert 0 in plan.blocks_per_dev or min(plan.nrb_per_dev) == 0


@pytest.mark.parametrize("D", [1, 2, 4])
def test_ring_rotation_count(D):
    coo = _coo("blocked")
    plan, _ = _plans("chunked", "blocked", D)
    mesh = make_mesh(devices=["cpu"] * D)
    x = _x(coo.num_cols)
    before = spmv_sharded_chunked.rotations
    spmv_sharded_chunked(plan, x, mesh, x_mode="ring")
    assert spmv_sharded_chunked.rotations - before == D * (D - 1)
    before = spmv_sharded_chunked.rotations
    spmv_sharded_chunked(plan, x, mesh, x_mode="replicated")
    assert spmv_sharded_chunked.rotations == before


def test_to_device_uploads_once():
    plan, _ = _plans("block", "blocked", 4)
    mesh = make_mesh(devices=["cpu"] * 4)
    shards = to_device(plan, mesh)
    assert to_device(plan, mesh) is shards
    assert len(shards) == 4
    assert all(t.device.type == "cpu" for sh in shards for t in sh.values())
    assert device_bytes(plan, mesh) >= plan.data.nbytes
    with pytest.raises(ValueError, match="shards"):
        to_device(plan, make_mesh(devices=["cpu"] * 2))


def test_executors_reject_bad_inputs():
    coo = _coo("blocked")
    plan, _ = _plans("block", "blocked", 2)
    mesh = make_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="columns"):
        spmv_sharded(plan, _x(coo.num_cols + 1), mesh)
    with pytest.raises(ValueError, match="x_mode"):
        spmv_sharded(plan, _x(coo.num_cols), mesh, x_mode="ring")
    cplan, _ = _plans("chunked", "blocked", 2)
    with pytest.raises(ValueError, match="x_mode"):
        spmv_sharded_chunked(cplan, _x(coo.num_cols), mesh, x_mode="gather")


def test_make_mesh_without_cards_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA cards"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA cards"):
        make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(devices=["cuda:0"] * 2)


def test_make_mesh_named_devices():
    mesh = make_mesh(devices=["cpu"] * 3)
    assert mesh.size == 3 and mesh.axis == "rows"
    assert all(d == torch.device("cpu") for d in mesh.devices)
    with pytest.raises(ValueError):
        make_mesh(devices=[])
    with pytest.raises(ValueError):
        make_mesh(2, devices=["cpu"] * 3)


def test_init_distributed_single_process_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False
    assert init_distributed() is False


def test_init_distributed_named_address_that_fails_raises(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises((ValueError, RuntimeError)):
        init_distributed("nosuchscheme://localhost:1", 1, 0)


def test_init_distributed_two_processes():
    """Two processes join one gloo group on a localhost port: both see a
    group of two, and a second call is a no-op returning the same."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = textwrap.dedent(f"""
        import sys
        from hispmv_tpu_torch.dist import init_distributed
        rank = int(sys.argv[1])
        ok = init_distributed("tcp://localhost:{port}", 2, rank)
        again = init_distributed()
        import torch.distributed as dist
        dist.destroy_process_group()
        print(ok, again)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "True True"


def test_dryrun_multichip_on_four_cpu_positions():
    stats = dryrun_multichip(["cpu"] * 4)
    assert stats["ring_copies"] == 12
    for k in ("ring_balance", "window_balance", "block_balance"):
        assert stats[k] < 1.3
