"""One distributed SpMV step on each sharded path, checked.

Port of ``__graft_entry__.py::dryrun_multichip``: the same three matrices,
sizes, tolerances and balance rule, on a mesh of the devices named (which
may repeat one card, or be ``["cpu"] * n``) or on a ``ProcessMesh`` of
ranks.  The JAX version counts the collective-permutes in the lowered
module; here the ring counts its exchanges: at least D - 1 rounds of D
copies in one process, D - 1 sends on each rank.

Under a launcher, one rank a card (or a CPU rank with ``--device cpu``)::

    torchrun --nproc-per-node 4 -m hispmv_tpu_torch.dist.dryrun --device cpu
    torchrun --nproc-per-node 8 -m hispmv_tpu_torch.dist.dryrun

joins the group from torchrun's variables, runs :func:`dryrun_multichip`
on the process mesh, prints one JSON line a rank and exits non-zero when a
check fails on any rank.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from hispmv_tpu_torch.dist.shard import (
    ProcessMesh,
    build_sharded_block_plan,
    build_sharded_chunked_plan,
    build_sharded_window_plan,
    make_mesh,
    spmv_sharded,
    spmv_sharded_chunked,
    spmv_sharded_window,
)
from hispmv_tpu_torch.formats.synth import (
    arrowhead_coo,
    blocked_coo,
    powerlaw_coo,
)

RTOL, ATOL = 1e-3, 1e-4
MAX_BALANCE = 1.3  # max/mean device load of the nnz-balanced planners


def _check(y, coo, x):
    want = coo.to_scipy() @ x.astype(np.float64)
    np.testing.assert_allclose(y.cpu().numpy(), want.astype(np.float32),
                               rtol=RTOL, atol=ATOL)


def dryrun_multichip(devices) -> dict:
    """Run the three sharded executors once on ``make_mesh(devices=
    devices)``, or on ``devices`` itself when it is a ``ProcessMesh``:

    1. the chunked stream with the x ring on a power-law matrix with ~25k
       nnz and 2k rows per device (chunk 16), its ring exchanges counted;
    2. the windowed stream (arrowhead matrix, x replicated);
    3. the per-block stream with x gathered (blocked matrix).

    The three run before any check, so that a rank whose check fails has
    joined every collective of its peers.  Raises when a result leaves
    rtol 1e-3 / atol 1e-4 of the float64 product, the ring made fewer than
    D - 1 rounds of D copies (one process) or D - 1 sends (a rank), or a
    plan's balance is 1.3 or more.  Returns the balances, the ring's
    exchanges and the head of the ring's y."""
    process = isinstance(devices, ProcessMesh)
    mesh = devices if process else make_mesh(devices=devices)
    n = mesh.size

    coo = powerlaw_coo(2048 * n, 1024 * n, 25_000 * n, seed=0)
    cp = build_sharded_chunked_plan(coo, num_devices=n, chunk=16)
    x = np.random.default_rng(0).standard_normal(coo.shape[1])
    x = x.astype(np.float32)
    before = spmv_sharded_chunked.rotations
    y = spmv_sharded_chunked(cp, x, mesh, x_mode="ring")
    copies = spmv_sharded_chunked.rotations - before

    coo3 = arrowhead_coo(512 * n, 4096, 12_000 * n, seed=2)
    wp = build_sharded_window_plan(coo3, num_devices=n)
    x3 = np.random.default_rng(2).standard_normal(4096).astype(np.float32)
    y3 = spmv_sharded_window(wp, x3, mesh)

    coo2 = blocked_coo(64 * n, 300, 2_000 * n, seed=0)
    bp = build_sharded_block_plan(coo2, num_devices=n)
    x2 = np.random.default_rng(1).standard_normal(300).astype(np.float32)
    y2 = spmv_sharded(bp, x2, mesh, x_mode="gather")

    _check(y, coo, x)
    _check(y3, coo3, x3)
    _check(y2, coo2, x2)
    rounds = copies if process else copies // n
    if rounds < n - 1:
        raise AssertionError(f"expected >= {n - 1} ring rounds, counted "
                             f"{copies} {'sends' if process else 'copies'}")
    for label, bal in (("ring", cp.balance), ("window", wp.balance),
                       ("block", bp.balance)):
        if bal >= MAX_BALANCE:
            raise AssertionError(
                f"{label} shard balance {bal:.2f} >= {MAX_BALANCE}: the "
                "nnz-balanced partitioner regressed")
    head = y[:3].cpu().numpy()
    where = (f"rank {mesh.rank} of {n} on {mesh.device}" if process
             else str([str(d) for d in mesh.devices]))
    print(f"dryrun_multichip({where}): OK, ring balance={cp.balance:.2f}, "
          f"window balance={wp.balance:.2f}, block balance={bp.balance:.2f},"
          f" ring {'sends' if process else 'copies'}={copies}, "
          f"y[:3]={head}")
    return {"ring_balance": cp.balance, "window_balance": wp.balance,
            "block_balance": bp.balance, "ring_copies": copies,
            "y_head": head.tolist()}


def main(argv=None) -> int:
    """Join the group from torchrun's variables, run the dry run on the
    process mesh and print one JSON line: ``{"rank", "size", "device",
    "ok", ...}`` with the dry run's figures, or its ``error``."""
    import torch.distributed as dist

    from hispmv_tpu_torch.dist.init import init_distributed
    from hispmv_tpu_torch.dist.shard import make_process_mesh

    ap = argparse.ArgumentParser(
        prog="python -m hispmv_tpu_torch.dist.dryrun",
        description="the sharded executors' dry run on a process mesh; "
                    "run under torchrun")
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo ranks on the CPU; default "
                         "cuda:$LOCAL_RANK over NCCL")
    args = ap.parse_args(argv)
    cpu = args.device is not None and args.device.startswith("cpu")
    init_distributed(backend="gloo" if cpu else "nccl")
    mesh = make_process_mesh(args.device)
    out = {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device)}
    try:
        out.update(ok=True, **dryrun_multichip(mesh))
    except AssertionError as e:
        out.update(ok=False, error=str(e))
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
