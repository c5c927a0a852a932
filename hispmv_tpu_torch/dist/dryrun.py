"""One distributed SpMV step on each sharded path, checked.

Port of ``__graft_entry__.py::dryrun_multichip``: the same three matrices,
sizes, tolerances and balance rule, on a mesh of the devices named (which
may repeat one card, or be ``["cpu"] * n``).  The JAX version counts the
collective-permutes in the lowered module; here the ring counts its x
copies, and the check asks for at least D - 1 rounds of D copies.
"""

from __future__ import annotations

import numpy as np

from hispmv_tpu_torch.dist.shard import (
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
    devices)``:

    1. the chunked stream with the x ring on a power-law matrix with ~25k
       nnz and 2k rows per device (chunk 16), its ring copies counted;
    2. the windowed stream (arrowhead matrix, x replicated);
    3. the per-block stream with x gathered (blocked matrix).

    Raises when a result leaves rtol 1e-3 / atol 1e-4 of the float64
    product, the ring made fewer than D - 1 rounds of copies, or a plan's
    balance is 1.3 or more.  Returns the balances, the ring's copies and
    the head of the ring's y."""
    mesh = make_mesh(devices=devices)
    n = mesh.size

    coo = powerlaw_coo(2048 * n, 1024 * n, 25_000 * n, seed=0)
    cp = build_sharded_chunked_plan(coo, num_devices=n, chunk=16)
    x = np.random.default_rng(0).standard_normal(coo.shape[1])
    x = x.astype(np.float32)
    before = spmv_sharded_chunked.rotations
    y = spmv_sharded_chunked(cp, x, mesh, x_mode="ring")
    copies = spmv_sharded_chunked.rotations - before
    _check(y, coo, x)
    if copies // n < n - 1:
        raise AssertionError(f"expected >= {n - 1} ring rounds of {n} "
                             f"copies, counted {copies} copies")

    coo3 = arrowhead_coo(512 * n, 4096, 12_000 * n, seed=2)
    wp = build_sharded_window_plan(coo3, num_devices=n)
    x3 = np.random.default_rng(2).standard_normal(4096).astype(np.float32)
    _check(spmv_sharded_window(wp, x3, mesh), coo3, x3)

    coo2 = blocked_coo(64 * n, 300, 2_000 * n, seed=0)
    bp = build_sharded_block_plan(coo2, num_devices=n)
    x2 = np.random.default_rng(1).standard_normal(300).astype(np.float32)
    _check(spmv_sharded(bp, x2, mesh, x_mode="gather"), coo2, x2)

    for label, bal in (("ring", cp.balance), ("window", wp.balance),
                       ("block", bp.balance)):
        if bal >= MAX_BALANCE:
            raise AssertionError(
                f"{label} shard balance {bal:.2f} >= {MAX_BALANCE}: the "
                "nnz-balanced partitioner regressed")
    head = y[:3].cpu().numpy()
    print(f"dryrun_multichip({[str(d) for d in mesh.devices]}): OK, ring "
          f"balance={cp.balance:.2f}, window balance={wp.balance:.2f}, "
          f"block balance={bp.balance:.2f}, ring copies={copies}, "
          f"y[:3]={head}")
    return {"ring_balance": cp.balance, "window_balance": wp.balance,
            "block_balance": bp.balance, "ring_copies": copies,
            "y_head": head.tolist()}
