"""B5 and B6, the per-block block-ELL stream against one vector and against
B vectors: CUDA kernel wrappers, plain PyTorch versions and the one-shot
``spmv_block``.

Port of ``hispmv_tpu/ops/spmv_block.py`` (``_spmv_block_kernel`` /
``spmv_block_pallas``, ``_spmv_block_batched_kernel`` /
``spmv_block_batched_pallas``, ``spmv_block``).  Both kernels are in
``csrc/spmv_block.cu``; they take a plan's arrays as they are (``data``,
``block_rows``, ``block_cols``, ``block_firsts``, ``block_lasts``), so both
packages can be fed identical inputs.  The stream is read as the TPU grid
reads it: a run of blocks starts at a first flag, its sum is ASSIGNED to
``y[rows[j]]`` at the run's first last-flagged block ``j``, and blocks after
that flag and before the next first flag (the sharded plans' padding) are
never read.  Row-blocks that no run stores stay zero (the TPU leaves them
unwritten).
"""

from __future__ import annotations

import numpy as np
import torch

from hispmv_tpu_torch.ops import cuda_build
from hispmv_tpu_torch.ops.spmv_chunked import block_products, check_cuda_args
from hispmv_tpu_torch.plan.blocks import LANES, BlockPlan
from hispmv_tpu_torch.utils.device import resolve_device
from hispmv_tpu_torch.utils.trace import traced


def run_starts(firsts) -> torch.Tensor:
    """i32 indices of the first-flagged blocks, the run starts the kernels
    take.  From a numpy array on the host, or a tensor (on the card this
    waits for the device: upload the host's once per plan instead)."""
    if isinstance(firsts, np.ndarray):
        return torch.from_numpy(np.flatnonzero(firsts).astype(np.int32))
    return torch.nonzero(firsts).reshape(-1).to(torch.int32)


def _check_block_args(name, data, index_arrays, x):
    if data.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"{name}: data and x must be float32")
    if any(t.dtype != torch.int32 for t in index_arrays):
        raise TypeError(f"{name}: rows, cols, firsts and lasts must be int32")
    if data.ndim != 3 or data.shape[0] < 1 or data.shape[2] != LANES:
        raise ValueError(f"{name}: data shape {tuple(data.shape)} is not "
                         f"[nblocks, block_h, {LANES}]")
    nb = data.shape[0]
    if any(t.shape != (nb,) for t in index_arrays):
        raise ValueError(f"{name}: rows, cols, firsts and lasts must be "
                         f"[{nb}]")


def _read_runs(firsts, lasts):
    """(read, run): whether the TPU grid's carried accumulator reaches a
    flush from block j (j lies in a run, at or before the run's first last
    flag), and the run of each block (-1 before the first run)."""
    f, last = firsts.long(), lasts.long()
    run = torch.cumsum(f, 0) - 1
    if not f.any():
        return torch.zeros_like(f, dtype=torch.bool), run
    starts = torch.nonzero(f).reshape(-1)
    seen = torch.cumsum(last, 0) - last  # last flags before each block
    read = (run >= 0) & (seen == seen[starts][run.clamp_min(0)])
    return read, run


def _block_runs_plain(data, rows, cols, firsts, lasts, xb, num_row_blocks):
    """y [nrb, bh, B] of the stream against ``xb`` [ncb, 128, B]: per run,
    the sum of its read blocks' products (elementwise fp32, summed over the
    lanes, no TF32 path), stored at the row-block of its last flag."""
    bh, batch = data.shape[1], xb.shape[2]
    read, run = _read_runs(firsts, lasts)
    y = torch.zeros((num_row_blocks, bh, batch), dtype=torch.float32,
                    device=xb.device)
    idx = torch.nonzero(read).reshape(-1)
    if idx.numel() == 0:
        return y
    nruns = int(run.max()) + 1
    sums = torch.zeros((nruns, bh, batch), dtype=torch.float32,
                       device=xb.device)
    cols_read = cols.index_select(0, idx)
    block_products(data.index_select(0, idx),
                   lambda sl: xb.index_select(0, cols_read[sl]),
                   run.index_select(0, idx), sums)
    store = read & (lasts == 1)
    y[rows[store].long()] = sums[run[store]]
    return y


def spmv_block_stream_plain(data, rows, cols, firsts, lasts, x_blocks,
                            num_row_blocks):
    """Plain PyTorch version of B5 on the same arrays: ``x_blocks`` f32
    [ncb, 1, 128] -> y f32 [num_row_blocks, 1, block_h]."""
    bh = data.shape[1]
    y = _block_runs_plain(data, rows, cols, firsts, lasts,
                          x_blocks.reshape(-1, LANES, 1), num_row_blocks)
    return y.reshape(num_row_blocks, 1, bh)


@traced("kernel.B5")
def spmv_block_stream(data, rows, cols, firsts, lasts, x_blocks,
                      num_row_blocks, starts=None):
    """Run the per-block stream; returns y tiles f32 [num_row_blocks, 1,
    block_h] (the JAX layout).

    ``data`` f32 [nblocks, block_h, 128], ``rows`` / ``cols`` / ``firsts``
    / ``lasts`` i32 [nblocks] (a :class:`BlockPlan`'s or one shard of a
    sharded plan's), ``x_blocks`` f32 [ncb, 1, 128].  ``starts``: the run
    starts (:func:`run_starts`), found here when not given.  CPU tensors
    take the plain PyTorch version; CUDA tensors launch the CUDA kernel
    (csrc/spmv_block.cu) or raise."""
    name = "spmv_block_stream"
    _check_block_args(name, data, (rows, cols, firsts, lasts), x_blocks)
    if x_blocks.ndim != 3 or x_blocks.shape[1:] != (1, LANES):
        raise ValueError(f"{name}: x must be [n, 1, {LANES}], got "
                         f"{tuple(x_blocks.shape)}")
    if data.device.type == "cpu":
        return spmv_block_stream_plain(data, rows, cols, firsts, lasts,
                                       x_blocks, num_row_blocks)
    bh = data.shape[1]
    if starts is None:
        starts = run_starts(firsts)
    check_cuda_args(name, bh, data, rows, cols, firsts, lasts, starts,
                    x_blocks)
    lib = cuda_build.get_lib()
    y = torch.zeros((num_row_blocks, 1, bh), dtype=torch.float32,
                    device=data.device)
    with torch.cuda.device(data.device):
        rc = lib.hispmv_spmv_block(
            data.data_ptr(), rows.data_ptr(), cols.data_ptr(),
            firsts.data_ptr(), lasts.data_ptr(), starts.data_ptr(),
            x_blocks.data_ptr(), y.data_ptr(), data.shape[0], starts.numel(),
            bh, torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(rc, name)
    spmv_block_stream.launches += 1
    return y


spmv_block_stream.launches = 0  # kernel launches, for the smoke run's check


def spmv_block_batched_plain(data, rows, cols, firsts, lasts, x_blocks,
                             num_row_blocks):
    """Plain PyTorch version of B6: B5's with a batch axis, ``x_blocks``
    f32 [ncb, 128, B] -> y f32 [num_row_blocks, block_h, B]."""
    return _block_runs_plain(data, rows, cols, firsts, lasts, x_blocks,
                             num_row_blocks)


@traced("kernel.B6")
def spmv_block_batched(data, rows, cols, firsts, lasts, x_blocks,
                       num_row_blocks, starts=None):
    """Run the per-block stream against B vectors; returns y f32
    [num_row_blocks, block_h, B].  Arrays as for :func:`spmv_block_stream`,
    ``x_blocks`` f32 [ncb, 128, B] (the JAX layout).  The kernel runs one
    warp per (run, 8-row slice, 16-vector group), each block's product on
    the fp64 tensor cores, in one launch; its shape is
    ``block_batched_grid(nruns, block_h, B)``.  Repeated calls give the
    same bits.  CPU tensors take the plain PyTorch version; CUDA tensors
    launch the CUDA kernel (csrc/spmv_block.cu) or raise."""
    name = "spmv_block_batched"
    _check_block_args(name, data, (rows, cols, firsts, lasts), x_blocks)
    if x_blocks.ndim != 3 or x_blocks.shape[1] != LANES or \
            x_blocks.shape[2] < 1:
        raise ValueError(f"{name}: x must be [n, {LANES}, B], got "
                         f"{tuple(x_blocks.shape)}")
    if data.device.type == "cpu":
        return spmv_block_batched_plain(data, rows, cols, firsts, lasts,
                                        x_blocks, num_row_blocks)
    bh, batch = data.shape[1], x_blocks.shape[2]
    if starts is None:
        starts = run_starts(firsts)
    check_cuda_args(name, bh, data, rows, cols, firsts, lasts, starts,
                    x_blocks)
    lib = cuda_build.get_lib()
    y = torch.zeros((num_row_blocks, bh, batch), dtype=torch.float32,
                    device=data.device)
    with torch.cuda.device(data.device):
        rc = lib.hispmv_spmv_block_batched(
            data.data_ptr(), rows.data_ptr(), cols.data_ptr(),
            firsts.data_ptr(), lasts.data_ptr(), starts.data_ptr(),
            x_blocks.data_ptr(), y.data_ptr(), data.shape[0], starts.numel(),
            bh, batch, torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(rc, name)
    spmv_block_batched.launches += 1
    return y


spmv_block_batched.launches = 0  # kernel launches, for the smoke run's check


def block_batched_grid(nruns, block_h, batch):
    """B6's launch shape for ``nruns`` runs of height ``block_h`` at a
    batch of ``batch``: (warps a CTA, row slices, CTAs).  Needs the built
    library; raises for sizes its launcher refuses."""
    return cuda_build.launch_shape("hispmv_spmv_block_batched_grid", nruns,
                                   block_h, batch)


def upload_block_plan(plan: BlockPlan, device) -> dict:
    """The stream arrays of ``plan`` on ``device``, with its run starts."""
    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {"data": up(plan.data), "rows": up(plan.block_rows),
            "cols": up(plan.block_cols), "firsts": up(plan.block_firsts),
            "lasts": up(plan.block_lasts),
            "starts": run_starts(plan.block_firsts).to(device)}


def spmv_block(plan: BlockPlan, x, y_in=None, alpha=1.0, beta=0.0,
               device="cuda"):
    """``y = alpha * A @ x + beta * y_in`` from a host-side
    :class:`BlockPlan` through B5, as a float32 tensor on ``device``.

    Uploads the plan on every call: for tests and one-shot use
    (:class:`hispmv_tpu_torch.api.SpmvHandle` keeps a plan resident).  A
    column-reordered plan gathers x through ``col_perm``, identity-extended
    over the padded tail."""
    dev = resolve_device(device)
    ncb = plan.num_col_blocks
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    if x.shape[0] != plan.shape[1]:
        raise ValueError(f"x has {x.shape[0]} entries, matrix has "
                         f"{plan.shape[1]} columns")
    pad = ncb * LANES - x.shape[0]
    if pad > 0:
        x = torch.nn.functional.pad(x, (0, pad))
    if plan.col_perm is not None:
        perm = np.concatenate([
            np.asarray(plan.col_perm, np.int32),
            np.arange(plan.shape[1], ncb * LANES, dtype=np.int32),
        ])
        x = x.index_select(0, torch.from_numpy(perm).to(dev))
    d = upload_block_plan(plan, dev)
    y = spmv_block_stream(d["data"], d["rows"], d["cols"], d["firsts"],
                          d["lasts"], x.reshape(-1, 1, LANES),
                          plan.num_row_blocks, starts=d["starts"])
    y = alpha * y.reshape(-1)[: plan.shape[0]]
    if y_in is not None:
        y = y + beta * torch.as_tensor(y_in, dtype=torch.float32, device=dev)
    return y
