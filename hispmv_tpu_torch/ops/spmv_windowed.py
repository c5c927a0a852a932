"""B7 and B8, the windowed block-ELL SpMV stream against one vector and
against B vectors: packer, CUDA kernel wrappers and plain PyTorch versions.

Port of ``hispmv_tpu/ops/spmv_windowed.py`` (``chunk_for_windowed``,
``pack_window_chunks``, ``_windowed_kernel`` / ``spmv_windowed_pallas``,
``_windowed_batched_kernel`` / ``spmv_windowed_batched_pallas``).  The
kernels are ``csrc/spmv_windowed.cu`` (B7) and
``csrc/spmv_windowed_batched.cu`` (B8); they consume the same packed block
arrays as the TPU kernels.  Lane l of block j reads ``x2d[win*8 +
subidx[j, l], l]`` (plan/windows.py); B8 reads it per vector from x
vector-minor, ``xt[win*8 + subidx[j, l], l, b]``, where the TPU kernel
takes x packed [nwin*8, B*128] (the JAX package's ``pack_batch_x``).
"""

from __future__ import annotations

import numpy as np
import torch

from hispmv_tpu_torch.ops import cuda_build
from hispmv_tpu_torch.ops.spmv_chunked import (
    block_products,
    check_cuda_args,
    check_payload,
    check_stream_args,
    check_vpt,
)
from hispmv_tpu_torch.plan.windows import LANES, SEGS, WindowPlan
from hispmv_tpu_torch.utils.trace import traced


def chunk_for_windowed(block_h: int, target_bytes: int = 1 << 20) -> int:
    bytes_per_block = (block_h * LANES + LANES) * 4  # payload + subidx
    c = max(target_bytes // bytes_per_block, 16)
    return int(min(512, (c // 8) * 8))


def pack_window_chunks(plan: WindowPlan, chunk: int):
    """Pad the stream to whole chunks; returns (data3d, subidx3d, meta,
    nchunks) with meta[:,0]=row_block*2+last, meta[:,1]=window.  data3d is
    f32; a bfloat16 payload is made from it on upload."""
    nb = plan.num_blocks
    nchunks = max(-(-nb // chunk), 1)
    nb_pad = nchunks * chunk
    bh = plan.block_h

    data = np.zeros((nb_pad, bh, LANES), np.float32)
    data[:nb] = plan.data
    subidx = np.zeros((nb_pad, LANES), np.int32)
    subidx[:nb] = plan.subidx
    meta = np.zeros((2, nb_pad), np.int32)
    meta[0, :nb] = plan.block_rows * 2 + plan.block_lasts
    meta[1, :nb] = plan.block_wins
    if nb_pad > nb:
        meta[0, nb:] = (plan.block_rows[-1] if nb else 0) * 2

    data3d = data.reshape(nchunks, chunk * bh, LANES)
    subidx3d = subidx.reshape(nchunks, chunk, LANES)
    meta = np.ascontiguousarray(
        meta.reshape(2, nchunks, chunk).transpose(1, 0, 2)
    )
    return data3d, subidx3d, meta, nchunks


def _check_subidx(subidx3d, meta, chunk, name="spmv_windowed"):
    if subidx3d.dtype != torch.int32:
        raise TypeError(f"{name}: subidx must be int32")
    if subidx3d.shape != (meta.shape[0], chunk, LANES):
        raise ValueError(f"{name}: subidx shape "
                         f"{tuple(subidx3d.shape)} is not "
                         f"[{meta.shape[0]}, {chunk}, {LANES}]")


def spmv_windowed_plain(data3d, subidx3d, meta, x2d, num_row_blocks,
                        block_h, chunk):
    """Plain PyTorch version of B7 on the same arrays (each block's row sums
    go to its own row-block, as for B1's plain version)."""
    nb = data3d.shape[0] * chunk
    a = data3d.reshape(nb, block_h, LANES).float()
    rb = meta[:, 0, :].reshape(-1) >> 1
    win = meta[:, 1, :].reshape(-1)
    lanes = torch.arange(LANES, device=x2d.device, dtype=torch.int32)
    flat = (win[:, None] * SEGS + subidx3d.reshape(nb, LANES)) * LANES + lanes
    xg = x2d.reshape(-1).index_select(0, flat.reshape(-1)).reshape(nb, LANES)
    contrib = (a * xg[:, None, :]).sum(-1)
    y = torch.zeros(
        (num_row_blocks, block_h), dtype=torch.float32, device=x2d.device
    )
    return y.index_add_(0, rb, contrib)


@traced("kernel.B7")
def spmv_windowed(data3d, subidx3d, meta, x2d, num_row_blocks, block_h,
                  chunk, vpt=0):
    """Run the windowed stream; returns y tiles f32 [num_row_blocks,
    block_h].  ``x2d`` f32 [nwin*8, 128].  The kernel is B8's at one vector
    (x2d is B8's xt [nwin*8, 128, 1]), V picked by the launcher unless
    ``vpt`` (1, 4 or 8) names it; its shape is ``windowed_batched_grid(1,
    nchunks, chunk, block_h, vpt)``.  CPU tensors take the plain PyTorch
    version; CUDA tensors launch the CUDA kernel (csrc/spmv_windowed.cu) or
    raise."""
    check_stream_args("spmv_windowed", data3d, meta, x2d, block_h, chunk)
    check_vpt("spmv_windowed", vpt)
    _check_subidx(subidx3d, meta, chunk)
    if data3d.device.type == "cpu":
        return spmv_windowed_plain(
            data3d, subidx3d, meta, x2d, num_row_blocks, block_h, chunk
        )
    check_cuda_args("spmv_windowed", block_h, data3d, subidx3d, meta, x2d)
    lib = cuda_build.get_lib()
    y = torch.zeros(
        (num_row_blocks, block_h), dtype=torch.float32, device=x2d.device
    )
    with torch.cuda.device(x2d.device):
        rc = lib.hispmv_spmv_windowed(
            data3d.data_ptr(), int(data3d.dtype == torch.bfloat16),
            subidx3d.data_ptr(), meta.data_ptr(), x2d.data_ptr(),
            y.data_ptr(), data3d.shape[0], chunk, block_h, vpt,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(rc, "spmv_windowed")
    spmv_windowed.launches += 1
    return y


spmv_windowed.launches = 0  # kernel launches, for the smoke run's check


def spmv_windowed_batched_plain(data3d, subidx3d, meta, xt, num_row_blocks,
                                block_h, chunk):
    """Plain PyTorch version of B8 on the same arrays: B7's gather per
    vector from ``xt`` f32 [nwin*8, 128, B], then the products of B2's
    plain version -> y f32 [num_row_blocks, block_h, B]."""
    nb = data3d.shape[0] * chunk
    a = data3d.reshape(nb, block_h, LANES).float()
    rb = meta[:, 0, :].reshape(-1) >> 1
    win = meta[:, 1, :].reshape(-1)
    rows = (win[:, None] * SEGS + subidx3d.reshape(nb, LANES)).long()
    lanes = torch.arange(LANES, device=xt.device)
    y = torch.zeros((num_row_blocks, block_h, xt.shape[2]),
                    dtype=torch.float32, device=xt.device)
    return block_products(a, lambda sl: xt[rows[sl], lanes], rb, y)


@traced("kernel.B8")
def spmv_windowed_batched(data3d, subidx3d, meta, xt, num_row_blocks,
                          block_h, chunk, vpt=0):
    """Run the windowed stream against B vectors; returns y f32
    [num_row_blocks, block_h, B].

    ``data3d``, ``subidx3d`` and ``meta`` as for :func:`spmv_windowed`,
    ``xt`` f32 [nwin*8, 128, B], x vector-minor (vector b's x[s*128 + l] at
    ``xt[s, l, b]``).  One launch covers the whole batch: B2's grid of
    ranges of blocks x row slices x groups of V vectors, V picked by the
    launcher unless ``vpt`` (1, 4 or 8) names it.  CPU tensors take the plain
    PyTorch version; CUDA tensors launch the CUDA kernel
    (csrc/spmv_windowed_batched.cu) or raise."""
    name = "spmv_windowed_batched"
    check_payload(name, data3d, meta, xt, block_h, chunk)
    _check_subidx(subidx3d, meta, chunk, name)
    if (xt.ndim != 3 or xt.shape[0] % SEGS or xt.shape[1] != LANES
            or xt.shape[2] < 1):
        raise ValueError(f"{name}: x must be [nwin*{SEGS}, {LANES}, B], got "
                         f"{tuple(xt.shape)}")
    check_vpt(name, vpt)
    if data3d.device.type == "cpu":
        return spmv_windowed_batched_plain(
            data3d, subidx3d, meta, xt, num_row_blocks, block_h, chunk
        )
    check_cuda_args(name, block_h, data3d, subidx3d, meta, xt)
    lib = cuda_build.get_lib()
    batch = xt.shape[2]
    y = torch.zeros((num_row_blocks, block_h, batch), dtype=torch.float32,
                    device=xt.device)
    with torch.cuda.device(xt.device):
        rc = lib.hispmv_spmv_windowed_batched(
            data3d.data_ptr(), int(data3d.dtype == torch.bfloat16),
            subidx3d.data_ptr(), meta.data_ptr(), xt.data_ptr(),
            y.data_ptr(), data3d.shape[0], chunk, block_h, batch, vpt,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(rc, name)
    spmv_windowed_batched.launches += 1
    return y


spmv_windowed_batched.launches = 0  # kernel launches, for the smoke check


def windowed_batched_grid(batch, nchunks, chunk, block_h, vpt=0):
    """B8's launch shape for a batch of ``batch`` on ``nchunks`` chunks of
    ``chunk`` blocks of height ``block_h``: (V, row slices, CTAs), as
    :func:`~hispmv_tpu_torch.ops.spmv_chunked.chunked_batched_grid` gives
    B2's.  Needs the built library and a card (the CTA count follows the
    kernel's occupancy)."""
    return cuda_build.launch_shape("hispmv_spmv_windowed_batched_grid",
                                   nchunks, chunk, block_h, batch, vpt)
