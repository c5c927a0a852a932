"""B7 and B8, the windowed block-ELL SpMV stream against one vector and
against B vectors: packer, CUDA kernel wrappers and plain PyTorch versions.

Port of ``hispmv_tpu/ops/spmv_windowed.py`` (``chunk_for_windowed``,
``pack_window_chunks``, ``_windowed_kernel`` / ``spmv_windowed_pallas``,
``_windowed_batched_kernel`` / ``spmv_windowed_batched_pallas``,
``pack_batch_x``).  The kernels are ``csrc/spmv_windowed.cu`` (B7) and
``csrc/spmv_windowed_batched.cu`` (B8); they consume the same packed arrays
as the TPU kernels.  Lane l of block j reads ``x2d[win*8 + subidx[j, l],
l]`` (plan/windows.py), per vector for B8.
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
)
from hispmv_tpu_torch.plan.windows import LANES, SEGS, WindowPlan


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


def spmv_windowed(data3d, subidx3d, meta, x2d, num_row_blocks, block_h,
                  chunk):
    """Run the windowed stream; returns y tiles f32 [num_row_blocks,
    block_h].  ``x2d`` f32 [nwin*8, 128].  CPU tensors take the plain
    PyTorch version; CUDA tensors launch the CUDA kernel
    (csrc/spmv_windowed.cu) or raise."""
    check_stream_args("spmv_windowed", data3d, meta, x2d, block_h, chunk)
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
            y.data_ptr(), data3d.shape[0], chunk, block_h,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(rc, "spmv_windowed")
    spmv_windowed.launches += 1
    return y


spmv_windowed.launches = 0  # kernel launches, for the smoke run's check


def pack_batch_x(xb, num_windows: int):
    """[B, Cp] -> the [nwin*8, B*128] layout of B8: value (s, b*128 + j) is
    x_b[s*128 + j] (the JAX package's ``pack_batch_x``)."""
    B = xb.shape[0]
    S = num_windows * SEGS
    return xb.reshape(B, S, LANES).transpose(0, 1).reshape(
        S, B * LANES).contiguous()


def spmv_windowed_batched_plain(data3d, subidx3d, meta, x_packed,
                                num_row_blocks, block_h, chunk):
    """Plain PyTorch version of B8 on the same arrays: B7's gather per
    batch column from ``x_packed`` f32 [nwin*8, B*128], then the products
    of B2's plain version -> y f32 [num_row_blocks, block_h, B]."""
    nb = data3d.shape[0] * chunk
    a = data3d.reshape(nb, block_h, LANES).float()
    rb = meta[:, 0, :].reshape(-1) >> 1
    win = meta[:, 1, :].reshape(-1)
    batch = x_packed.shape[1] // LANES
    x3 = x_packed.reshape(-1, batch, LANES).permute(0, 2, 1)  # [S, 128, B]
    rows = (win[:, None] * SEGS + subidx3d.reshape(nb, LANES)).long()
    lanes = torch.arange(LANES, device=x_packed.device)
    y = torch.zeros((num_row_blocks, block_h, batch), dtype=torch.float32,
                    device=x_packed.device)
    return block_products(a, lambda sl: x3[rows[sl], lanes], rb, y)


def spmv_windowed_batched(data3d, subidx3d, meta, x_packed, num_row_blocks,
                          block_h, chunk):
    """Run the windowed stream against B vectors; returns y f32
    [num_row_blocks, block_h, B].  ``x_packed`` f32 [nwin*8, B*128] from
    :func:`pack_batch_x`.  The kernel covers the batch in panels of at most
    64 vectors (the TPU kernel's verified gather width) in one launch.  CPU
    tensors take the plain PyTorch version; CUDA tensors launch the CUDA
    kernel (csrc/spmv_windowed_batched.cu) or raise."""
    name = "spmv_windowed_batched"
    check_payload(name, data3d, meta, x_packed, block_h, chunk)
    _check_subidx(subidx3d, meta, chunk, name)
    if (x_packed.ndim != 2 or x_packed.shape[1] < LANES
            or x_packed.shape[1] % LANES):
        raise ValueError(f"{name}: x must be [n, B*{LANES}], got "
                         f"{tuple(x_packed.shape)}")
    if data3d.device.type == "cpu":
        return spmv_windowed_batched_plain(
            data3d, subidx3d, meta, x_packed, num_row_blocks, block_h, chunk
        )
    check_cuda_args(name, block_h, data3d, subidx3d, meta, x_packed)
    lib = cuda_build.get_lib()
    batch = x_packed.shape[1] // LANES
    y = torch.zeros((num_row_blocks, block_h, batch), dtype=torch.float32,
                    device=x_packed.device)
    with torch.cuda.device(x_packed.device):
        rc = lib.hispmv_spmv_windowed_batched(
            data3d.data_ptr(), int(data3d.dtype == torch.bfloat16),
            subidx3d.data_ptr(), meta.data_ptr(), x_packed.data_ptr(),
            y.data_ptr(), data3d.shape[0], chunk, block_h, batch,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(rc, name)
    spmv_windowed_batched.launches += 1
    return y


spmv_windowed_batched.launches = 0  # kernel launches, for the smoke check
