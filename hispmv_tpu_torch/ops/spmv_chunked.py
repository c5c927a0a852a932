"""B1, B2, B3 and B4, the chunked block-ELL SpMV stream against one
vector, against B vectors, against x in column panels and against x and y
in panels: packers, CUDA kernel wrappers and plain PyTorch versions.

Port of ``hispmv_tpu/ops/spmv_chunked.py`` (``chunk_for``, ``pack_chunks``,
``_chunked_kernel`` / ``spmv_chunked_pallas``, ``_chunked_batched_kernel``
/ ``spmv_chunked_batched_pallas``, ``pack_chunks_paneled``,
``_chunked_paneled_kernel`` / ``spmv_chunked_paneled_pallas``,
``pack_chunks_tiled``, ``_chunked_tiled_kernel`` /
``spmv_chunked_tiled_pallas``).  The kernels are ``csrc/spmv_chunked.cu``
(B1), ``csrc/spmv_chunked_batched.cu`` (B2),
``csrc/spmv_chunked_paneled.cu`` (B3) and ``csrc/spmv_chunked_tiled.cu``
(B4); they consume the same packed arrays as the TPU kernels, so both
packages can be fed identical inputs.  B4 also takes a sector mask derived
from its payload at upload (:func:`tiled_sector_mask`).
"""

from __future__ import annotations

import numpy as np
import torch

from hispmv_tpu_torch.ops import cuda_build
from hispmv_tpu_torch.plan.blocks import LANES, BlockPlan
from hispmv_tpu_torch.utils.trace import traced

# Block heights the CUDA kernels are instantiated for (csrc/block_stream.cuh,
# csrc/block_vec.cuh).
SUPPORTED_BLOCK_H = (1, 2, 4, 8, 16, 32, 64)

# ``vpt`` of B1, B2, B7 and B8: 0 lets the launcher pick V (csrc/
# block_vec.cuh::pick_v), 1, 4 or 8 names the vectors a thread.
VPT_CHOICES = (0, 1, 4, 8)

_VALUE_DTYPES = (torch.float32, torch.bfloat16)

# Lanes a bit of B4's sector mask covers: 32 bytes of an f32 payload row.
SECTOR_LANES = 8


def chunk_for(block_h: int, target_bytes: int = 1 << 20) -> int:
    """Blocks per chunk targeting ~1 MiB chunk payloads; a multiple of 8
    (same sizing as the JAX package, so packed arrays are identical)."""
    c = max(target_bytes // (block_h * LANES * 4), 16)
    return int(min(512, (c // 8) * 8))


def pack_chunks(plan: BlockPlan, chunk: int):
    """Pad the plan's block stream to a whole number of chunks and build the
    int32 metadata sideband.

    Returns (data3d, meta, nchunks):
      data3d f32 [nchunks, chunk*block_h, LANES]; a bfloat16 payload is made
      from it on upload with ``.to(torch.bfloat16)`` (numpy has no bf16)
      meta   i32 [nchunks, 2, chunk] with meta[:,0] = row_block*2 + last and
      meta[:,1] = col_block.
    Padding blocks: zero payload, last=0, row = last real row (they add only
    zeros and never flush)."""
    nb = plan.num_blocks
    nchunks = max(-(-nb // chunk), 1)
    nb_pad = nchunks * chunk
    bh = plan.block_h

    data = np.zeros((nb_pad, bh, LANES), np.float32)
    data[:nb] = plan.data
    meta = np.zeros((2, nb_pad), np.int32)
    meta[0, :nb] = plan.block_rows * 2 + plan.block_lasts
    meta[1, :nb] = plan.block_cols
    if nb_pad > nb:
        meta[0, nb:] = (plan.block_rows[-1] if nb else 0) * 2

    data3d = data.reshape(nchunks, chunk * bh, LANES)
    meta = np.ascontiguousarray(
        meta.reshape(2, nchunks, chunk).transpose(1, 0, 2)
    )
    return data3d, meta, nchunks


def check_stream_args(name, data3d, meta, x2d, block_h, chunk):
    """Validate the arrays shared by B1, B3, B4 and B7 before any launch."""
    check_payload(name, data3d, meta, x2d, block_h, chunk)
    if x2d.ndim != 2 or x2d.shape[1] != LANES:
        raise ValueError(f"{name}: x must be [n, {LANES}], got "
                         f"{tuple(x2d.shape)}")


def check_vpt(name, vpt):
    """``vpt`` of the kernels on csrc/block_vec.cuh: one of VPT_CHOICES."""
    if vpt not in VPT_CHOICES:
        raise ValueError(f"{name}: vpt={vpt}, want one of {VPT_CHOICES}")


def check_payload(name, data3d, meta, x, block_h, chunk):
    """Validate the packed stream of B1, B2, B7 and B8 and the type of x."""
    if data3d.dtype not in _VALUE_DTYPES:
        raise TypeError(f"{name}: data must be float32 or bfloat16, got "
                        f"{data3d.dtype}")
    if meta.dtype != torch.int32 or x.dtype != torch.float32:
        raise TypeError(f"{name}: meta must be int32 and x float32")
    nch = data3d.shape[0]
    if data3d.shape != (nch, chunk * block_h, LANES):
        raise ValueError(f"{name}: data shape {tuple(data3d.shape)} is not "
                         f"[nchunks, {chunk}*{block_h}, {LANES}]")
    if meta.shape != (nch, 2, chunk):
        raise ValueError(f"{name}: meta shape {tuple(meta.shape)} is not "
                         f"[{nch}, 2, {chunk}]")


def check_cuda_tensors(name, *tensors):
    """On the card: every tensor on one CUDA device and contiguous."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def check_aligned(name, *tensors):
    """Raise unless every tensor starts on a 16-byte boundary: the kernels
    that read it by 16-byte vectors have no scalar path."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors read by 16-byte loads must be "
                             "16-byte aligned")


def check_cuda_args(name, block_h, *tensors):
    """On the card: :func:`check_cuda_tensors`, and a block height the
    kernel is instantiated for."""
    check_cuda_tensors(name, *tensors)
    if block_h not in SUPPORTED_BLOCK_H:
        raise ValueError(f"{name}: block_h={block_h} is not supported by the "
                         f"CUDA kernel (one of {SUPPORTED_BLOCK_H})")


def spmv_chunked_plain(data3d, meta, x2d, num_row_blocks, block_h, chunk):
    """Plain PyTorch version of B1 on the same arrays.

    Each block's row sums go to its own row-block, which is what B1's
    carried accumulator computes for any stream the planner emits (blocks
    sorted by row-block, each row-block ending with a last-flagged block).
    Multiply and sum are elementwise fp32 (no TF32 path)."""
    nb = data3d.shape[0] * chunk
    a = data3d.reshape(nb, block_h, LANES).float()
    rb = meta[:, 0, :].reshape(-1) >> 1
    cb = meta[:, 1, :].reshape(-1)
    contrib = (a * x2d.index_select(0, cb)[:, None, :]).sum(-1)
    y = torch.zeros(
        (num_row_blocks, block_h), dtype=torch.float32, device=x2d.device
    )
    return y.index_add_(0, rb, contrib)


@traced("kernel.B1")
def spmv_chunked(data3d, meta, x2d, num_row_blocks, block_h, chunk, vpt=0):
    """Run the chunked stream; returns y tiles f32 [num_row_blocks, block_h].

    ``data3d`` f32/bf16 [nchunks, chunk*block_h, 128], ``meta`` i32
    [nchunks, 2, chunk] (from :func:`pack_chunks`), ``x2d`` f32 [ncb, 128].
    The kernel is B2's at one vector (x2d is B2's xb [ncb, 128, 1]): a grid
    of block ranges x row slices that fills one wave, V picked by the
    launcher unless ``vpt`` (1, 4 or 8) names it; its shape is
    ``chunked_batched_grid(1, nchunks, chunk, block_h, vpt)``.  CPU tensors
    take the plain PyTorch version; CUDA tensors launch the CUDA kernel
    (csrc/spmv_chunked.cu) or raise."""
    check_stream_args("spmv_chunked", data3d, meta, x2d, block_h, chunk)
    check_vpt("spmv_chunked", vpt)
    if data3d.device.type == "cpu":
        return spmv_chunked_plain(
            data3d, meta, x2d, num_row_blocks, block_h, chunk
        )
    check_cuda_args("spmv_chunked", block_h, data3d, meta, x2d)
    lib = cuda_build.get_lib()
    y = torch.zeros(
        (num_row_blocks, block_h), dtype=torch.float32, device=x2d.device
    )
    with torch.cuda.device(x2d.device):
        rc = lib.hispmv_spmv_chunked(
            data3d.data_ptr(), int(data3d.dtype == torch.bfloat16),
            meta.data_ptr(), x2d.data_ptr(), y.data_ptr(),
            data3d.shape[0], chunk, block_h, vpt,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(rc, "spmv_chunked")
    spmv_chunked.launches += 1
    return y


spmv_chunked.launches = 0  # kernel launches, for the smoke run's check


# Bytes of the [blocks, bh, 128, B] products the plain batched versions form
# at a time (the same sums in groups of blocks, so large batches fit).
PLAIN_GROUP_BYTES = 256 << 20


def block_products(a, gather_x, rb, y):
    """``y[rb[j]] += sum_l a[j, :, l, None] * xg[j, l, :]`` over blocks j,
    in groups: ``a`` f32 [nb, bh, 128], ``gather_x(sl)`` gives the x rows
    ``xg`` f32 [len, 128, B] of the blocks in slice ``sl``, ``y`` f32
    [nrb, bh, B].  Elementwise fp32 products summed over the lanes (no
    TF32 path): the plain form of B2 and B8."""
    nb, bh, _ = a.shape
    per_block = bh * LANES * y.shape[2] * 4
    g = max(1, PLAIN_GROUP_BYTES // per_block)
    for j0 in range(0, nb, g):
        sl = slice(j0, j0 + g)
        contrib = (a[sl, :, :, None] * gather_x(sl)[:, None]).sum(2)
        y.index_add_(0, rb[sl], contrib)
    return y


def spmv_chunked_batched_plain(data3d, meta, xb, num_row_blocks, block_h,
                               chunk):
    """Plain PyTorch version of B2: B1's plain version with a batch axis,
    ``xb`` f32 [ncb, 128, B] -> y f32 [num_row_blocks, block_h, B]."""
    nb = data3d.shape[0] * chunk
    a = data3d.reshape(nb, block_h, LANES).float()
    rb = meta[:, 0, :].reshape(-1) >> 1
    cb = meta[:, 1, :].reshape(-1)
    y = torch.zeros((num_row_blocks, block_h, xb.shape[2]),
                    dtype=torch.float32, device=xb.device)
    return block_products(a, lambda sl: xb.index_select(0, cb[sl]), rb, y)


@traced("kernel.B2")
def spmv_chunked_batched(data3d, meta, xb, num_row_blocks, block_h, chunk,
                         vpt=0):
    """Run the chunked stream against B vectors; returns y f32
    [num_row_blocks, block_h, B].

    ``data3d`` and ``meta`` as for :func:`spmv_chunked`, ``xb`` f32
    [ncb, 128, B] (the JAX layout).  One launch covers the whole batch: its
    grid is ranges of blocks x row slices x groups of V vectors, V picked by
    the launcher unless ``vpt`` (1, 4 or 8) names it.  CPU tensors take the
    plain PyTorch version; CUDA tensors launch the CUDA kernel
    (csrc/spmv_chunked_batched.cu) or raise."""
    name = "spmv_chunked_batched"
    check_payload(name, data3d, meta, xb, block_h, chunk)
    if xb.ndim != 3 or xb.shape[1] != LANES or xb.shape[2] < 1:
        raise ValueError(f"{name}: x must be [n, {LANES}, B], got "
                         f"{tuple(xb.shape)}")
    check_vpt(name, vpt)
    if data3d.device.type == "cpu":
        return spmv_chunked_batched_plain(
            data3d, meta, xb, num_row_blocks, block_h, chunk
        )
    check_cuda_args(name, block_h, data3d, meta, xb)
    lib = cuda_build.get_lib()
    batch = xb.shape[2]
    y = torch.zeros((num_row_blocks, block_h, batch), dtype=torch.float32,
                    device=xb.device)
    with torch.cuda.device(xb.device):
        rc = lib.hispmv_spmv_chunked_batched(
            data3d.data_ptr(), int(data3d.dtype == torch.bfloat16),
            meta.data_ptr(), xb.data_ptr(), y.data_ptr(),
            data3d.shape[0], chunk, block_h, batch, vpt,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(rc, name)
    spmv_chunked_batched.launches += 1
    return y


spmv_chunked_batched.launches = 0  # kernel launches, for the smoke run's check


def chunked_batched_grid(batch, nchunks, chunk, block_h, vpt=0):
    """B2's launch shape for a batch of ``batch`` on ``nchunks`` chunks of
    ``chunk`` blocks of height ``block_h``: (V, row slices, CTAs), with
    V the vectors a thread that its launcher takes for ``vpt``.  Needs the
    built library and a card (the CTA count follows the kernel's
    occupancy)."""
    return cuda_build.launch_shape("hispmv_spmv_chunked_batched_grid",
                                   nchunks, chunk, block_h, batch, vpt)


def pack_chunks_paneled(plan: BlockPlan, chunk: int, panel_ncb: int):
    """Re-sort the block stream by (column panel, row_block) and pack it
    into chunks that never straddle a panel boundary (the JAX package's
    packer; f32, a bfloat16 payload is made on upload).

    Returns (data3d, meta, panel_ids, nchunks):
      meta[:, 0] = row_block*2 + last_of_(panel,row_block)_run
      meta[:, 1] = col_block LOCAL to the panel
      panel_ids  = i32 [nchunks] panel index per chunk
    """
    bh = plan.block_h
    panel = plan.block_cols // panel_ncb
    order = np.lexsort((plan.block_cols, plan.block_rows, panel))
    data = plan.data[order]
    rows = plan.block_rows[order]
    cols_local = (plan.block_cols - panel * panel_ncb)[order]
    panel = panel[order]

    # last flag per (panel, row_block) run
    run_key = panel.astype(np.int64) * (plan.num_row_blocks + 1) + rows
    lasts = np.ones(len(rows), np.int32)
    lasts[:-1] = (run_key[1:] != run_key[:-1]).astype(np.int32)

    # split into per-panel segments, pad each to whole chunks
    seg_data, seg_meta, seg_panel = [], [], []
    for p in np.unique(panel):
        sel = panel == p
        n = int(sel.sum())
        n_pad = -(-n // chunk) * chunk
        d = np.zeros((n_pad, bh, LANES), np.float32)
        d[:n] = data[sel]
        m = np.zeros((2, n_pad), np.int32)
        m[0, :n] = rows[sel] * 2 + lasts[sel]
        m[1, :n] = cols_local[sel]
        if n_pad > n:
            m[0, n:] = rows[sel][-1] * 2  # pad: no flush, zero payload
        seg_data.append(d)
        seg_meta.append(m)
        seg_panel.extend([int(p)] * (n_pad // chunk))
    data = np.concatenate(seg_data) if seg_data else np.zeros(
        (chunk, bh, LANES), np.float32
    )
    meta = (
        np.concatenate(seg_meta, axis=1)
        if seg_meta
        else np.zeros((2, chunk), np.int32)
    )
    if not seg_panel:
        seg_panel = [0]
    nchunks = len(seg_panel)
    data3d = data.reshape(nchunks, chunk * bh, LANES)
    meta = np.ascontiguousarray(
        meta.reshape(2, nchunks, chunk).transpose(1, 0, 2)
    )
    return data3d, meta, np.asarray(seg_panel, np.int32), nchunks


def _check_paneled(name, meta, panel_ids, panel_ncb, out, num_row_blocks,
                   block_h):
    if panel_ids.dtype != torch.int32 or panel_ids.shape != (meta.shape[0],):
        raise ValueError(f"{name}: panel_ids must be int32 [{meta.shape[0]}]")
    if panel_ncb < 1:
        raise ValueError(f"{name}: panel_ncb must be >= 1")
    if out is not None and (out.dtype != torch.float32 or out.shape !=
                            (num_row_blocks, block_h)):
        raise ValueError(f"{name}: out must be float32 "
                         f"[{num_row_blocks}, {block_h}]")


def spmv_chunked_paneled_plain(data3d, meta, panel_ids, x2d, num_row_blocks,
                               block_h, chunk, panel_ncb, out=None):
    """Plain PyTorch version of B3 on the same arrays: B1's, with block j
    of chunk c reading x row ``panel_ids[c] * panel_ncb + cb``; adds into
    ``out`` when given."""
    nb = data3d.shape[0] * chunk
    a = data3d.reshape(nb, block_h, LANES).float()
    rb = meta[:, 0, :].reshape(-1) >> 1
    cb = (meta[:, 1, :] + panel_ids[:, None] * panel_ncb).reshape(-1)
    contrib = (a * x2d.index_select(0, cb)[:, None, :]).sum(-1)
    y = out if out is not None else torch.zeros(
        (num_row_blocks, block_h), dtype=torch.float32, device=x2d.device
    )
    return y.index_add_(0, rb, contrib)


@traced("kernel.B3")
def spmv_chunked_paneled(data3d, meta, panel_ids, x2d, num_row_blocks,
                         block_h, chunk, panel_ncb, out=None):
    """Run the x-paneled chunked stream; returns y tiles f32
    [num_row_blocks, block_h].

    ``data3d`` / ``meta`` / ``panel_ids`` from :func:`pack_chunks_paneled`
    (or one ring step of a sharded chunked plan, with all panel ids zero),
    ``x2d`` f32 [npanels*panel_ncb, 128].  With ``out`` (f32
    [num_row_blocks, block_h]) the stream adds into it and returns it, so
    the steps of a ring sum into one y.  The kernel is B1's at one vector
    with each chunk's panel offset added to its x rows: a grid of block
    ranges x row slices that fills one wave, whose shape is
    ``chunked_paneled_grid(nchunks, chunk, block_h)``.  CPU tensors take
    the plain PyTorch version; CUDA tensors launch the CUDA kernel
    (csrc/spmv_chunked_paneled.cu) or raise."""
    name = "spmv_chunked_paneled"
    check_stream_args(name, data3d, meta, x2d, block_h, chunk)
    _check_paneled(name, meta, panel_ids, panel_ncb, out, num_row_blocks,
                   block_h)
    if data3d.device.type == "cpu":
        return spmv_chunked_paneled_plain(data3d, meta, panel_ids, x2d,
                                          num_row_blocks, block_h, chunk,
                                          panel_ncb, out)
    y = out if out is not None else torch.zeros(
        (num_row_blocks, block_h), dtype=torch.float32, device=x2d.device
    )
    check_cuda_args(name, block_h, data3d, meta, panel_ids, x2d, y)
    lib = cuda_build.get_lib()
    with torch.cuda.device(x2d.device):
        rc = lib.hispmv_spmv_chunked_paneled(
            data3d.data_ptr(), int(data3d.dtype == torch.bfloat16),
            meta.data_ptr(), panel_ids.data_ptr(), x2d.data_ptr(),
            y.data_ptr(), data3d.shape[0], chunk, block_h, panel_ncb,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(rc, name)
    spmv_chunked_paneled.launches += 1
    return y


spmv_chunked_paneled.launches = 0  # kernel launches, for the smoke run's check


def chunked_paneled_grid(nchunks, chunk, block_h):
    """B3's launch shape on ``nchunks`` chunks of ``chunk`` blocks of
    height ``block_h``: (V, row slices, CTAs); V is 1.  Needs the built
    library and a card (the CTA count follows the kernel's occupancy)."""
    return cuda_build.launch_shape("hispmv_spmv_chunked_paneled_grid",
                                   nchunks, chunk, block_h)


def pack_chunks_tiled(plan: BlockPlan, chunk: int, panel_ncb: int,
                      panel_nrb: int):
    """Re-sort the block stream by (row panel, col panel, row_block) and
    pack it into chunks that never straddle a (row panel, col panel) pair
    (the JAX package's packer; f32, a bfloat16 payload is made on upload).

    Returns (data3d, meta, xpanel_ids, ypanel_ids, yfirst, nchunks):
      meta[:, 0] = local_row_block*2 + last_of_(rp,cp,row_block)_run
      meta[:, 1] = col_block LOCAL to the column panel
      xpanel_ids i32 [nchunks] column panel per chunk
      ypanel_ids i32 [nchunks] row panel per chunk
      yfirst     i32 [nchunks] 1 on the first chunk of each row panel (the
                 TPU kernel zeroes its y panel there; B4 does not read it)
    """
    bh = plan.block_h
    cpanel = plan.block_cols // panel_ncb
    rpanel = plan.block_rows // panel_nrb
    order = np.lexsort((plan.block_cols, plan.block_rows, cpanel, rpanel))
    data = plan.data[order]
    rows_local = (plan.block_rows - rpanel * panel_nrb)[order]
    cols_local = (plan.block_cols - cpanel * panel_ncb)[order]
    cpanel = cpanel[order]
    rpanel = rpanel[order]

    # last flag per (rpanel, cpanel, row_block) run
    ncp = int(cpanel.max()) + 1 if len(cpanel) else 1
    run_key = (rpanel.astype(np.int64) * ncp + cpanel) * (panel_nrb + 1) \
        + rows_local
    lasts = np.ones(len(rows_local), np.int32)
    lasts[:-1] = (run_key[1:] != run_key[:-1]).astype(np.int32)

    # split into per-(rpanel, cpanel) segments, pad each to whole chunks
    seg_key = rpanel.astype(np.int64) * ncp + cpanel
    seg_data, seg_meta, seg_xp, seg_yp = [], [], [], []
    for k in np.unique(seg_key):
        sel = seg_key == k
        n = int(sel.sum())
        n_pad = -(-n // chunk) * chunk
        d = np.zeros((n_pad, bh, LANES), np.float32)
        d[:n] = data[sel]
        m = np.zeros((2, n_pad), np.int32)
        m[0, :n] = rows_local[sel] * 2 + lasts[sel]
        m[1, :n] = cols_local[sel]
        if n_pad > n:
            m[0, n:] = rows_local[sel][-1] * 2  # pad: no flush, zero payload
        seg_data.append(d)
        seg_meta.append(m)
        seg_xp.extend([int(k % ncp)] * (n_pad // chunk))
        seg_yp.extend([int(k // ncp)] * (n_pad // chunk))
    if not seg_data:
        seg_data = [np.zeros((chunk, bh, LANES), np.float32)]
        seg_meta = [np.zeros((2, chunk), np.int32)]
        seg_xp, seg_yp = [0], [0]
    data = np.concatenate(seg_data)
    meta = np.concatenate(seg_meta, axis=1)
    nchunks = len(seg_xp)
    data3d = data.reshape(nchunks, chunk * bh, LANES)
    meta = np.ascontiguousarray(
        meta.reshape(2, nchunks, chunk).transpose(1, 0, 2)
    )
    ypanel_ids = np.asarray(seg_yp, np.int32)
    yfirst = np.ones(nchunks, np.int32)
    yfirst[1:] = (ypanel_ids[1:] != ypanel_ids[:-1]).astype(np.int32)
    return (data3d, meta, np.asarray(seg_xp, np.int32), ypanel_ids, yfirst,
            nchunks)


def tiled_sector_mask(data3d, block_h):
    """B4's sector mask of the payload ``data3d`` f32 or bf16 [nchunks,
    chunk*block_h, 128]: int16 [nchunks, chunk*block_h], one word a payload
    row, bit g set when lanes 8g .. 8g+7 of the row hold a nonzero (16
    bits a row; a 32-byte sector of an f32 row, 16 bytes of a bf16 one).
    Padding rows get 0.  Computed with torch on the tensor's own device;
    pass the uploaded payload, so that a value a bf16 cast flushed to zero
    leaves its bit clear.  0.39% of an f32 payload's bytes, 0.78% of a
    bf16 one's."""
    if data3d.ndim != 3 or data3d.shape[2] != LANES or \
            data3d.shape[1] % block_h:
        raise ValueError(f"tiled_sector_mask: data shape "
                         f"{tuple(data3d.shape)} is not [nchunks, "
                         f"chunk*{block_h}, {LANES}]")
    nch, rows, _ = data3d.shape
    groups = LANES // SECTOR_LANES
    live = (data3d != 0).reshape(nch, rows, groups, SECTOR_LANES).any(-1)
    weights = torch.ones(groups, dtype=torch.int32, device=data3d.device) \
        << torch.arange(groups, dtype=torch.int32, device=data3d.device)
    words = (live.to(torch.int32) * weights).sum(-1, dtype=torch.int32)
    # bit 15 as the sign of an int16, without an out-of-range cast
    return (words - ((words >> 15) << 16)).to(torch.int16)


def _check_sector_mask(name, sector_mask, data3d):
    if sector_mask.dtype != torch.int16 or \
            sector_mask.shape != data3d.shape[:2]:
        raise ValueError(f"{name}: sector_mask must be int16 "
                         f"{list(data3d.shape[:2])}, got {sector_mask.dtype} "
                         f"{list(sector_mask.shape)}")


def _check_tiled(name, meta, xpanel_ids, ypanel_ids, panel_ncb, panel_nrb,
                 num_row_panels):
    nch = meta.shape[0]
    for ids in (xpanel_ids, ypanel_ids):
        if ids.dtype != torch.int32 or ids.shape != (nch,):
            raise ValueError(f"{name}: panel ids must be int32 [{nch}]")
    if panel_ncb < 1 or panel_nrb < 1 or num_row_panels < 1:
        raise ValueError(f"{name}: panel_ncb, panel_nrb and num_row_panels "
                         "must be >= 1")
    if num_row_panels * panel_nrb * 2 >= 2**31:
        raise ValueError(f"{name}: {num_row_panels * panel_nrb} row blocks "
                         "do not fit the kernel's int32 row words")


def spmv_chunked_tiled_plain(data3d, meta, xpanel_ids, ypanel_ids, x2d,
                             num_row_panels, panel_nrb, block_h, chunk,
                             panel_ncb, sector_mask=None):
    """Plain PyTorch version of B4 on the same arrays: B1's, with block j
    of chunk c reading x row ``xpanel_ids[c] * panel_ncb + cb`` and adding
    into row-block ``ypanel_ids[c] * panel_nrb + rb``.  With
    ``sector_mask`` (:func:`tiled_sector_mask`) the lanes of every granule
    whose bit is clear are taken as 0, as the kernel takes them.  Row
    panels no chunk visits stay zero."""
    nb = data3d.shape[0] * chunk
    a = data3d.reshape(nb, block_h, LANES).float()
    if sector_mask is not None:
        bit = torch.arange(LANES, device=a.device) // SECTOR_LANES
        keep = (sector_mask.to(torch.int32)[..., None] >> bit) & 1
        a = torch.where(keep.reshape(a.shape).bool(), a, 0.0)
    rb = ((meta[:, 0, :] >> 1) + ypanel_ids[:, None] * panel_nrb).reshape(-1)
    cb = (meta[:, 1, :] + xpanel_ids[:, None] * panel_ncb).reshape(-1)
    contrib = (a * x2d.index_select(0, cb)[:, None, :]).sum(-1)
    y = torch.zeros((num_row_panels * panel_nrb, block_h),
                    dtype=torch.float32, device=x2d.device)
    return y.index_add_(0, rb, contrib)


@traced("kernel.B4")
def spmv_chunked_tiled(data3d, meta, xpanel_ids, ypanel_ids, x2d,
                       num_row_panels, panel_nrb, block_h, chunk, panel_ncb,
                       sector_mask=None):
    """Run the x- and y-paneled chunked stream; returns y tiles f32
    [num_row_panels*panel_nrb, block_h].

    ``data3d`` / ``meta`` / ``xpanel_ids`` / ``ypanel_ids`` from
    :func:`pack_chunks_tiled` (its ``yfirst`` is not needed: y is zeroed
    once before the launch), ``x2d`` f32 [npanels_x*panel_ncb, 128],
    ``sector_mask`` int16 [nchunks, chunk*block_h] from
    :func:`tiled_sector_mask` of the same payload (the handle makes it once
    at upload).  The kernel is B3's at one vector with each chunk's row
    panel offset added to its row blocks too, and it loads a payload value
    only where the mask's bit of its 8-lane granule is set, taking 0
    elsewhere: the result is the product with the clear granules' lanes
    zeroed, which the helper's mask leaves equal to the unmasked product
    (those lanes hold zeros, and 0 * x is still formed, so a non-finite x
    gives NaN there as in the TPU kernel).  Its grid of block ranges x row
    slices fills one wave; its shape is ``chunked_tiled_grid(nchunks,
    chunk, block_h)``.  CPU tensors take the plain PyTorch version (with
    the mask applied when one is given); CUDA tensors launch the CUDA
    kernel (csrc/spmv_chunked_tiled.cu), which needs the mask, or raise."""
    name = "spmv_chunked_tiled"
    check_stream_args(name, data3d, meta, x2d, block_h, chunk)
    _check_tiled(name, meta, xpanel_ids, ypanel_ids, panel_ncb, panel_nrb,
                 num_row_panels)
    if sector_mask is not None:
        _check_sector_mask(name, sector_mask, data3d)
    if data3d.device.type == "cpu":
        return spmv_chunked_tiled_plain(data3d, meta, xpanel_ids, ypanel_ids,
                                        x2d, num_row_panels, panel_nrb,
                                        block_h, chunk, panel_ncb,
                                        sector_mask)
    check_cuda_args(name, block_h, data3d, meta, xpanel_ids, ypanel_ids, x2d)
    if sector_mask is None:
        raise ValueError(f"{name}: the CUDA kernel needs the payload's "
                         "sector_mask (tiled_sector_mask)")
    check_cuda_tensors(name, data3d, sector_mask)
    if sector_mask.data_ptr() % 16:
        raise ValueError(f"{name}: sector_mask must be 16-byte aligned")
    lib = cuda_build.get_lib()
    y = torch.zeros((num_row_panels * panel_nrb, block_h),
                    dtype=torch.float32, device=x2d.device)
    with torch.cuda.device(x2d.device):
        rc = lib.hispmv_spmv_chunked_tiled(
            data3d.data_ptr(), int(data3d.dtype == torch.bfloat16),
            sector_mask.data_ptr(), meta.data_ptr(), xpanel_ids.data_ptr(),
            ypanel_ids.data_ptr(), x2d.data_ptr(), y.data_ptr(),
            data3d.shape[0], chunk, block_h, panel_ncb, panel_nrb,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(rc, name)
    spmv_chunked_tiled.launches += 1
    return y


spmv_chunked_tiled.launches = 0  # kernel launches, for the smoke run's check


def chunked_tiled_grid(nchunks, chunk, block_h):
    """B4's launch shape on ``nchunks`` chunks of ``chunk`` blocks of
    height ``block_h``: (V, row slices, CTAs); V is 1.  Needs the built
    library and a card (the CTA count follows the kernel's occupancy)."""
    return cuda_build.launch_shape("hispmv_spmv_chunked_tiled_grid",
                                   nchunks, chunk, block_h)
