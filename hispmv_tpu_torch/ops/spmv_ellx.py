"""ELLX: base-K block-ELL executor + B1 / B2 overflow stream.

Port of ``hispmv_tpu/ops/spmv_ellx.py``.  The planner (``EllxPlan``,
``choose_k_base``, ``build_ellx_plan``) is carried over unchanged,
TPU-calibrated cost constants included, so both packages build identical
plans.  ``ellx_base_matvec`` (and its batched form) is a plain torch gather
plus batched product in full fp32, as the JAX package leaves it to XLA
outside any kernel; the overflow stream runs the B1 kernel (B2 against a
batch, ops/spmv_chunked.py) and merges back through ``ov_expand``.

Original notes on the design: every row-block gets exactly ``k_base``
block slots in a [nrb, K, bh, 128] array (zero-padded), executed as one
dense gather -> multiply -> reduce pass; rows heavier than ``k_base`` spill
their extra blocks to a compact OVERFLOW stream; ``y = y_base +
y_overflow``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hispmv_tpu_torch.ops.gemv import full_fp32
from hispmv_tpu_torch.ops.spmv_chunked import (
    spmv_chunked,
    spmv_chunked_batched,
)
from hispmv_tpu_torch.plan.blocks import LANES, BlockPlan

# Measured TPU v5e constants of the JAX package, kept unchanged so that
# plans stay identical; used only to pick k_base.
# The overflow stream's per-block cost is ~45 ns at block_h=1 (flush-heavy:
# nearly every block ends a row run) — measured on trans5-class plans.
_ELLX_BYTES_PER_S = 450e9
_OVERFLOW_BLOCK_S = 4.5e-8
_OVERFLOW_LAUNCH_S = 3e-6

# The batched base product gathers x for a group of row-blocks at a time,
# [group, K, 128, B], so that its copy stays under this size whatever B is.
BASE_GATHER_BYTES = 256 << 20


@dataclasses.dataclass
class EllxPlan:
    """Dense base-K ELL arrays + optional overflow block stream."""

    shape: tuple
    nnz: int
    block_h: int
    k_base: int
    # base: every row-block padded/truncated to k_base block slots
    base_data: np.ndarray  # [nrb, k_base, bh, LANES]
    base_cols: np.ndarray  # i32 [nrb, k_base]
    # overflow: blocks beyond k_base, a COMPACT chunked stream over only
    # the row-blocks that overflow (or None); ov_expand maps every rb to
    # 1 + its overflow output slot, 0 when it has none (for the merge
    # row-gather).
    overflow: Optional[BlockPlan]
    num_row_blocks: int
    num_col_blocks: int
    col_perm: Optional[np.ndarray] = None
    ov_expand: Optional[np.ndarray] = None

    @property
    def base_bytes(self) -> int:
        return self.base_data.nbytes + self.base_cols.nbytes

    @property
    def overflow_blocks(self) -> int:
        return 0 if self.overflow is None else self.overflow.num_blocks

    @property
    def fill(self) -> float:
        slots = self.base_data.size + (
            self.overflow.data.size if self.overflow is not None else 0
        )
        return self.nnz / slots if slots else 0.0


def choose_k_base(counts: np.ndarray, block_h: int) -> int:
    """Pick the base slot count minimizing modeled time:
    base DMA (nrb*k*bh*512 B at the fused rate) + overflow kernel cost."""
    nrb = len(counts)
    best_k, best_t = 1, float("inf")
    kmax = int(counts.max()) if nrb else 1
    k = 1
    while True:
        base_b = nrb * k * (block_h * LANES * 4 + 4)
        over = int(np.maximum(counts - k, 0).sum())
        t = base_b / _ELLX_BYTES_PER_S + (
            (_OVERFLOW_LAUNCH_S + over * _OVERFLOW_BLOCK_S) if over else 0.0
        )
        if t < best_t:
            best_k, best_t = k, t
        if k >= kmax:
            break
        k = min(k * 2, kmax)
    return best_k


def build_ellx_plan(
    plan: BlockPlan,
    k_base: Optional[int] = None,
    max_base_bytes: Optional[int] = None,
) -> EllxPlan:
    """Convert a sorted BlockPlan into base-K ELL arrays + overflow.

    ``max_base_bytes`` caps the base array (residual executors for huge
    matrices must not claim gigabytes just because the cost model would
    prefer a bigger K)."""
    nrb = plan.num_row_blocks
    bh = plan.block_h
    counts = np.bincount(plan.block_rows, minlength=nrb)
    if k_base is None:
        k_base = choose_k_base(counts, bh)
    if max_base_bytes is not None:
        per_k = max(nrb * (bh * LANES * 4 + 4), 1)
        k_base = max(1, min(int(k_base), max_base_bytes // per_k))

    starts = np.concatenate([[0], np.cumsum(counts)])
    take = np.minimum(counts, k_base)

    base_data = np.zeros((nrb, k_base, bh, LANES), np.float32)
    base_cols = np.zeros((nrb, k_base), np.int32)
    # vectorized base fill: positions of the first `take[rb]` blocks per rb
    rb_of_block = plan.block_rows
    pos_in_rb = np.arange(len(rb_of_block)) - starts[rb_of_block]
    in_base = pos_in_rb < k_base
    base_data[rb_of_block[in_base], pos_in_rb[in_base]] = plan.data[in_base]
    base_cols[rb_of_block[in_base], pos_in_rb[in_base]] = plan.block_cols[
        in_base
    ]

    overflow = None
    ov_expand = None
    if not in_base.all():
        ov = ~in_base
        ov_rows_orig = plan.block_rows[ov]
        ov_cols = plan.block_cols[ov]
        ov_data = plan.data[ov]
        # COMPACT the overflow: only row-blocks that actually overflow get
        # an output slot (a zero block per empty rb would make the overflow
        # stream O(nrb) — measured as the dominant cost on light matrices).
        # The merge back is a cheap row-gather: y += take(concat([0, y_ov]),
        # ov_expand) where ov_expand maps rb -> its overflow slot (or 0).
        uniq_rb = np.unique(ov_rows_orig)
        compact = np.searchsorted(uniq_rb, ov_rows_orig)
        ov_expand = np.zeros(nrb, np.int32)
        ov_expand[uniq_rb] = np.arange(1, len(uniq_rb) + 1, dtype=np.int32)
        n = len(ov_rows_orig)
        firsts = np.ones(n, np.int32)
        firsts[1:] = (compact[1:] != compact[:-1]).astype(np.int32)
        lasts = np.ones(n, np.int32)
        lasts[:-1] = firsts[1:]
        overflow = BlockPlan(
            shape=plan.shape,
            nnz=int(np.count_nonzero(ov_data)),
            block_h=bh,
            data=ov_data,
            block_rows=compact.astype(np.int32),
            block_cols=ov_cols,
            block_firsts=firsts,
            block_lasts=lasts,
            num_row_blocks=len(uniq_rb),
            num_col_blocks=plan.num_col_blocks,
        )

    return EllxPlan(
        shape=plan.shape,
        nnz=plan.nnz,
        block_h=bh,
        k_base=int(k_base),
        base_data=base_data,
        base_cols=base_cols,
        overflow=overflow,
        num_row_blocks=nrb,
        num_col_blocks=plan.num_col_blocks,
        col_perm=plan.col_perm,
        ov_expand=ov_expand,
    )


def ellx_base_matvec(base_data, base_cols, x2d):
    """y_tiles [nrb, bh] = gather + multiply + reduce over the base ELL.

    ``base_data`` [nrb, K, bh, 128] (fp32 or bf16), ``base_cols``
    [nrb, K] i32, ``x2d`` [ncb, 128] f32.  One batched (bh, 128) @ (128, 1)
    product per slot reads base_data in place (an einsum over (k, l) would
    first copy it into a contiguous [nrb, bh, K*128] operand), then a sum
    over the K slots; one path serves every block height."""
    nrb, K = base_cols.shape
    xr = x2d.index_select(0, base_cols.reshape(-1))
    with full_fp32():
        y = torch.matmul(base_data.float(), xr.reshape(nrb, K, LANES, 1))
    return y.sum(dim=(1, 3))


def ellx_matvec(d: dict, x2d, num_row_blocks: int, block_h: int,
                chunk: Optional[int] = None, ov_nrb: int = 0):
    """Full ELLX execution: base product + optional B1 overflow stream.

    ``d`` holds device tensors: base_data, base_cols, and (when overflow
    exists) odata/ometa (packed by ops.spmv_chunked.pack_chunks) plus
    ov_expand; ``ov_nrb`` is the COMPACT overflow row-block count."""
    y = ellx_base_matvec(d["base_data"], d["base_cols"], x2d)
    if "odata" in d:
        y_ov = spmv_chunked(
            d["odata"], d["ometa"], x2d, ov_nrb, block_h, chunk
        )  # [ov_nrb, bh] — compact
        padded = torch.cat([y_ov.new_zeros((1, y_ov.shape[1])), y_ov])
        y = y + padded.index_select(0, d["ov_expand"])
    return y


def ellx_base_matvec_batched(base_data, base_cols, xb):
    """y_tiles [nrb, bh, B] over the base ELL against ``xb`` f32
    [ncb, 128, B]: per group of row-blocks, gather the x rows of every slot
    ([group, K, 128, B], at most ``BASE_GATHER_BYTES``), one (bh, 128) @
    (128, B) product per slot in full fp32, and a sum over the K slots.
    The groups give the same sums as one pass over all row-blocks."""
    nrb, K = base_cols.shape
    bh = base_data.shape[2]
    B = xb.shape[2]
    group = max(1, BASE_GATHER_BYTES // (K * LANES * B * 4))
    y = torch.empty((nrb, bh, B), dtype=torch.float32, device=xb.device)
    for r0 in range(0, nrb, group):
        cols = base_cols[r0:r0 + group].reshape(-1)
        xr = xb.index_select(0, cols).reshape(-1, K, LANES, B)
        with full_fp32():
            yk = torch.matmul(base_data[r0:r0 + group].float(), xr)
        y[r0:r0 + group] = yk.sum(dim=1)
    return y


def ellx_matvec_batched(d: dict, xb, num_row_blocks: int, block_h: int,
                        chunk: Optional[int] = None, ov_nrb: int = 0):
    """Batched ELLX: ``xb`` f32 [ncb, 128, B] -> y [nrb, bh, B]; the base
    product in groups (:func:`ellx_base_matvec_batched`) plus the overflow
    through B2, merged back through ``ov_expand``."""
    y = ellx_base_matvec_batched(d["base_data"], d["base_cols"], xb)
    if "odata" in d:
        y_ov = spmv_chunked_batched(
            d["odata"], d["ometa"], xb, ov_nrb, block_h, chunk
        )  # [ov_nrb, bh, B] — compact
        padded = torch.cat([y_ov.new_zeros((1,) + y_ov.shape[1:]), y_ov])
        y = y + padded.index_select(0, d["ov_expand"])
    return y
