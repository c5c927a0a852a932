"""Block-ELL planner: matrix -> packed dense-block stream.

Carried over from ``hispmv_tpu/plan/blocks.py`` so that plans are identical
in both packages.  The packing runs in the C++ routine of
``hispmv_tpu_torch/native`` (``pack_blocks``); ``_pack_blocks_numpy`` is
its plain version, which the tests hold it to.  Original notes follow.

TPU-native re-design of the reference's stream encoder (``prepareTile``,
common/src/spmv-helper.cpp:517-638).  The reference packs individual nonzeros
into per-PE uint64 streams because FPGA PEs consume one nnz per cycle; a TPU
consumes *tiles*.  So the planner's unit of work is a dense (block_h, 128)
sub-block of A: every nonzero lands in exactly one block, blocks are packed
contiguously sorted by (row_block, col_block), and two small index arrays
(the block's row-block and col-block ids) drive the Pallas kernel's
scalar-prefetch DMA pipeline — the analog of the reference's per-channel
``A_off/A_len`` stream descriptors (spmv-helper.cpp:677-698).

Key properties (mirroring the reference's contracts):

- *Conflict-free accumulation*: blocks of one row-block are consecutive, so
  the kernel accumulates each y tile in VMEM and writes it exactly once —
  no scatter, no RAW hazard (AccumBuffer contract, base_functions.cpp:439).
- *Static shapes*: the stream is a single [nblocks, block_h, 128] array;
  padding blocks (for empty row-blocks) make every y tile visited.
- *Matrix-adaptive*: ``block_h`` and the optional column reordering are
  autotuner knobs; fill statistics feed the cost model
  (cyclecount_est.py analog).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from hispmv_tpu_torch import native
from hispmv_tpu_torch.formats.matrix import COOMatrix

LANES = 128  # TPU lane width; block width is fixed to one vreg row.


@dataclasses.dataclass
class BlockPlan:
    """A packed block-ELL execution plan for one matrix.

    Attributes:
      shape: original (rows, cols) before padding.
      block_h: block height (rows per block; 8/16/32 are natural vreg tiles).
      data: f32 [nblocks, block_h, LANES] dense block payloads.
      block_rows: i32 [nblocks] row-block index of each block (sorted).
      block_cols: i32 [nblocks] col-block index of each block.
      block_firsts: i32 [nblocks] 1 where a block starts a new row-block.
      block_lasts: i32 [nblocks] 1 where a block ends its row-block.
      num_row_blocks / num_col_blocks: padded grid extents.
      col_perm: optional i32 [cols] column permutation applied to the matrix
        (x must be gathered with it before the kernel; used by the
        densifying reorder pass).
    """

    shape: tuple
    nnz: int
    block_h: int
    data: np.ndarray
    block_rows: np.ndarray
    block_cols: np.ndarray
    block_firsts: np.ndarray
    block_lasts: np.ndarray
    num_row_blocks: int
    num_col_blocks: int
    col_perm: Optional[np.ndarray] = None

    @property
    def num_blocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def fill(self) -> float:
        """Fraction of block slots holding a real nonzero (higher = better)."""
        slots = self.data.size
        return self.nnz / slots if slots else 0.0

    @property
    def stream_bytes(self) -> int:
        return self.data.nbytes + self.block_rows.nbytes + self.block_cols.nbytes

    @property
    def bytes_per_nnz(self) -> float:
        return self.stream_bytes / max(self.nnz, 1)


def degree_column_perm(coo: COOMatrix) -> np.ndarray:
    """Column permutation sorting columns by descending nonzero count.

    Power-law matrices have a few "hub" columns touched by most rows; sorting
    by degree clusters them into a handful of dense column blocks, raising
    block fill dramatically.  This is the planner-side answer to load
    imbalance, playing the role of the reference's shared-row balancing
    (spmv-helper.cpp:265-347) for the column axis.
    """
    deg = np.bincount(coo.cols, minlength=coo.num_cols)
    return np.argsort(-deg, kind="stable").astype(np.int32)


def build_block_plan(
    coo: COOMatrix,
    block_h: int = 8,
    col_perm: Optional[np.ndarray] = None,
) -> BlockPlan:
    """Pack a COO matrix into a sorted dense-block stream."""
    if block_h < 1:
        raise ValueError("block_h must be >= 1")
    R, C = coo.shape
    nrb = max(-(-R // block_h), 1)
    ncb = max(-(-C // LANES), 1)

    rows, cols = coo.rows, coo.cols  # int32
    if col_perm is not None:
        # col_perm[k] = original column placed at position k; nonzeros move
        # with the inverse map.
        inv = np.empty(C, np.int32)
        inv[col_perm] = np.arange(C, dtype=np.int32)
        cols = inv[cols]

    block_rows, block_cols, data = native.pack_blocks(
        rows, cols, coo.values, block_h, ncb)
    return _assemble_plan(
        coo, block_h, col_perm, block_rows, block_cols, data, nrb, ncb
    )


def _pack_blocks_numpy(rows, cols, vals, block_h, ncb):
    """Plain version of ``native.pack_blocks``: (block_rows, block_cols,
    data) of the nonzeros, blocks sorted by (row block, col block),
    duplicates summed in COO order."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    key = (rows // block_h) * ncb + cols // LANES
    uniq, inv_idx = np.unique(key, return_inverse=True)
    block_rows = (uniq // ncb).astype(np.int32)
    block_cols = (uniq % ncb).astype(np.int32)
    data = np.zeros((len(uniq), block_h, LANES), np.float32)
    np.add.at(data, (inv_idx, rows % block_h, cols % LANES), vals)
    return block_rows, block_cols, data


def _assemble_plan(
    coo, block_h, col_perm, block_rows, block_cols, data, nrb, ncb
) -> BlockPlan:
    """Shared plan assembly: insert zero blocks for unvisited row-blocks
    (their y tiles must be written; analog of the reference's zero-padding
    stream entries, spmv-helper.cpp:622-637), then derive first/last flags."""
    missing = np.setdiff1d(
        np.arange(nrb, dtype=np.int32), block_rows, assume_unique=False
    )
    if len(missing):
        sort_key = block_rows.astype(np.int64) * ncb + block_cols
        pos = np.searchsorted(sort_key, missing.astype(np.int64) * ncb)
        block_rows = np.insert(block_rows, pos, missing)
        block_cols = np.insert(block_cols, pos, 0)
        data = np.insert(data, pos, 0.0, axis=0)

    nblocks = len(block_rows)
    firsts = np.ones(nblocks, np.int32)
    firsts[1:] = (block_rows[1:] != block_rows[:-1]).astype(np.int32)
    lasts = np.ones(nblocks, np.int32)
    lasts[:-1] = firsts[1:]

    return BlockPlan(
        shape=coo.shape,
        nnz=coo.nnz,
        block_h=block_h,
        data=data,
        block_rows=block_rows,
        block_cols=block_cols,
        block_firsts=firsts,
        block_lasts=lasts,
        num_row_blocks=nrb,
        num_col_blocks=ncb,
        col_perm=None if col_perm is None else np.asarray(col_perm, np.int32),
    )


def block_plan_matvec_numpy(plan: BlockPlan, x: np.ndarray) -> np.ndarray:
    """Golden numpy executor of a BlockPlan (float64 accumulate)."""
    R, C = plan.shape
    xp = x if plan.col_perm is None else x[plan.col_perm]
    x_pad = np.zeros(plan.num_col_blocks * LANES, np.float64)
    x_pad[: len(xp)] = xp
    xb = x_pad.reshape(plan.num_col_blocks, LANES)
    y = np.zeros((plan.num_row_blocks, plan.block_h), np.float64)
    contrib = np.einsum(
        "bij,bj->bi", plan.data.astype(np.float64), xb[plan.block_cols]
    )
    np.add.at(y, plan.block_rows, contrib)
    return y.reshape(-1)[:R].astype(np.float32)
