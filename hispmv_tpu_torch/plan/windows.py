"""Windowed block-ELL planner: blocks gather columns from a 1024-wide window.

Carried over unchanged from ``hispmv_tpu/plan/windows.py`` (numpy and the standard library
only), so that both packages build identical plans.  Original notes follow.

The plain block format (plan/blocks.py) pays 4 KiB per touched (block_h,128)
tile, which collapses on scattered matrices (~1 nnz per tile).  This format
exploits the one dynamic-indexing primitive the TPU VPU does support — a
sublane gather within an (8,128) tile — to let every block choose, per lane,
WHICH of the 8 column-segments of a 1024-column window it reads:

    block lane j reads x[window*1024 + subidx[j]*128 + j]

so one windowed block covers any set of columns of a window with distinct
lane residues (c mod 128).  Columns colliding on a lane residue go to extra
"layers" (additional blocks of the same (row_block, window)).  On scattered
matrices this merges up to 8 plain blocks into one, raising fill ~4-6x; the
cost is a 512 B int32 sub-index sideband per block (12.5%% of payload at
block_h=8) and one in-kernel gather op.

This is the TPU answer to the reference's BRAM-banked B window with per-PE
addressing (LoadB + ComputeAB gather, base_functions.cpp:105-150, :228-241):
the window is the B_WINDOW analog, the lane residue is the bank, and the
planner resolves bank conflicts at prepare time instead of stalling hardware.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hispmv_tpu_torch.formats.matrix import COOMatrix

LANES = 128
WINDOW = 1024  # columns per window = 8 segments of LANES
SEGS = WINDOW // LANES  # 8 sub-index values -> one (8,128) x tile


@dataclasses.dataclass
class WindowPlan:
    """Packed windowed-block stream for one matrix."""

    shape: tuple
    nnz: int
    block_h: int
    data: np.ndarray  # f32 [nblocks, block_h, LANES]
    subidx: np.ndarray  # i32 [nblocks, LANES], values in [0, SEGS)
    block_rows: np.ndarray  # i32 [nblocks] row-block ids (sorted)
    block_wins: np.ndarray  # i32 [nblocks] window ids
    block_firsts: np.ndarray  # i32 [nblocks]
    block_lasts: np.ndarray  # i32 [nblocks]
    num_row_blocks: int
    num_windows: int

    @property
    def num_blocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def fill(self) -> float:
        slots = self.data.size
        return self.nnz / slots if slots else 0.0

    @property
    def stream_bytes(self) -> int:
        return self.data.nbytes + self.subidx.nbytes


def build_window_plan(
    coo: COOMatrix, block_h: int = 8
) -> WindowPlan:
    """Pack a COO matrix into the windowed block stream (vectorized)."""
    R, C = coo.shape
    nrb = max(-(-R // block_h), 1)
    nwin = max(-(-C // WINDOW), 1)

    r = coo.rows.astype(np.int64)
    c = coo.cols.astype(np.int64)
    v = coo.values

    rb = r // block_h
    wb = c // WINDOW
    lane = c % LANES
    sub = (c // LANES) % SEGS

    # Layer assignment: within (rb, wb, lane), each distinct sub gets a
    # layer equal to its rank.  Two nnz with the same (rb, wb, lane, sub)
    # share a block slot column (they are in the same matrix column).
    key_full = ((rb * nwin + wb) * LANES + lane) * SEGS + sub
    uniq_slots, slot_of_nnz = np.unique(key_full, return_inverse=True)
    # rank of each unique slot within its (rb, wb, lane) group
    group = uniq_slots // SEGS  # (rb, wb, lane) id per unique slot
    # uniq_slots is sorted, so equal groups are consecutive: rank = index -
    # first index of the group
    first_in_group = np.zeros(len(uniq_slots), np.int64)
    newgrp = np.nonzero(np.diff(group))[0] + 1
    first_in_group[newgrp] = newgrp
    np.maximum.accumulate(first_in_group, out=first_in_group)
    layer_of_slot = np.arange(len(uniq_slots)) - first_in_group

    # blocks: one per (rb, wb, layer)
    rbwb_of_slot = group // LANES  # (rb*nwin + wb) per unique slot
    block_key = rbwb_of_slot * SEGS + layer_of_slot  # layer < SEGS
    uniq_blocks, block_of_slot = np.unique(block_key, return_inverse=True)
    nblocks = len(uniq_blocks)
    block_rows = (uniq_blocks // (SEGS * np.int64(nwin))).astype(np.int32)
    block_wins = ((uniq_blocks // SEGS) % nwin).astype(np.int32)

    # sideband: subidx[block, lane] = sub of the slot (0 where unused)
    subidx = np.zeros((nblocks, LANES), np.int32)
    lane_of_slot = (uniq_slots // SEGS) % LANES
    subidx[block_of_slot, lane_of_slot] = (uniq_slots % SEGS).astype(np.int32)

    # payload fill
    data = np.zeros((nblocks, block_h, LANES), np.float32)
    np.add.at(
        data,
        (block_of_slot[slot_of_nnz], (r % block_h), lane),
        v,
    )

    # ensure every row-block appears (zero block, window 0)
    missing = np.setdiff1d(np.arange(nrb, dtype=np.int32), block_rows)
    if len(missing):
        sort_key = block_rows.astype(np.int64) * (nwin * SEGS)
        sort_key += block_wins.astype(np.int64) * SEGS
        ins = np.searchsorted(sort_key, missing.astype(np.int64) * (nwin * SEGS))
        block_rows = np.insert(block_rows, ins, missing)
        block_wins = np.insert(block_wins, ins, 0)
        data = np.insert(data, ins, 0.0, axis=0)
        subidx = np.insert(subidx, ins, 0, axis=0)
        nblocks = len(block_rows)

    firsts = np.ones(nblocks, np.int32)
    firsts[1:] = (block_rows[1:] != block_rows[:-1]).astype(np.int32)
    lasts = np.ones(nblocks, np.int32)
    lasts[:-1] = firsts[1:]

    return WindowPlan(
        shape=(R, C),
        nnz=coo.nnz,
        block_h=block_h,
        data=data,
        subidx=subidx,
        block_rows=block_rows,
        block_wins=block_wins,
        block_firsts=firsts,
        block_lasts=lasts,
        num_row_blocks=nrb,
        num_windows=nwin,
    )


def window_plan_matvec_numpy(plan: WindowPlan, x: np.ndarray) -> np.ndarray:
    """Golden numpy executor (float64 accumulate)."""
    R, C = plan.shape
    xp = np.zeros(plan.num_windows * WINDOW, np.float64)
    xp[:C] = x
    x2d = xp.reshape(plan.num_windows, SEGS, LANES)
    y = np.zeros((plan.num_row_blocks, plan.block_h), np.float64)
    lanes = np.arange(LANES)
    for b in range(plan.num_blocks):
        xb = x2d[plan.block_wins[b], plan.subidx[b], lanes]  # (LANES,)
        y[plan.block_rows[b]] += (
            plan.data[b].astype(np.float64) * xb[None, :]
        ).sum(axis=1)
    return y.reshape(-1)[:R].astype(np.float32)
