"""The preprocessor: matrix -> load-balanced, hazard-free lane-stream plan.

Carried over unchanged from ``hispmv_tpu/plan/partition.py`` (numpy and the standard library
only), so that both packages build identical plans.  Original notes follow.

This is the TPU-native re-design of the reference's host preprocessing
pipeline (``balanceWorkload`` -> ``computeTileSize`` -> ``prepareTile``,
common/src/spmv-helper.cpp:265-638).  The reference balances a cyclic row->PE
assignment by demoting dense rows to an all-PE "shared" mode routed through a
hardware crossbar, then out-of-order schedules rows into RAW-hazard-free
slots.  On a TPU the PEs are the 8x128 VPU lane grid, there is no crossbar,
and the accumulator is a vector register — so the same three contracts are
met differently:

1. *Long-row splitting* (shared-row analog): rows with more than
   ``split_threshold`` nonzeros are cut into multiple segments that land on
   different virtual PEs; their partial sums are recombined in finalization.
2. *Global size-sorted rounds* (balancer + scheduler analog): all segments
   are sorted by nonzero count (descending) and packed into "rounds" of
   ``num_pes`` segments, one per PE.  A round executes
   ``max(segment sizes in round)`` steps; sorting makes sizes within a round
   nearly equal, so padding waste is small for any degree of row imbalance —
   this single sort replaces the reference's greedy per-tile balancer.
3. *Static conflict-free accumulation* (RAW/dependence analog): within a
   round every PE accumulates exactly one segment into its own lane slot, so
   the kernel's inner loop is a plain fused multiply-add with no scatter and
   no cross-lane conflicts; round boundaries are the only flush points.

Plan layout (P = num_pes, T = total steps, E = number of rounds, R = rows):

- ``vals``  f32 [T, P] — nonzero values, zero-padded.
- ``cols``  i32 [T, P] — column index per value (0 for padding).
- ``round_starts`` i32 [E+1] — step offsets of each round.
- ``seg_rows`` i32 [E*P] — destination row of each (round, pe) partial sum;
  the dummy row ``R`` absorbs padding PEs.
- finalize: ``y = scatter_add(zeros(R+1), seg_rows, acc.ravel())[:R]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from hispmv_tpu_torch.config import SpmvConfig
from hispmv_tpu_torch.formats.matrix import COOMatrix


@dataclasses.dataclass
class StreamPlan:
    """A prepared, device-ready execution plan for one matrix."""

    config: SpmvConfig
    shape: tuple
    nnz: int

    vals: np.ndarray  # f32 [T, P]
    cols: np.ndarray  # i32 [T, P]
    round_starts: np.ndarray  # i32 [E + 1]
    seg_rows: np.ndarray  # i32 [E * P]

    # Provenance / stats
    num_segments: int
    split_threshold: int

    @property
    def num_steps(self) -> int:
        return int(self.vals.shape[0])

    @property
    def num_rounds(self) -> int:
        return int(len(self.round_starts) - 1)

    @property
    def padding_ratio(self) -> float:
        """Fraction of stream slots that are padding (lower is better)."""
        total = self.vals.size
        return 1.0 - self.nnz / total if total else 0.0

    @property
    def stream_bytes(self) -> int:
        return self.vals.nbytes + self.cols.nbytes

    def round_ids(self) -> np.ndarray:
        """Round id per step, i32 [T] (non-decreasing)."""
        steps = np.diff(self.round_starts)
        return np.repeat(
            np.arange(self.num_rounds, dtype=np.int32), steps
        )


def derive_split_threshold(nnz: int, num_pes: int) -> int:
    """Default long-row split threshold.

    ``ceil(nnz / P)`` is the perfectly balanced per-PE load; rows longer than
    that would serialize a round, so they are split into ~balanced pieces.
    The floor of 32 keeps tiny matrices from fragmenting into confetti
    (reference keeps a 10%-improvement guard instead,
    spmv-helper.cpp:341-344).
    """
    return max(-(-nnz // num_pes), 32)


def build_plan(
    coo: COOMatrix,
    config: Optional[SpmvConfig] = None,
) -> StreamPlan:
    """Build the lane-stream plan for a COO matrix (numpy, vectorized)."""
    config = config or SpmvConfig()
    P = config.num_pes
    R, C = coo.shape
    nnz = coo.nnz

    if nnz == 0:
        return StreamPlan(
            config=config,
            shape=(R, C),
            nnz=0,
            vals=np.zeros((0, P), np.float32),
            cols=np.zeros((0, P), np.int32),
            round_starts=np.zeros(1, np.int32),
            seg_rows=np.zeros(0, np.int32),
            num_segments=0,
            split_threshold=config.split_threshold or 32,
        )

    sorted_coo = coo.sorted_by_row()
    row_len = np.bincount(sorted_coo.rows, minlength=R).astype(np.int64)
    csr_ptr = np.zeros(R + 1, np.int64)
    np.cumsum(row_len, out=csr_ptr[1:])

    thresh = config.split_threshold or derive_split_threshold(nnz, P)

    # --- 1. Segment rows: row r -> ceil(len/thresh) segments of <= thresh.
    nz_rows = np.nonzero(row_len)[0]
    nz_len = row_len[nz_rows]
    n_splits = -(-nz_len // thresh)  # ceil
    num_segments = int(n_splits.sum())

    seg_row = np.repeat(nz_rows, n_splits)  # row of each segment
    # offset of each segment within its row's CSR range
    first_of_row = np.cumsum(n_splits) - n_splits
    within = np.arange(num_segments, dtype=np.int64) - np.repeat(
        first_of_row, n_splits
    )
    seg_start = csr_ptr[seg_row] + within * thresh
    seg_len = np.minimum(
        csr_ptr[seg_row] + row_len[seg_row] - seg_start, thresh
    ).astype(np.int64)

    # --- 2. Sort segments by size descending (stable) and pack into rounds.
    order = np.argsort(-seg_len, kind="stable")
    seg_row = seg_row[order]
    seg_start = seg_start[order]
    seg_len = seg_len[order]

    E = -(-num_segments // P)  # rounds
    # steps per round = size of its largest (= first) segment
    round_steps = seg_len[np.arange(E) * P]
    round_starts = np.zeros(E + 1, np.int64)
    np.cumsum(round_steps, out=round_starts[1:])
    T = int(round_starts[-1])

    # --- 3. Scatter nonzeros into the [T, P] stream.
    seg_round = np.arange(num_segments, dtype=np.int64) // P
    seg_pe = np.arange(num_segments, dtype=np.int64) % P

    # source index of nonzero k (grouped by segment, in-segment order)
    total = int(seg_len.sum())
    seg_cum = np.cumsum(seg_len) - seg_len
    in_seg = np.arange(total, dtype=np.int64) - np.repeat(seg_cum, seg_len)
    src = np.repeat(seg_start, seg_len) + in_seg
    # destination flat index = (round_start + in_seg_offset) * P + pe
    dst = (
        np.repeat(round_starts[seg_round], seg_len) + in_seg
    ) * P + np.repeat(seg_pe, seg_len)

    vals = np.zeros(T * P, np.float32)
    cols = np.zeros(T * P, np.int32)
    vals[dst] = sorted_coo.values[src]
    cols[dst] = sorted_coo.cols[src]

    # --- 4. Finalization map: (round, pe) -> row; dummy row R for padding.
    seg_rows = np.full(E * P, R, np.int32)
    seg_rows[seg_round * P + seg_pe] = seg_row.astype(np.int32)

    return StreamPlan(
        config=config,
        shape=(R, C),
        nnz=nnz,
        vals=vals.reshape(T, P),
        cols=cols.reshape(T, P),
        round_starts=round_starts.astype(np.int32),
        seg_rows=seg_rows,
        num_segments=num_segments,
        split_threshold=int(thresh),
    )
