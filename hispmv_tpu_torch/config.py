"""Canonical configuration object for a prepared SpMV/GeMV design.

Carried over unchanged from ``hispmv_tpu/config.py`` (numpy and the standard library
only), so that both packages build identical plans.  Original notes follow.

TPU-native analog of the reference's ``SpMVConfig`` dataclass and its
``[Dense-][PA-][HI-]SpMV-A-B-C`` name encoding
(reference automation_tool/src/commons.py:21-78).  Where the reference picks
FPGA channel counts and crossbar options, we pick block geometry, payload
dtype, reordering and the long-row split threshold — the knobs the autotuner
(``hispmv_tpu_torch.tune``, under the device's profile) searches per
matrix.  Every field here is consumed by a
planner, kernel or dispatcher; the config is the complete design record.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SpmvConfig:
    """Static design parameters of one prepared matrix execution plan.

    Attributes:
      sublanes: VPU sublane count of the virtual PE grid (8 for fp32 tiles).
      lanes: VPU lane count of the virtual PE grid (always 128 on TPU).
      split_threshold: rows with more nonzeros than this are split into
        multiple segments processed by different PEs — the "shared row" /
        hybrid-row-distribution analog (spmv-helper.cpp:265-347).  ``None``
        lets the stream planner derive it from the load distribution.
      dense_overlay: if True the handle dispatches to the fused dense GeMV
        path instead of the sparse stream (BUILD_DENSE_OVERLAY analog,
        assets/base_functions.cpp:174-226).
      block_h: block height for the block-ELL formats (rows per dense
        (block_h, 128) sub-block); 8/16/32/64 are natural vreg tiles.
      col_reorder: apply the degree-based column permutation before block
        extraction (densifies power-law matrices; x is permuted at run time).
      min_block_fill: minimum estimated block fill for the "auto" format
        dispatch to pick the block path over the windowed format.
      value_dtype: payload dtype for block streams; "bfloat16" halves A-stream
        bytes in DMA-bound regimes (accumulation stays fp32 in the kernel).
      rank_sort: execute the routed format in rank space — rows/columns
        degree-sorted at plan time so power-law nonzeros concentrate into
        dense tiles, with x permuted in and y permuted out through the
        fast 3-stage permutation kernels (plan/permute.py).  The planner's
        answer to the reference's HI crossbar load balancing
        (base_functions.cpp:356-436) for scale-free matrices.
    """

    sublanes: int = 8
    lanes: int = 128
    split_threshold: Optional[int] = None
    dense_overlay: bool = False
    block_h: int = 8
    col_reorder: bool = False
    min_block_fill: float = 0.125
    value_dtype: str = "float32"
    rank_sort: bool = False

    @property
    def num_pes(self) -> int:
        return self.sublanes * self.lanes

    def __post_init__(self):
        if self.lanes % 128 != 0:
            raise ValueError("lanes must be a multiple of 128 (TPU lane width)")
        if self.block_h < 1:
            raise ValueError("block_h must be >= 1")


def encode_config_name(cfg: SpmvConfig) -> str:
    """Human-readable design name, analog of ``encodeSpMVConfig``
    (automation_tool/src/commons.py:60-78).  Tokens mirror the reference's
    feature flags: Dense = dense overlay, CR = column reorder (the crossbar/
    balancing analog), BF16 = compressed payload."""
    parts = []
    if cfg.dense_overlay:
        parts.append("Dense")
    if cfg.col_reorder:
        parts.append("CR")
    if cfg.rank_sort:
        parts.append("RS")
    if cfg.value_dtype == "bfloat16":
        parts.append("BF16")
    parts.append(f"SpMV-{cfg.num_pes}p-bh{cfg.block_h}")
    return "-".join(parts)
