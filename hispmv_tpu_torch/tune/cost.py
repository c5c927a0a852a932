"""Analytic cost model for the SpMV formats.

Carried over unchanged from ``hispmv_tpu/tune/cost.py`` (the standard
library only).  Its rates and per-call costs are a :class:`DeviceProfile`'s
(``hispmv_tpu_torch/profiles.py``, whose names this module re-exports):
under ``V5E`` every figure is the JAX package's TPU estimate, under
``H100`` an estimate of the card.  Original notes follow.

Re-creation of the reference's estimator pair for a TPU target:

- ``ResourceEstimator`` (automation_tool/src/resource_est.py) asked "does
  this design fit the FPGA?"; the TPU analogs are VMEM footprint and HBM
  residency checks.
- ``CycleCountEstimator`` (automation_tool/src/cyclecount_est.py:51-55:
  ``CC = streamA + tiles_r*loadB + updateC``) asked "how long will it run?";
  every format is bandwidth-bound, so cost = bytes moved / effective
  bandwidth + a fixed launch overhead, with per-format effective
  bandwidths calibrated on hardware (the DATA_CLK analog).
"""

from __future__ import annotations

from hispmv_tpu_torch.profiles import (  # noqa: F401
    H100,
    PROFILES,
    V5E,
    DeviceProfile,
    device_profile,
    profile_key,
)


class CostModel:
    """Predict per-run seconds for each format from plan statistics."""

    def __init__(self, profile: DeviceProfile = V5E):
        self.p = profile

    # -- per-format costs -------------------------------------------------

    def stream_seconds(
        self, num_steps: int, num_pes: int, rows: int, cols: int
    ) -> float:
        """Gather/segment-sum path: 8 B per stream slot (val + col id) plus
        x gather traffic and y finalize."""
        stream_bytes = num_steps * num_pes * 8
        x_bytes = cols * 4  # gathered roughly once (VMEM-cached window)
        y_bytes = rows * 4
        eff = self.p.hbm_gbps * 1e9 * self.p.stream_efficiency
        return (stream_bytes + x_bytes + y_bytes) / eff + self.p.launch_overhead_s

    def block_seconds(
        self, num_blocks: int, block_h: int, rows: int, cols: int
    ) -> float:
        """Chunked block-ELL path: max(DMA stream time, per-block fixed
        overhead) — on the TPU the kernel is compute(overhead)-bound below
        block_h~44 and DMA-bound above."""
        a_bytes = num_blocks * block_h * 128 * 4
        xy_bytes = cols * 4 + rows * 4
        t_dma = (a_bytes + xy_bytes) / (
            self.p.hbm_gbps * 1e9 * self.p.block_dma_efficiency
        )
        t_step = num_blocks * self.p.block_step_overhead_s
        return max(t_dma, t_step) + self.p.launch_overhead_s

    def window_seconds(
        self, num_blocks: int, block_h: int, rows: int, cols: int
    ) -> float:
        """Windowed block-ELL: payload + int32 sub-index sideband; per-block
        overhead slightly above the plain path (one extra gather)."""
        a_bytes = num_blocks * (block_h * 128 + 128) * 4
        xy_bytes = cols * 4 + rows * 4
        t_dma = (a_bytes + xy_bytes) / (
            self.p.hbm_gbps * 1e9 * self.p.window_dma_efficiency
        )
        t_step = num_blocks * (
            self.p.block_step_overhead_s + self.p.window_step_extra_s)
        return max(t_dma, t_step) + self.p.launch_overhead_s

    def block_seconds_bf16(
        self, num_blocks: int, block_h: int, rows: int, cols: int
    ) -> float:
        """bf16-compressed payload: half the A bytes, same per-block cost."""
        a_bytes = num_blocks * block_h * 128 * 2
        xy_bytes = cols * 4 + rows * 4
        t_dma = (a_bytes + xy_bytes) / (
            self.p.hbm_gbps * 1e9 * self.p.block_dma_efficiency
        )
        t_step = num_blocks * self.p.block_step_overhead_s
        return max(t_dma, t_step) + self.p.launch_overhead_s

    def window_seconds_bf16(
        self, num_blocks: int, block_h: int, rows: int, cols: int
    ) -> float:
        a_bytes = num_blocks * (block_h * 128 * 2 + 128 * 4)
        xy_bytes = cols * 4 + rows * 4
        t_dma = (a_bytes + xy_bytes) / (
            self.p.hbm_gbps * 1e9 * self.p.window_dma_efficiency
        )
        t_step = num_blocks * (
            self.p.block_step_overhead_s + self.p.window_step_extra_s)
        return max(t_dma, t_step) + self.p.launch_overhead_s

    def window_resident_bytes(self, num_blocks: int, block_h: int) -> int:
        return num_blocks * ((block_h * 128 + 128) * 4 + 16)

    def ellx_seconds(
        self,
        base_bytes: int,
        overflow_blocks: int,
        rows: int,
        cols: int,
        value_bytes: int = 4,
    ) -> float:
        """Base-K ELL product + optional overflow block stream (B1)."""
        scale = value_bytes / 4.0
        t = (
            base_bytes * scale + cols * 4 + rows * 4
        ) / (self.p.ellx_gbps * 1e9)
        if overflow_blocks:
            t += (
                self.p.launch_overhead_s
                + overflow_blocks * self.p.block_step_overhead_s
            )
        return t + self.p.launch_overhead_s

    def routed_seconds(
        self,
        compute_ns: float,
        stream_bytes: int,
        residual_nnz: int,
        rows: int,
        cols: int,
    ) -> float:
        """Routed-stream kernel: max(per-tile compute from the layered
        cost model (plan/routed.py::estimate_routed_cost_ns or
        plan_cost_ns), stream DMA) + residual ELLX (row-granular base over
        the full row space, k=1)."""
        t = max(
            compute_ns * 1e-9,
            stream_bytes / (self.p.hbm_gbps * 1e9 * self.p.block_dma_efficiency),
        ) + self.p.launch_overhead_s
        if residual_nnz:
            # small residual -> element scatter (residual_ns); large ->
            # row-granular ELLX (base over the full row space + overflow
            # for rows with multiple residual units)
            t_ellx = rows * (128 * 4 + 4) / (self.p.ellx_gbps * 1e9)
            t_ellx += max(residual_nnz - rows, 0) * self.p.block_step_overhead_s
            t += min(residual_nnz * self.p.residual_ns * 1e-9, t_ellx)
        return t

    def split_seconds(
        self,
        hub_bytes: int,
        body_base_bytes: int,
        body_overflow_blocks: int,
        rows: int,
        cols: int,
        value_bytes: int = 4,
    ) -> float:
        """Hub-dense panels at DMA rate + ELLX body."""
        scale = value_bytes / 4.0
        t = hub_bytes * scale / (
            self.p.hbm_gbps * 1e9 * self.p.dense_efficiency
        )
        return t + self.ellx_seconds(
            body_base_bytes, body_overflow_blocks, rows, cols, value_bytes
        )

    def dense_seconds(self, rows: int, cols: int) -> float:
        rp, cp = -(-rows // 8) * 8, -(-cols // 128) * 128
        a_bytes = rp * cp * 4
        eff = self.p.hbm_gbps * 1e9 * self.p.dense_efficiency
        return (a_bytes + cp * 4 + rp * 4) / eff + self.p.launch_overhead_s

    # -- residency checks (ResourceEstimator analog) ----------------------

    def block_resident_bytes(self, num_blocks: int, block_h: int) -> int:
        return num_blocks * (block_h * 128 * 4 + 16)

    def stream_resident_bytes(self, num_steps: int, num_pes: int) -> int:
        return num_steps * num_pes * 8

    def dense_resident_bytes(self, rows: int, cols: int) -> int:
        return (-(-rows // 8) * 8) * (-(-cols // 128) * 128) * 4

    def fits(self, resident_bytes: int) -> bool:
        return resident_bytes <= self.p.hbm_bytes
