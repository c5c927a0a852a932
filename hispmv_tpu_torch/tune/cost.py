"""Analytic cost model for the TPU SpMV formats.

Carried over unchanged from ``hispmv_tpu/tune/cost.py`` (the standard
library only), so that the port's model-only pick equals the JAX tuner's.
Every constant here is the TPU v5e's, and every figure this model gives
is a TPU estimate, never a time on the card; an H100 profile waits for
calibration runs (ROADMAP.md, queue A).  Measured tuning
(``tune(measure=N)``) times its shortlist on the card instead.  Original
notes follow.

Re-creation of the reference's estimator pair for a TPU target:

- ``ResourceEstimator`` (automation_tool/src/resource_est.py) asked "does
  this design fit the FPGA?"; the TPU analogs are VMEM footprint and HBM
  residency checks.
- ``CycleCountEstimator`` (automation_tool/src/cyclecount_est.py:51-55:
  ``CC = streamA + tiles_r*loadB + updateC``) asked "how long will it run?";
  on a TPU every format is HBM-bandwidth-bound, so cost = bytes moved /
  effective bandwidth + a fixed launch overhead, with per-format effective
  bandwidths calibrated on hardware (the DATA_CLK analog).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Calibrated per-chip constants (fpgas.py device catalog analog).

    All defaults are MEASURED on the TPU v5e via the loop-slope method
    (2026-08, see tests/test_tune.py and the bench logs):

    - ``hbm_gbps`` 794 from a 512 MiB reduction (spec 819).
    - ``block_step_overhead_s`` 28 ns: the chunked kernel's per-block cost
      is ~constant in block_h (scalar reads + dynamic slices + predicate
      dominate; the FMA vregs are hidden underneath) — measured 26.6/26.8/
      28.7 ns at block_h 8/16/32 on nd6k-class streams.
    - ``stream_efficiency`` 0.002: XLA's per-element gather on this chip is
      catastrophic (~0.07-0.13 Gnnz/s end to end), so the gather-stream
      format essentially never wins; it is kept for CPU/debug paths.
    """

    name: str = "tpu-v5e"
    hbm_gbps: float = 794.0
    stream_efficiency: float = 0.001
    block_dma_efficiency: float = 0.88  # contiguous chunk streaming
    block_step_overhead_s: float = 2.8e-8
    dense_efficiency: float = 0.90  # plain matmul row streaming
    launch_overhead_s: float = 3e-6  # on-device dispatch per kernel
    vmem_bytes: int = 64 * 2**20  # usable VMEM ceiling (conservative)
    hbm_bytes: int = 14 * 2**30  # usable HBM for resident plans
    # fused XLA ELL executor (gather+multiply+reduce in one HBM pass):
    # measured 437-684 GB/s on the v5e (2026-08 round-2 microbench)
    ellx_gbps: float = 500.0
    # per-row cost of jnp.take(axis=0) row gathers (0.55 G rows/s measured)
    row_gather_s: float = 1.8e-9
    # routed-stream per-tile/per-layer costs live in plan/routed.py
    # (TILE_BASE_NS/TILE_L1_NS/TILE_BND_NS, loop-slope measured); the
    # cost model consumes the resulting compute-ns estimate directly.


# Default profile used when no calibration file exists.
V5E = DeviceProfile()


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
        overhead) — the kernel is compute(overhead)-bound below block_h~44
        and DMA-bound above (measured, see DeviceProfile)."""
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
            self.p.hbm_gbps * 1e9 * self.p.block_dma_efficiency
        )
        t_step = num_blocks * (self.p.block_step_overhead_s + 4e-9)
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
            self.p.hbm_gbps * 1e9 * self.p.block_dma_efficiency
        )
        t_step = num_blocks * (self.p.block_step_overhead_s + 4e-9)
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
        """Pure-XLA base-K ELL pass + optional Pallas overflow stream."""
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
            # small residual -> element scatter (~16 ns/nnz); large ->
            # row-granular ELLX (base over the full row space + overflow
            # for rows with multiple residual units)
            t_ellx = rows * (128 * 4 + 4) / (self.p.ellx_gbps * 1e9)
            t_ellx += max(residual_nnz - rows, 0) * self.p.block_step_overhead_s
            t += min(residual_nnz * 1.6e-8, t_ellx)
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
