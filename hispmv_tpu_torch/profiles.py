"""Device profiles: every number that steers a choice the port makes.

:class:`DeviceProfile` holds the cost model's rates and per-call costs
(``tune/cost.py``), the routed planner's tile costs, the gathered
side-plan's costs, ELLX's ``k_base`` costs, split's hub threshold, the
permutation's cost, the block handle's layout budgets and the banding
budget of the routed grid.  Format limits that are bit-field widths stay
constants of their planners.  Each planner takes a ``profile`` (``V5E``
by default); ``SpmvHandle``, ``prepare``, ``Accelerator``, the layer swap,
``tune`` and the CLI take the profile of their device unless the caller
names one.  ``tune/cost.py`` re-exports these names.

- ``V5E`` holds the JAX package's values, each from the file that keeps
  it there (``hispmv_tpu/tune/cost.py``, ``plan/routed.py``,
  ``plan/gathered.py``, ``plan/permute.py``, ``plan/split.py``,
  ``ops/spmv_ellx.py`` and ``api/handle.py``), so that a plan built under
  ``V5E`` equals the JAX package's array for array.  Its figures describe
  a TPU v5e, not the card.
- ``H100`` holds values measured on an NVIDIA H100 80GB HBM3 (power limit
  beside the literal) by ``python3 kernel_compare.py calibrate``; how each
  field was measured is in ``PERF.md`` (the profile table).

``device_profile(device)`` picks one: ``H100`` on a CUDA device, ``V5E``
on the CPU, where the tests hold the port against the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Calibrated per-device constants (fpgas.py device catalog analog).
    The defaults are ``V5E``'s: the JAX package's values."""

    # -- the JAX package's DeviceProfile (hispmv_tpu/tune/cost.py) --------
    name: str = "tpu-v5e"
    hbm_gbps: float = 794.0  # a 512 MiB read
    stream_efficiency: float = 0.001  # gather-stream format, of hbm_gbps
    block_dma_efficiency: float = 0.88  # contiguous chunk streaming
    block_step_overhead_s: float = 2.8e-8  # chunked kernel, per block
    dense_efficiency: float = 0.90  # dense GEMV, of hbm_gbps
    launch_overhead_s: float = 3e-6  # per kernel call
    vmem_bytes: int = 64 * 2**20  # on-chip memory a kernel may hold
    hbm_bytes: int = 14 * 2**30  # device memory for resident plans
    ellx_gbps: float = 500.0  # ELLX base product, bytes of its arrays
    row_gather_s: float = 1.8e-9  # per row of a row gather
    # -- kept elsewhere in the JAX package --------------------------------
    # windowed block-ELL (tune/cost.py's window_seconds)
    window_dma_efficiency: float = 0.88
    window_step_extra_s: float = 4e-9  # per block, over block_step
    # routed tiles (plan/routed.py): a tile of class (W, l1, lmax) costs
    # base + w*(W-1) + (ov + wl*W)*(l1-1) + bnd*lmax
    tile_base_ns: float = 26.0
    tile_w_ns: float = 1.0
    tile_ov_ns: float = 2.2
    tile_wl_ns: float = 0.4
    tile_bnd_ns: float = 13.3
    residual_ns: float = 16.0  # element scatter, per residual nonzero
    launch_ns: float = 3000.0  # per routed stream
    # the routed handle's residual executor (api/handle.py): element
    # scatter at residual_ns a nonzero below a row-granular ELLX of
    # res_ellx_row_ns a row plus res_ellx_nnz_ns a nonzero
    res_ellx_row_ns: float = 11.0
    res_ellx_nnz_ns: float = 2.5
    # gathered side-plan (plan/gathered.py): launch + tiles*tile +
    # (2*P*K + T)*stage
    gath_tile_ns: float = 44.0
    gath_stage_ns: float = 20.0
    gath_launch_ns: float = 23e3
    # window permutation (plan/permute.py): (2W + 1024)*window + two
    # transposes of W*4 KiB + fixed
    permute_window_ns: float = 18.0
    transpose_ns_per_mb: float = 2600.0
    permute_fixed_ns: float = 3000.0
    # ELLX k_base choice (ops/spmv_ellx.py)
    ellx_choose_bytes_per_s: float = 450e9
    overflow_block_s: float = 4.5e-8
    overflow_launch_s: float = 3e-6
    # split's hub thresholds (plan/split.py): the modelled cost of one
    # body nonzero, in bytes of a dense hub panel
    body_bytes_per_nnz: float = 740.0
    # block handle layouts (api/handle.py): chunked (B1) when x + y + two
    # chunks fit chunked_budget_bytes, else x-paneled (B3) in panels of
    # panel_ncb col blocks, else x- and y-paneled (B4) with y panels of
    # panel_y_bytes; linear through B2 when chunked and a batch's x + y +
    # two chunks fit batched_budget_bytes, else B6
    chunked_budget_bytes: int = 10 * 2**20
    panel_ncb: int = 4096
    panel_y_bytes: int = 1 << 20
    batched_budget_bytes: int = 10 * 2**20
    # routed grid (plan/routed.py::routed_vmem_ok): one routed plan while
    # the pow-2 padded x + y fit this, else the banded cell grid
    routed_band_budget_bytes: int = 8 << 20


# The JAX package's fields, which its tune cache key hashes.
_JAX_FIELDS = 11

# The JAX package's values.
V5E = DeviceProfile()

# Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (torch
# 2.11.0+cu128) by `python3 kernel_compare.py calibrate` through the chip
# tool (its readings: PERF.md, the profile table).  Per-unit costs are
# device-time slopes, per-call costs wall-clock (CUDA events, host gaps
# included, as bench_spmv times a run).  B9's tile costs are fitted over
# the suite plans and synthetic plans that set W, l1 and lmax apart: W
# costs nothing measurable on the card (tile_w_ns, tile_wl_ns 0).  The
# budgets are the rule's best over the layouts timed in turns:
# chunked_budget_bytes keeps TSOPF chunked (B1), the 200,000 x 5,120,000
# matrix x-paneled (B3) and the Flan-sized one tiled (B4), each within 4%
# of its fastest layout; batched_budget_bytes sends TSOPF's batch of 8 to
# B2 and every larger batch to B6.  Where a choice does not exist on the
# card the value says so: routed_band_budget_bytes is hbm_bytes, one
# routed plan of the soc-Pokec stand-in having run 1.77x faster than its
# banded grid; panel_ncb and panel_y_bytes keep the JAX package's values,
# the layouts measured with them; vmem_bytes is read by nothing in the
# port (the field keeps the profile's first fields the JAX tuner's).
H100 = DeviceProfile(
    name="nvidia-h100-80gb-hbm3",
    hbm_gbps=3439.0,
    stream_efficiency=0.1107,
    block_dma_efficiency=0.8764,
    block_step_overhead_s=3.518e-10,
    dense_efficiency=1.0,
    launch_overhead_s=0.000119,
    vmem_bytes=0,
    hbm_bytes=68013994803,
    ellx_gbps=281.3,
    row_gather_s=4.805e-10,
    window_dma_efficiency=0.9312,
    window_step_extra_s=1.254e-09,
    tile_base_ns=3.149,
    tile_w_ns=0.0,
    tile_ov_ns=0.739,
    tile_wl_ns=0.0,
    tile_bnd_ns=2.635,
    residual_ns=0.9306,
    launch_ns=1152.0,
    res_ellx_row_ns=2.441,
    res_ellx_nnz_ns=1.751,
    gath_tile_ns=9.101,
    gath_stage_ns=6.907,
    gath_launch_ns=302800.0,
    permute_window_ns=0.7333,
    transpose_ns_per_mb=2818.0,
    permute_fixed_ns=285700.0,
    ellx_choose_bytes_per_s=281300000000.0,
    overflow_block_s=4.094e-10,
    overflow_launch_s=1.735e-05,
    body_bytes_per_nnz=161.5,
    chunked_budget_bytes=6443936,
    panel_ncb=4096,
    panel_y_bytes=1048576,
    batched_budget_bytes=4537600,
    routed_band_budget_bytes=68013994803,
)

PROFILES = {p.name: p for p in (V5E, H100)}


def device_profile(device) -> DeviceProfile:
    """The profile of ``device`` (a ``torch.device`` or its string):
    ``H100`` on a CUDA device, ``V5E`` on the CPU."""
    kind = getattr(device, "type", None) or str(device).split(":")[0]
    if kind == "cuda":
        return H100
    if kind == "cpu":
        return V5E
    raise ValueError(f"no device profile for {device!r}")


def profile_key(profile: DeviceProfile) -> str:
    """Eight hex digits of the profile's values for a cache key.  A
    profile whose port fields are ``V5E``'s hashes the JAX package's
    fields alone, as the JAX tuner does."""
    vals = dataclasses.astuple(profile)
    if vals[_JAX_FIELDS:] == dataclasses.astuple(V5E)[_JAX_FIELDS:]:
        vals = vals[:_JAX_FIELDS]
    return hashlib.sha256(repr(vals).encode()).hexdigest()[:8]
