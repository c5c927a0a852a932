"""Split planner: hub columns and hub rows as dense panels, the rest as a
routed or ELLX body.

Carried over from ``hispmv_tpu/plan/split.py`` (numpy only).  The hub
thresholds and the body's format weigh the costs of a ``DeviceProfile``
(``tune/cost.py``); under ``V5E``, the JAX package's values, both
packages build identical plans and pick the same body.  The port runs the parts as the
JAX handle does: the hub panels as fp32 matmuls with TF32 off, the body
through the routed stream kernel (B9) or the ELLX base product plus the
block stream (B1, B2 against a batch).

    A = Hc + Hr + B

- ``Hc``: columns whose degree makes a dense column cheaper than sparse
  units ("hub columns"), stored dense [R_pad, kc_pad]; ``y += Hc @
  x[hub_cols]``.
- ``Hr``: of the remaining nonzeros, rows dense enough that a dense row
  costs less than its scattered units ("hub rows"), stored dense
  [kr_pad, C_pad]; ``y[hub_rows] += Hr @ x``.
- ``B``: everything else, the balanced body.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from hispmv_tpu_torch.formats.matrix import COOMatrix
from hispmv_tpu_torch.ops.spmv_ellx import (
    EllxPlan,
    build_ellx_plan,
    choose_k_base,
    ellx_matvec_numpy,
)
from hispmv_tpu_torch.plan.blocks import LANES, build_block_plan
from hispmv_tpu_torch.plan.routed import (
    best_routed_estimate,
    build_routed_plan,
    routed_matvec_numpy,
    routed_vmem_ok,
)
from hispmv_tpu_torch.profiles import V5E, DeviceProfile

_MAX_HUBS = 2048


@dataclasses.dataclass
class SplitPlan:
    shape: tuple
    nnz: int
    block_h: int
    hub_col_idx: Optional[np.ndarray]  # i32 [kc]
    hub_col_dense: Optional[np.ndarray]  # f32 [R_pad, kc_pad]
    hub_row_idx: Optional[np.ndarray]  # i32 [kr]
    hub_row_dense: Optional[np.ndarray]  # f32 [kr_pad, C_pad]
    body: Optional[object]  # EllxPlan or plan.routed.RoutedPlan

    @property
    def device_bytes(self) -> int:
        n = 0
        if self.hub_col_dense is not None:
            n += self.hub_col_dense.nbytes
        if self.hub_row_dense is not None:
            n += self.hub_row_dense.nbytes
        if isinstance(self.body, EllxPlan):
            n += self.body.base_bytes
            if self.body.overflow is not None:
                n += self.body.overflow.data.nbytes
        elif self.body is not None:  # RoutedPlan
            n += self.body.stream_bytes
        return n

    @property
    def stats(self) -> dict:
        d = {
            "kc": 0 if self.hub_col_idx is None else len(self.hub_col_idx),
            "kr": 0 if self.hub_row_idx is None else len(self.hub_row_idx),
            "body_nnz": 0 if self.body is None else self.body.nnz,
            "body_fmt": (
                "none" if self.body is None
                else ("ellx" if isinstance(self.body, EllxPlan) else "routed")
            ),
        }
        if isinstance(self.body, EllxPlan):
            d["body_k"] = self.body.k_base
            d["body_overflow"] = self.body.overflow_blocks
        return d


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def _pick_body_format(body: COOMatrix,
                      profile: DeviceProfile = V5E) -> str:
    """Routed when the macro-cell estimate beats the ELLX base pass, both
    under ``profile``."""
    p = profile
    R, C = body.shape
    if not routed_vmem_ok(body.shape, p):
        return "ellx"
    est = best_routed_estimate(body.rows, body.cols, body.shape, profile=p)
    t_routed = est["est_ns"] * 1e-9 + min(
        est["residual"] * p.residual_ns * 1e-9,
        R * 516 / p.ellx_choose_bytes_per_s
    )
    uk = np.unique(
        body.rows.astype(np.int64) * (C // 128 + 1) + body.cols // 128
    )
    counts = np.bincount(
        (uk // (C // 128 + 1)).astype(np.int64), minlength=R
    )
    k = choose_k_base(counts, 1, p)
    ov = int(np.maximum(counts - k, 0).sum())
    t_ellx = R * k * 516 / p.ellx_choose_bytes_per_s + ov * p.overflow_block_s
    return "routed" if est["tiles"] and t_routed < t_ellx else "ellx"


def build_split_plan(
    coo: COOMatrix,
    block_h: int = 1,
    body_format: str = "auto",  # "auto" | "ellx" | "routed"
    profile: DeviceProfile = V5E,
) -> SplitPlan:
    """Split A by degree thresholds, then plan the body (routed when its
    (band, window) group structure is tile-friendly, else ELLX), all
    under ``profile``."""
    bpn = profile.body_bytes_per_nnz
    R, C = coo.shape
    rows, cols, vals = coo.rows, coo.cols, coo.values

    # hub columns: a dense column costs R_pad*4 B, a sparse one deg *
    # body_bytes_per_nnz; densify when sparse would cost more
    col_deg = np.bincount(cols, minlength=C)
    thresh_c = max(_pad(R, 8) * 4.0 / bpn, 4.0)
    hub_c = np.nonzero(col_deg > thresh_c)[0]
    if len(hub_c) > _MAX_HUBS:
        hub_c = hub_c[np.argsort(-col_deg[hub_c], kind="stable")[:_MAX_HUBS]]
        hub_c.sort()
    in_hc = np.zeros(C, bool)
    in_hc[hub_c] = True
    nnz_hc = in_hc[cols]

    # hub rows among the remaining nonzeros
    rest = ~nnz_hc
    row_deg = np.bincount(rows[rest], minlength=R)
    thresh_r = max(_pad(C, LANES) * 4.0 / bpn, 4.0)
    hub_r = np.nonzero(row_deg > thresh_r)[0]
    if len(hub_r) > _MAX_HUBS:
        hub_r = hub_r[np.argsort(-row_deg[hub_r], kind="stable")[:_MAX_HUBS]]
        hub_r.sort()
    in_hr = np.zeros(R, bool)
    in_hr[hub_r] = True
    nnz_hr = rest & in_hr[rows]

    body_sel = rest & ~nnz_hr

    hub_col_idx = hub_col_dense = None
    if len(hub_c):
        hub_col_dense = np.zeros((_pad(R, 8), _pad(len(hub_c), LANES)),
                                 np.float32)
        pos = np.searchsorted(hub_c, cols[nnz_hc])  # hub_c is sorted
        np.add.at(hub_col_dense, (rows[nnz_hc], pos), vals[nnz_hc])
        hub_col_idx = hub_c.astype(np.int32)

    hub_row_idx = hub_row_dense = None
    if len(hub_r):
        hub_row_dense = np.zeros((_pad(len(hub_r), 8), _pad(C, LANES)),
                                 np.float32)
        pos = np.searchsorted(hub_r, rows[nnz_hr])
        np.add.at(hub_row_dense, (pos, cols[nnz_hr]), vals[nnz_hr])
        hub_row_idx = hub_r.astype(np.int32)

    body = None
    if body_sel.any():
        body_coo = COOMatrix(
            coo.shape, rows[body_sel], cols[body_sel], vals[body_sel]
        )
        fmt = body_format
        if fmt == "auto":
            fmt = _pick_body_format(body_coo, profile)
        if fmt == "routed":
            body = build_routed_plan(body_coo, profile=profile)
        else:
            body = build_ellx_plan(
                build_block_plan(body_coo, block_h=block_h), profile=profile
            )

    return SplitPlan(
        shape=coo.shape,
        nnz=coo.nnz,
        block_h=block_h,
        hub_col_idx=hub_col_idx,
        hub_col_dense=hub_col_dense,
        hub_row_idx=hub_row_idx,
        hub_row_dense=hub_row_dense,
        body=body,
    )


def split_matvec_numpy(plan: SplitPlan, x: np.ndarray) -> np.ndarray:
    """Golden numpy executor (float64 sums, float32 out), for tests."""
    R, C = plan.shape
    y = np.zeros(R, np.float64)
    if plan.hub_col_dense is not None:
        xh = x[plan.hub_col_idx].astype(np.float64)
        kc = len(plan.hub_col_idx)
        y += plan.hub_col_dense[:R, :kc].astype(np.float64) @ xh
    if plan.hub_row_dense is not None:
        yr = plan.hub_row_dense[: len(plan.hub_row_idx), :C].astype(
            np.float64
        ) @ x.astype(np.float64)
        y[plan.hub_row_idx] += yr
    if isinstance(plan.body, EllxPlan):
        y += ellx_matvec_numpy(plan.body, x.astype(np.float32)).astype(
            np.float64
        )
    elif plan.body is not None:  # RoutedPlan (its residual included)
        y += routed_matvec_numpy(plan.body, x.astype(np.float32)).astype(
            np.float64
        )
    return y.astype(np.float32)
