"""Prepare-once / run-many execution handles on PyTorch.

Port of ``hispmv_tpu/api/handle.py`` for every format: ``auto``,
``dense``, ``block``, ``window``, ``ellx``, ``stream``, ``routed``
(original space, rank space with ``SpmvConfig(rank_sort=True)``, and the
banded cell grid for matrices that fail ``routed_vmem_ok``) and ``split``
(hub columns and rows as dense fp32 panels, the body routed or ELLX):

- :class:`SpmvHandle` holds one prepared matrix as device tensors in
  ``_d`` (same key names as the JAX package) and runs
  ``y = alpha * A @ x + beta * y_in`` (``run``) and the batched layer
  ``y[B, R] = x[B, C] @ A.T + bias`` (``linear``);
- :func:`choose_format` is the same structural dispatch;
- :class:`Accelerator` keeps many handles resident and runs the selected
  one, or any one's ``linear``.

The runners are eager Python on explicit tensors: no jit, no interpret
mode and no runner cache per batch size.  Every choice a handle makes
comes from its ``profile`` (``tune/cost.py``; None: its device's,
``H100`` on the card, ``V5E`` on the CPU): the planners' costs, and the
block format's layout dispatch by ``chunked_budget_bytes``,
``panel_ncb`` and ``panel_y_bytes`` (under ``V5E`` the JAX handle's
values, so both packages build the same arrays and run the same
kernels): ``run`` takes B1 (chunked), B3 (x-paneled) or B4 (x- and
y-paneled), and ``linear`` B2 when the handle is chunked and a batch's x +
y fit ``batched_budget_bytes``, else B6 on per-block arrays uploaded once.
Every handle lives on one ``device`` (default ``"cuda"``); it never moves
to the CPU on its own.  On a CPU device the kernel wrappers run their
plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from hispmv_tpu_torch.config import SpmvConfig
from hispmv_tpu_torch.formats.matrix import COOMatrix
from hispmv_tpu_torch.ops.gemv import gemv
from hispmv_tpu_torch.ops.permute import (
    pack_permute_into,
    panel_permute_apply_from,
)
from hispmv_tpu_torch.ops.spmv_block import spmv_block_batched, \
    upload_block_plan
from hispmv_tpu_torch.ops.spmv_chunked import (
    chunk_for,
    pack_chunks,
    pack_chunks_paneled,
    pack_chunks_tiled,
    spmv_chunked,
    spmv_chunked_batched,
    spmv_chunked_paneled,
    spmv_chunked_tiled,
    tiled_sector_mask,
)
from hispmv_tpu_torch.ops.spmv_ellx import (
    EllxPlan,
    build_ellx_plan,
    ellx_matvec,
    ellx_matvec_batched,
)
from hispmv_tpu_torch.ops.spmv_ref import spmv_ref
from hispmv_tpu_torch.ops.spmv_gathered import (
    gathered_gather_apply,
    pack_gathered,
    spmv_gathered_tiles,
)
from hispmv_tpu_torch.ops.spmv_routed import (
    pack_stream,
    routed_table,
    spmv_routed_stream_batched,
    spmv_routed_streams,
    stream_array_names,
    stream_runs,
)
from hispmv_tpu_torch.ops.spmv_windowed import (
    chunk_for_windowed,
    pack_window_chunks,
    spmv_windowed,
    spmv_windowed_batched,
)
from hispmv_tpu_torch.plan.blocks import (
    LANES,
    BlockPlan,
    build_block_plan,
    degree_column_perm,
)
from hispmv_tpu_torch.plan.partition import StreamPlan, build_plan
from hispmv_tpu_torch.plan.permute import build_permute_plan
from hispmv_tpu_torch.plan.routed import (
    WINDOW,
    BandedRoutedPlan,
    RoutedPlan,
    build_banded_routed_plan,
    build_ranked_routed_plan,
    build_routed_plan,
    routed_vmem_ok,
)
from hispmv_tpu_torch.plan.split import SplitPlan, build_split_plan
from hispmv_tpu_torch.plan.windows import SEGS, WindowPlan, build_window_plan
from hispmv_tpu_torch.profiles import DeviceProfile, device_profile
from hispmv_tpu_torch.utils.device import resolve_device
from hispmv_tpu_torch.utils.errors import error_stats
from hispmv_tpu_torch.utils.trace import recording, span, traced


def _extend_perm(col_perm: np.ndarray, num_cols: int, target: int) -> np.ndarray:
    """Identity-extend a column permutation to ``target`` padded entries so
    the runner can gather padded x in one index_select."""
    return np.concatenate(
        [np.asarray(col_perm, np.int32),
         np.arange(num_cols, target, dtype=np.int32)]
    )


def _stream_packed(d, prefix, i, dims):
    """The device arrays of routed stream ``i`` in ``pack_stream`` order."""
    p = prefix + f"s{i}_"
    return tuple(d[p + n] for n in stream_array_names(dims[4])) + (
        d[p + "base"], d[p + "byt"])


def _residual_dict(d, prefix):
    """The row-granular ELLX residual's arrays under ``ellx_matvec`` names."""
    rd = {"base_data": d[prefix + "r_base_data"],
          "base_cols": d[prefix + "r_base_cols"]}
    if (prefix + "r_odata") in d:
        rd["odata"] = d[prefix + "r_odata"]
        rd["ometa"] = d[prefix + "r_ometa"]
        rd["ov_expand"] = d[prefix + "r_ov_expand"]
    return rd


def _run_routed_part(d, x, R, meta, prefix):
    """Execute a routed plan (+ its residual) from device dict ``d`` under
    key ``prefix``; returns y[:R].  The gathered side-plan (when there is
    one) runs first, then one B9 launch runs every cost-class stream of the
    part's table, adding into the side-plan's y tiles (or zeros).  A banded
    meta dispatches to the cell grid; a rank-space meta permutes x in and y
    out through B11."""
    if meta.get("cells") is not None:
        return _run_routed_banded(d, x, R, meta, prefix)
    if meta["xperm"] is not None:
        x = panel_permute_apply_from(d, meta["xperm"], prefix + "xp", x)
    need = meta["nwin"] * WINDOW
    if x.shape[0] < need:
        x = torch.nn.functional.pad(x, (0, need - x.shape[0]))
    x2d = x.reshape(-1, LANES)
    y2d = None
    gm = meta["gathered"]
    if gm is not None:  # the gathered side-plan: B12, B11 twice, B13
        # its K x windows are num_windows rounded up to a power of two
        kw = gm["K"] * WINDOW
        xk = torch.nn.functional.pad(x[:kw], (0, max(kw - x.shape[0], 0)))
        xg = gathered_gather_apply(d, gm, prefix + "g_", xk.reshape(-1, LANES))
        y2d = spmv_gathered_tiles(d[prefix + "g_vals"], d[prefix + "g_word"],
                                  d[prefix + "g_byt"], xg, meta["nyt"],
                                  gm["nch"], gm["tchunk"])
    if meta["table"] is not None:
        y2d = spmv_routed_streams(meta["table"], x2d, y2d)
    if y2d is None:
        y = x.new_zeros(R)
    else:
        y = y2d.reshape(-1)[:R]
    with span("residual"):
        if meta["res_coo"]:  # small residual: element scatter
            contrib = d[prefix + "r_vals"] * x.index_select(
                0, d[prefix + "r_cols"])
            y = y.index_add(0, d[prefix + "r_rows"], contrib)
        if meta["res"] is not None:  # large residual: row-granular ELLX (B1)
            yr = ellx_matvec(_residual_dict(d, prefix), x2d,
                             meta["res"].num_row_blocks, 1, meta["rchunk"],
                             meta["res_ov"])
            y = y + yr.reshape(-1)[:R]
    if meta["yperm"] is not None:
        y = panel_permute_apply_from(d, meta["yperm"], prefix + "yp", y)
    return y


def _run_routed_vectors(d, xb, R, meta, prefix):
    """``linear`` of a routed part one vector at a time: ``xb`` [B, C'] ->
    y [B, R], one :func:`_run_routed_part` a vector."""
    return torch.stack([_run_routed_part(d, xb[b], R, meta, prefix)
                        for b in range(xb.shape[0])])


def _routed_runs_b10(meta) -> bool:
    """Whether ``linear`` of a routed part runs B10: original space, with
    no cell grid and no gathered side-plan.  Banded grids slice x per
    cell, rank space permutes each vector (B11) and a gathered side-plan
    gathers each vector (B12, B11): those go one vector at a time, as the
    JAX package does."""
    return (meta.get("cells") is None and meta["xperm"] is None
            and meta["gathered"] is None)


def _run_routed_batched(d, xb, R, meta):
    """``linear`` of a routed plan in original space, vector-minor from x
    to y: x padded and laid out as xt [nwin*8, 128, B] in one copy, every
    stream added into one y [nyt*1024, B] by one B10 launch for the whole
    batch, then the COO residual as one scatter of rows and the ELLX
    residual through B2 at bh 1, both into that y.  ``xb`` [B, C] (any
    strides; C up to nwin*1024) -> y [B, R], a transposed view."""
    B, C = xb.shape
    with span("transpose"):  # vector-minor and padded: one copy, shared
        xt = xb.new_empty((meta["nwin"] * WINDOW, B))
        xt[:C] = xb.T
        xt[C:] = 0
        xt = xt.view(-1, LANES, B)
    y = xb.new_zeros((meta["nyt"] * WINDOW, B))
    for i, dims in enumerate(meta["streams"]):
        spmv_routed_stream_batched(_stream_packed(d, "", i, dims), dims, xt,
                                   y, meta["lts"][i], meta["runs"][i])
    y = y[:R]
    with span("residual"):
        if meta["res_coo"]:
            contrib = d["r_vals"][:, None] * xt.view(-1, B).index_select(
                0, d["r_cols"])
            y.index_add_(0, d["r_rows"], contrib)
        if meta["res"] is not None:
            yr = ellx_matvec_batched(_residual_dict(d, ""), xt,
                                     meta["res"].num_row_blocks, 1,
                                     meta["rchunk"], meta["res_ov"])
            y += yr.reshape(-1, B)[:R]
    return y.T


def _run_routed_banded(d, x, R, meta, prefix):
    """Execute a banded routed plan: per-cell streams over slices of x,
    panel results summed into each row band, bands concatenated.  The
    rank-space sandwich (when present) wraps the whole grid."""
    if meta["xperm"] is not None:
        x = panel_permute_apply_from(d, meta["xperm"], prefix + "xp", x)
    band_rows = meta["band_rows"]
    bands = [None] * meta["nbands"]
    for cell in meta["cells"]:
        xs = x[cell["c0"]:cell["c0"] + cell["ncols"]]
        yc = _run_routed_part(d, xs, cell["nrows"], cell["meta"],
                              cell["prefix"])
        bi = cell["r0"] // band_rows
        bands[bi] = yc if bands[bi] is None else bands[bi] + yc
    y = torch.cat([
        b if b is not None else x.new_zeros(min(band_rows, R - bi * band_rows))
        for bi, b in enumerate(bands)
    ])
    if meta["yperm"] is not None:
        y = panel_permute_apply_from(d, meta["yperm"], prefix + "yp", y)
    return y


@dataclasses.dataclass
class PrepareStats:
    format: str
    prep_time_s: float
    device_bytes: int
    fill: float  # block fill or 1 - padding (stream); 1.0 for dense


class SpmvHandle:
    """One prepared matrix, resident on ``device``, planned under
    ``profile`` (None: the device's, ``device_profile``)."""

    @traced("prepare", record=True)
    def __init__(
        self,
        matrix: Union[COOMatrix, np.ndarray],
        config: Optional[SpmvConfig] = None,
        format: str = "auto",  # noqa: A002 — mirrors the reference naming
        device="cuda",
        profile: Optional[DeviceProfile] = None,
    ):
        t0 = time.perf_counter()
        self.config = config or SpmvConfig()
        self.device = resolve_device(device)
        self.profile = profile or device_profile(self.device)
        if isinstance(matrix, np.ndarray):
            with span("prepare.pack"):
                self._from_dense_array(matrix)
            fmt = "dense"
        else:
            self.coo = matrix
            self.shape = matrix.shape
            self.nnz = matrix.nnz
            fmt = format
            if fmt == "auto":
                fmt = choose_format(matrix, self.config)
            if fmt == "dense":
                with span("prepare.pack"):
                    self._from_dense_array(matrix.to_dense())
            elif fmt == "block":
                self._prepare_block(matrix)
            elif fmt == "ellx":
                self._prepare_ellx(matrix)
            elif fmt == "window":
                self._prepare_window(matrix)
            elif fmt == "stream":
                self._prepare_stream(matrix)
            elif fmt == "routed":
                self._prepare_routed(matrix)
            elif fmt == "split":
                self._prepare_split(matrix)
            else:
                raise ValueError(f"unknown format: {fmt}")
        self.format = fmt
        self.stats = PrepareStats(
            format=fmt,
            prep_time_s=time.perf_counter() - t0,
            device_bytes=self.device_bytes,
            fill=self._fill,
        )

    @classmethod
    def from_plan(cls, plan, device="cuda",
                  profile: Optional[DeviceProfile] = None):
        """Build a handle directly from a prepared plan of the port
        (``plan/convert.py`` carries one over from the JAX package),
        skipping preprocessing.  A plan carries no profile: ``profile``
        (None: the device's) sets the block layouts and the residual
        executor of the handle."""
        self = cls.__new__(cls)
        self.config = getattr(plan, "config", None) or SpmvConfig()
        self.device = resolve_device(device)
        self.profile = profile or device_profile(self.device)
        self.coo = None
        self.shape = tuple(plan.shape)
        self.nnz = plan.nnz
        if isinstance(plan, (RoutedPlan, BandedRoutedPlan)):
            self._build_routed_arrays(plan)
            fmt = "routed"
        elif isinstance(plan, EllxPlan):
            self.config = dataclasses.replace(
                self.config, block_h=plan.block_h
            )
            self._build_ellx_arrays(plan, self.shape[1])
            fmt = "ellx"
        elif isinstance(plan, SplitPlan):
            self.config = dataclasses.replace(
                self.config, block_h=plan.block_h
            )
            self._build_split_arrays(plan)
            fmt = "split"
        elif isinstance(plan, BlockPlan):
            self.config = dataclasses.replace(
                self.config, block_h=plan.block_h
            )
            self._build_block_arrays(plan, self.shape[1])
            fmt = "block"
        elif isinstance(plan, WindowPlan):
            self.config = dataclasses.replace(
                self.config, block_h=plan.block_h
            )
            self._build_window_arrays(plan)
            fmt = "window"
        elif isinstance(plan, StreamPlan):
            self._build_stream_arrays(plan)
            fmt = "stream"
        else:
            raise TypeError(f"unsupported plan type {type(plan)}")
        self.format = fmt
        self.stats = PrepareStats(
            format=fmt,
            prep_time_s=0.0,
            device_bytes=self.device_bytes,
            fill=self._fill,
        )
        return self

    # -- preparation ------------------------------------------------------

    def _upload(self, arr: np.ndarray, dtype=None) -> torch.Tensor:
        with span("upload"):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=self.device, dtype=dtype
            )

    def _value_dtype(self) -> torch.dtype:
        if self.config.value_dtype == "bfloat16":
            return torch.bfloat16
        return torch.float32

    def _set_device_dict(self, d: Dict[str, torch.Tensor], fill: float):
        self._d = d
        self._fill = fill
        self.device_bytes = sum(int(v.nbytes) for v in d.values())

    def _from_dense_array(self, arr: np.ndarray):
        arr = np.asarray(arr, np.float32)
        self.shape = arr.shape
        if not hasattr(self, "coo"):
            self.coo = None
        self.nnz = getattr(self.coo, "nnz", arr.size)
        r, c = arr.shape
        rp = -(-r // 8) * 8
        cp = -(-c // LANES) * LANES
        padded = np.zeros((rp, cp), np.float32)
        padded[:r, :c] = arr
        self._dense = self._upload(padded)
        self._fill = 1.0
        self.device_bytes = int(self._dense.nbytes)

    def _prepare_block(self, coo: COOMatrix):
        with span("prepare.plan"):
            perm = None
            if self.config.col_reorder:
                perm = degree_column_perm(coo)
            plan = build_block_plan(coo, block_h=self.config.block_h,
                                    col_perm=perm)
        with span("prepare.pack"):
            self._build_block_arrays(plan, coo.num_cols)

    # The JAX handle's layout dispatch, with the profile's budgets: the
    # chunked kernel's x + y (+ two chunk buffers) must fit
    # chunked_budget_bytes, else x streams in panels of panel_ncb col
    # blocks, and when y does not fit either, y streams in panels of
    # panel_y_bytes too.

    def _block_fits_chunked(self, plan) -> bool:
        xy = (plan.num_col_blocks * LANES
              + plan.num_row_blocks * plan.block_h) * 4
        chunk_bytes = 2 * chunk_for(plan.block_h) * plan.block_h * LANES * 4
        return xy + chunk_bytes <= self.profile.chunked_budget_bytes

    def _block_fits_paneled(self, plan) -> bool:
        need = (
            plan.num_row_blocks * plan.block_h * 4  # y resident
            + self.profile.panel_ncb * LANES * 4 * 2  # x panel, two buffers
            + 2 * chunk_for(plan.block_h) * plan.block_h * LANES * 4
        )
        return need <= self.profile.chunked_budget_bytes

    def _panel_nrb(self, block_h: int) -> int:
        return max(self.profile.panel_y_bytes // (block_h * 4), 8)

    def _build_block_arrays(self, plan: BlockPlan, num_cols: int):
        """Dispatch a BlockPlan to the chunked (B1), x-paneled (B3) or x-
        and y-paneled (B4) layout by the budget above, as the JAX handle
        does, with its device dict keys; plus the identity-extended x
        permutation when the plan is column-reordered.  The tiled layout
        also holds B4's sector mask of the uploaded payload, outside the
        device dict (which stays the JAX handle's) and counted in
        ``device_bytes``."""
        self._block_plan_meta = plan
        self._chunked = self._block_fits_chunked(plan)
        self._paneled = not self._chunked and self._block_fits_paneled(plan)
        self._tiled = not self._chunked and not self._paneled
        self._chunk = chunk_for(plan.block_h)
        self._batch_d = None  # B6's per-block arrays, uploaded at first use
        self._sector_mask = None  # B4's, tiled layout only
        vdt = self._value_dtype()
        if self._chunked:
            data3d, meta, _ = pack_chunks(plan, self._chunk)
            d = {"data": self._upload(data3d, vdt),
                 "meta": self._upload(meta)}
        elif self._paneled:
            data3d, meta, panel_ids, _ = pack_chunks_paneled(
                plan, self._chunk, self.profile.panel_ncb)
            d = {"data": self._upload(data3d, vdt),
                 "meta": self._upload(meta),
                 "panels": self._upload(panel_ids)}
        else:
            data3d, meta, xp, yp, yf, _ = pack_chunks_tiled(
                plan, self._chunk, self.profile.panel_ncb,
                self._panel_nrb(plan.block_h))
            d = {"data": self._upload(data3d, vdt),
                 "meta": self._upload(meta),
                 "xpanels": self._upload(xp),
                 "ypanels": self._upload(yp),
                 "yfirst": self._upload(yf)}
            self._sector_mask = tiled_sector_mask(d["data"], plan.block_h)
        del data3d
        if plan.col_perm is not None:
            # to the full padded width: the paneled layouts pad x to whole
            # panels
            d["perm"] = self._upload(_extend_perm(
                plan.col_perm, num_cols, self._block_padded_cols()
            ))
        self._set_device_dict(d, plan.fill)
        if self._sector_mask is not None:
            self.device_bytes += int(self._sector_mask.nbytes)

    def _block_padded_cols(self) -> int:
        ncb = self._block_plan_meta.num_col_blocks
        if self._chunked:
            return ncb * LANES
        pn = self.profile.panel_ncb
        return -(-ncb // pn) * pn * LANES

    def _prepare_ellx(self, coo: COOMatrix):
        """Base-K ELL (plain torch product) + B1 overflow for heavy rows;
        block_h=1 gives row-granular units."""
        with span("prepare.plan"):
            perm = None
            if self.config.col_reorder:
                perm = degree_column_perm(coo)
            plan = build_block_plan(coo, block_h=self.config.block_h,
                                    col_perm=perm)
            eplan = build_ellx_plan(plan, profile=self.profile)
        with span("prepare.pack"):
            self._build_ellx_arrays(eplan, coo.num_cols)

    def _ellx_pack_into(self, d, eplan: EllxPlan):
        """Upload an ELLX plan's base and B1 overflow into ``d`` under the
        ELLX format's keys; sets the overflow's chunk (None without)."""
        vdt = self._value_dtype()
        d["base_data"] = self._upload(eplan.base_data, vdt)
        d["base_cols"] = self._upload(eplan.base_cols)
        self._chunk = None
        if eplan.overflow is not None:
            self._chunk = chunk_for(eplan.block_h)
            odata, ometa, _ = pack_chunks(eplan.overflow, self._chunk)
            d["odata"] = self._upload(odata, vdt)
            d["ometa"] = self._upload(ometa)
            d["ov_expand"] = self._upload(eplan.ov_expand)

    def _ellx_args(self, eplan: EllxPlan):
        """(row blocks, block_h, chunk, overflow row blocks): what
        ``ellx_matvec`` and ``ellx_matvec_batched`` take after x."""
        ov_nrb = (eplan.overflow.num_row_blocks
                  if eplan.overflow is not None else 0)
        return eplan.num_row_blocks, eplan.block_h, self._chunk, ov_nrb

    def _build_ellx_arrays(self, eplan: EllxPlan, num_cols: int):
        self._ellx_plan_meta = eplan
        d = {}
        self._ellx_pack_into(d, eplan)
        if eplan.col_perm is not None:
            d["perm"] = self._upload(_extend_perm(
                eplan.col_perm, num_cols, eplan.num_col_blocks * LANES
            ))
        self._set_device_dict(d, eplan.fill)

    def _prepare_split(self, coo: COOMatrix):
        """Hub split (plan/split.py): dense hub columns and rows, the body
        routed or ELLX as the planner picks it."""
        with span("prepare.plan"):
            plan = build_split_plan(coo, block_h=self.config.block_h,
                                    profile=self.profile)
        with span("prepare.pack"):
            self._build_split_arrays(plan)

    def _build_split_arrays(self, plan: SplitPlan):
        """The JAX handle's keys: ``hc``/``hc_idx`` and ``hr``/``hr_idx``
        for the hub panels; a routed body packed under ``b_`` with its own
        B9 table (its ``lt`` arrays counted in ``device_bytes``), or an
        ELLX body under the ELLX format's keys."""
        self._split_plan_meta = plan
        vdt = self._value_dtype()
        d = {}
        if plan.hub_col_dense is not None:
            d["hc"] = self._upload(plan.hub_col_dense, vdt)
            d["hc_idx"] = self._upload(plan.hub_col_idx)
        if plan.hub_row_dense is not None:
            d["hr"] = self._upload(plan.hub_row_dense, vdt)
            d["hr_idx"] = self._upload(plan.hub_row_idx)
        self._split_body_routed_meta = None
        self._chunk = None
        if isinstance(plan.body, RoutedPlan):
            self._split_body_routed_meta = self._routed_pack_into(
                d, plan.body, plan.shape, prefix="b_"
            )
        elif plan.body is not None:
            self._ellx_pack_into(d, plan.body)
        self._set_device_dict(d, plan.nnz / max(plan.device_bytes / 4.0,
                                                1.0))
        bmeta = self._split_body_routed_meta
        if bmeta is not None and bmeta["table"] is not None:
            self.device_bytes += bmeta["table"].lt_nbytes

    def _prepare_window(self, coo: COOMatrix):
        with span("prepare.plan"):
            plan = build_window_plan(coo, block_h=self.config.block_h)
        with span("prepare.pack"):
            self._build_window_arrays(plan)

    def _build_window_arrays(self, plan: WindowPlan):
        self._window_plan_meta = plan
        self._wchunk = chunk_for_windowed(plan.block_h)
        data3d, subidx3d, meta, _ = pack_window_chunks(plan, self._wchunk)
        self._set_device_dict({
            "data": self._upload(data3d, self._value_dtype()),
            "subidx": self._upload(subidx3d),
            "meta": self._upload(meta),
        }, plan.fill)

    def _prepare_stream(self, coo: COOMatrix):
        with span("prepare.plan"):
            plan = build_plan(coo, self.config)
        with span("prepare.pack"):
            self._build_stream_arrays(plan)

    def _build_stream_arrays(self, plan: StreamPlan):
        self._stream_plan_meta = plan
        self._set_device_dict({
            "vals": self._upload(plan.vals),
            "cols": self._upload(plan.cols),
            "round_ids": self._upload(plan.round_ids()),
            "seg_rows": self._upload(plan.seg_rows),
        }, 1.0 - plan.padding_ratio)

    def _routed_pack_into(self, d, plan: RoutedPlan, shape, prefix=""):
        """Pack a RoutedPlan (+ residual executor) into device dict ``d``
        under ``prefix``; returns the static meta the runner needs.  Each
        stream is packed exactly (``bucket=False``, one tile per chunk): x
        is padded to ``num_windows*1024`` and y to ``num_ytiles*1024``,
        not to powers of two.  The meta's ``table`` (None without tiles)
        holds B9's stream table over these arrays and each stream's ``lt``,
        uploaded outside ``d`` (which keeps the JAX handle's keys), and
        ``lts`` the same ``lt`` arrays in stream order, for B10."""
        streams, parts = [], []
        for i, s in enumerate(plan.streams):
            ((packed, dims),) = pack_stream(s, tchunk=1, bucket=False)
            names = stream_array_names(dims[4]) + ("base", "byt")
            for n, a in zip(names, packed):
                d[prefix + f"s{i}_" + n] = self._upload(a)
            streams.append(dims)
            parts.append((_stream_packed(d, prefix, i, dims), dims,
                          self._upload(s.lt.astype(np.int32))))
        meta = {
            "streams": streams,
            "table": (routed_table(parts, plan.num_ytiles) if parts
                      else None),
            "lts": [lt for _, _, lt in parts],
            "runs": None,
            "nwin": plan.num_windows,
            "nyt": plan.num_ytiles,
            "res": None,
            "res_coo": False,
            "res_ov": 0,
            "rchunk": None,
            "xperm": None,
            "yperm": None,
            "gathered": None,
        }
        if plan.gathered is not None:
            garrays, meta["gathered"] = pack_gathered(plan.gathered)
            for n, a in garrays.items():
                d[prefix + "g_" + n] = self._upload(a)
        if plan.col_perms is not None:
            meta["xperm"], meta["yperm"] = self._pack_rank_perms(
                d, plan.col_perms, plan.row_perms, prefix
            )
        n_res = len(plan.residual_vals)
        p = self.profile
        if n_res:
            # the JAX package's choice, under the profile's costs: element
            # scatter below the row-granular ELLX's per-row cost
            if n_res * p.residual_ns < (shape[0] * p.res_ellx_row_ns
                                        + n_res * p.res_ellx_nnz_ns):
                meta["res_coo"] = True
                d[prefix + "r_rows"] = self._upload(
                    plan.residual_rows.astype(np.int32))
                d[prefix + "r_cols"] = self._upload(
                    plan.residual_cols.astype(np.int32))
                d[prefix + "r_vals"] = self._upload(
                    plan.residual_vals.astype(np.float32))
            else:
                res = COOMatrix(shape, plan.residual_rows,
                                plan.residual_cols, plan.residual_vals)
                eplan = build_ellx_plan(build_block_plan(res, block_h=1),
                                        max_base_bytes=2 << 30, profile=p)
                meta["res"] = eplan
                d[prefix + "r_base_data"] = self._upload(eplan.base_data)
                d[prefix + "r_base_cols"] = self._upload(eplan.base_cols)
                if eplan.overflow is not None:
                    meta["rchunk"] = chunk_for(1)
                    meta["res_ov"] = eplan.overflow.num_row_blocks
                    odata, ometa, _ = pack_chunks(eplan.overflow,
                                                  meta["rchunk"])
                    d[prefix + "r_odata"] = self._upload(odata)
                    d[prefix + "r_ometa"] = self._upload(ometa)
                    d[prefix + "r_ov_expand"] = self._upload(eplan.ov_expand)
        return meta

    def _pack_rank_perms(self, d, col_perms, row_perms, prefix=""):
        """Pack the rank-space sandwich: x is permuted into rank space
        before the streams and y back after (B11, panel-local plans).
        Returns the (xperm, yperm) metas."""
        xperm = [
            pack_permute_into(d, build_permute_plan(p), prefix + f"xp{i}_",
                              self.device)
            for i, p in enumerate(col_perms)
        ]
        yperm = []
        for i, p in enumerate(row_perms):
            inv = np.empty(len(p), np.int64)
            inv[p] = np.arange(len(p))
            yperm.append(pack_permute_into(
                d, build_permute_plan(inv), prefix + f"yp{i}_", self.device
            ))
        return xperm, yperm

    def _routed_pack_banded_into(self, d, plan: BandedRoutedPlan, prefix=""):
        """Pack a BandedRoutedPlan: every cell's RoutedPlan under its own
        key prefix, plus the grid-wide rank-space sandwich."""
        meta = {
            "cells": [],
            "nbands": plan.num_bands,
            "band_rows": plan.band_rows,
            "xperm": None,
            "yperm": None,
        }
        for i, c in enumerate(plan.cells):
            cp = prefix + f"c{i}_"
            meta["cells"].append({
                "r0": c.r0, "c0": c.c0, "nrows": c.nrows, "ncols": c.ncols,
                "prefix": cp,
                "meta": self._routed_pack_into(d, c.plan, (c.nrows, c.ncols),
                                               prefix=cp),
            })
        if plan.col_perms is not None:
            meta["xperm"], meta["yperm"] = self._pack_rank_perms(
                d, plan.col_perms, plan.row_perms, prefix
            )
        return meta

    def _prepare_routed(self, coo: COOMatrix):
        """Routed format: per-nnz execution with plan-time routing (B9),
        its residual as an element scatter or row-granular ELLX (B1), in
        rank space with ``config.rank_sort`` (B11 sandwich), and as a grid
        of cells when x + y fail ``routed_vmem_ok`` (the JAX package's
        dispatch, under the handle's profile)."""
        p = self.profile
        with span("prepare.plan"):
            if not routed_vmem_ok(coo.shape, p):
                plan = build_banded_routed_plan(
                    coo, rank_sort=self.config.rank_sort, profile=p)
            elif self.config.rank_sort:
                plan = build_ranked_routed_plan(coo, profile=p)
            else:
                plan = build_routed_plan(coo, profile=p)
        with span("prepare.pack"):
            self._build_routed_arrays(plan)

    def _build_routed_arrays(self, plan):
        """The device dict and the metas, rebuilt together: each part's B9
        table points into ``d``, and its ``lt`` arrays count in
        ``device_bytes``."""
        self._routed_plan_meta = plan
        d = {}
        if isinstance(plan, BandedRoutedPlan):
            self._routed_meta = self._routed_pack_banded_into(d, plan)
            parts = [c["meta"] for c in self._routed_meta["cells"]]
        else:
            meta = self._routed_pack_into(d, plan, plan.shape)
            if _routed_runs_b10(meta):
                # each stream's runs a call, for B10's count
                meta["runs"] = [
                    stream_runs(_stream_packed(d, "", i, dims), dims,
                                meta["nyt"], meta["lts"][i])
                    for i, dims in enumerate(meta["streams"])]
            self._routed_meta = meta
            parts = [meta]
        self._set_device_dict(d, plan.fill)
        self.device_bytes += sum(m["table"].lt_nbytes for m in parts
                                 if m["table"] is not None)

    # -- execution --------------------------------------------------------

    @property
    def plan(self):
        """The prepared plan object for this handle's format (reloadable
        with :meth:`from_plan`); ``None`` for the dense overlay."""
        for attr in (
            "_split_plan_meta", "_routed_plan_meta", "_window_plan_meta",
            "_stream_plan_meta", "_ellx_plan_meta", "_block_plan_meta",
        ):
            p = getattr(self, attr, None)
            if p is not None:
                return p
        return None

    @property
    def padded_cols(self) -> int:
        if self.format == "dense":
            return int(self._dense.shape[1])
        if self.format == "block":
            return self._block_padded_cols()
        if self.format == "ellx":
            return self._ellx_plan_meta.num_col_blocks * LANES
        if self.format == "split":
            return -(-self.shape[1] // LANES) * LANES
        if self.format == "window":
            return self._window_plan_meta.num_windows * SEGS * LANES
        if self.format == "routed" and "cells" not in self._routed_meta:
            # banded grids slice x at original offsets and pad each slice
            return self._routed_meta["nwin"] * WINDOW
        return self.shape[1]

    def _check_cols(self, x: torch.Tensor) -> None:
        if x.shape[-1] != self.shape[1]:
            raise ValueError(
                f"x has {x.shape[-1]} entries, matrix has {self.shape[1]} "
                "columns"
            )

    def _pad_x(self, x: torch.Tensor) -> torch.Tensor:
        self._check_cols(x)
        pad = self.padded_cols - x.shape[-1]
        if pad > 0:
            x = torch.nn.functional.pad(x, (0, pad))
        return x

    def _matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Unscaled A @ x [R] from the padded x."""
        R = self.shape[0]
        if self.format == "dense":
            return gemv(self._dense, x)[:R]
        d = self._d
        if self.format == "stream":
            plan = self._stream_plan_meta
            return spmv_ref(d["vals"], d["cols"], d["round_ids"],
                            d["seg_rows"], plan.num_rounds, R, x)
        if self.format == "routed":
            return _run_routed_part(d, x, R, self._routed_meta, "")
        if self.format == "split":
            return self._split_matvec(x)
        if "perm" in d:
            with span("permute"):
                x = x.index_select(0, d["perm"])
        x2d = x.reshape(-1, LANES)
        if self.format == "block":
            y = self._block_matvec(x2d)
        elif self.format == "ellx":
            y = ellx_matvec(d, x2d, *self._ellx_args(self._ellx_plan_meta))
        else:  # window
            plan = self._window_plan_meta
            y = spmv_windowed(d["data"], d["subidx"], d["meta"], x2d,
                              plan.num_row_blocks, plan.block_h,
                              self._wchunk)
        return y.reshape(-1)[:R]

    def _block_matvec(self, x2d: torch.Tensor) -> torch.Tensor:
        """y tiles of the block format from the permuted, padded x2d, by
        the handle's layout: B1, B3 or B4."""
        d, plan = self._d, self._block_plan_meta
        nrb, bh = plan.num_row_blocks, plan.block_h
        if self._chunked:
            return spmv_chunked(d["data"], d["meta"], x2d, nrb, bh,
                                self._chunk)
        if self._paneled:
            return spmv_chunked_paneled(d["data"], d["meta"], d["panels"],
                                        x2d, nrb, bh, self._chunk,
                                        self.profile.panel_ncb)
        panel_nrb = self._panel_nrb(bh)
        return spmv_chunked_tiled(d["data"], d["meta"], d["xpanels"],
                                  d["ypanels"], x2d, -(-nrb // panel_nrb),
                                  panel_nrb, bh, self._chunk,
                                  self.profile.panel_ncb, self._sector_mask)

    def _split_hubs(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``y`` plus the hub panels' products against the padded ``x``
        ([Cp], or [B, Cp] with y [B, R]): the hub columns' panel against
        the gathered hub entries of x, the hub rows' panel against x, both
        fp32 matmuls with TF32 off (the JAX handle's HIGHEST-precision
        dots); the hub rows are unique, so their scatter is exact."""
        d, R = self._d, self.shape[0]
        if "hc" in d:
            xh = x.index_select(-1, d["hc_idx"])
            xh = torch.nn.functional.pad(
                xh, (0, d["hc"].shape[1] - xh.shape[-1]))
            y = y + gemv(d["hc"].float(), xh)[..., :R]
        if "hr" in d:
            kr = len(self._split_plan_meta.hub_row_idx)
            yr = gemv(d["hr"].float(), x)[..., :kr]
            y = y.index_add(y.ndim - 1, d["hr_idx"], yr)
        return y

    def _split_matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x [R] of the split format: the body (one B9 launch, or the
        ELLX base product plus B1), then the hub panels."""
        R, d = self.shape[0], self._d
        if self._split_body_routed_meta is not None:
            y = _run_routed_part(d, x, R, self._split_body_routed_meta, "b_")
        elif "base_data" in d:
            y = ellx_matvec(d, x.reshape(-1, LANES),
                            *self._ellx_args(self._split_plan_meta.body))
            y = y.reshape(-1)[:R]
        else:
            y = x.new_zeros(R)
        return self._split_hubs(y, x)

    def _split_matmat(self, xb: torch.Tensor) -> torch.Tensor:
        """x @ A.T [B, R] of the split format from the padded batch: a
        routed body vector by vector (one B9 launch each, as the JAX
        handle does), an ELLX body as the grouped base product plus B2;
        then the hub panels."""
        R, d = self.shape[0], self._d
        B = xb.shape[0]
        bmeta = self._split_body_routed_meta
        if bmeta is not None:
            y = _run_routed_vectors(d, xb, R, bmeta, "b_")
        elif "base_data" in d:
            with span("transpose"):
                xt = xb.T.reshape(-1, LANES, B).contiguous()
            y = ellx_matvec_batched(
                d, xt, *self._ellx_args(self._split_plan_meta.body))
            y = y.reshape(-1, B)[:R].T
        else:
            y = xb.new_zeros((B, R))
        return self._split_hubs(y, xb)

    def _block_uses_b2(self, batch: int) -> bool:
        """The JAX handle's ``linear`` rule: B2 when the handle is chunked
        and the batch's x + y (+ two chunk buffers) fit the profile's
        ``batched_budget_bytes``, else B6."""
        plan = self._block_plan_meta
        need = ((plan.num_col_blocks * LANES
                 + plan.num_row_blocks * plan.block_h) * batch * 4
                + 2 * self._chunk * plan.block_h * LANES * 4)
        return self._chunked and need <= self.profile.batched_budget_bytes

    def _block_matmat(self, xb: torch.Tensor) -> torch.Tensor:
        """y [nrb, bh, B] of the block format from the padded batch ``xb``
        [B, Cp] (not yet permuted), through B2 or B6."""
        plan, B = self._block_plan_meta, xb.shape[0]
        if self._block_uses_b2(B):
            if "perm" in self._d:
                with span("permute"):
                    xb = xb.index_select(1, self._d["perm"])
            with span("transpose"):
                xt = xb.T.reshape(-1, LANES, B).contiguous()  # [ncb, 128, B]
            return spmv_chunked_batched(self._d["data"], self._d["meta"], xt,
                                        plan.num_row_blocks, plan.block_h,
                                        self._chunk)
        if self._batch_d is None:
            # per-block arrays (f32, as the JAX handle uploads them), once
            with recording(), span("upload"):  # set-up, recorded
                self._batch_d = upload_block_plan(plan, self.device)
                if plan.col_perm is not None:
                    self._batch_d["perm"] = self._upload(_extend_perm(
                        plan.col_perm, self.shape[1],
                        plan.num_col_blocks * LANES))
        bd = self._batch_d
        if "perm" in bd:
            with span("permute"):
                xb = xb.index_select(1, bd["perm"])
        with span("transpose"):
            xt = xb.T.reshape(-1, LANES, B).contiguous()
        return spmv_block_batched(bd["data"], bd["rows"], bd["cols"],
                                  bd["firsts"], bd["lasts"], xt,
                                  plan.num_row_blocks, starts=bd["starts"])

    @traced("run")
    def run(self, x, y_in=None, alpha=1.0, beta=0.0) -> torch.Tensor:
        """``y = alpha * A @ x + beta * y_in`` (single vector), as a float32
        tensor on the handle's device."""
        with span("pad"):
            x = self._pad_x(
                torch.as_tensor(x, dtype=torch.float32, device=self.device)
            )
        y = self._matvec(x)
        with span("epilogue"):
            y = alpha * y
            if y_in is None:
                return y
            y_in = torch.as_tensor(y_in, dtype=torch.float32,
                                   device=self.device)
            return y + beta * y_in

    @property
    def _routed_batched(self) -> bool:
        """``linear`` runs B10 (see :func:`_routed_runs_b10`)."""
        return self.format == "routed" and _routed_runs_b10(self._routed_meta)

    def _matmat(self, xb: torch.Tensor) -> torch.Tensor:
        """Unscaled x @ A.T [B, R] from the padded batch ``xb`` [B, Cp]
        (B10's path pads itself: ``xb`` [B, C], any strides)."""
        R = self.shape[0]
        B = xb.shape[0]
        if self.format == "dense":
            return gemv(self._dense, xb)[:, :R]
        d = self._d
        if self.format == "stream":
            plan = self._stream_plan_meta
            return spmv_ref(d["vals"], d["cols"], d["round_ids"],
                            d["seg_rows"], plan.num_rounds, R, xb)
        if self.format == "routed":
            if self._routed_batched:
                return _run_routed_batched(d, xb, R, self._routed_meta)
            return _run_routed_vectors(d, xb, R, self._routed_meta, "")
        if self.format == "split":
            return self._split_matmat(xb)
        if self.format == "block":
            return self._block_matmat(xb).reshape(-1, B)[:R].T
        if "perm" in d:
            with span("permute"):
                xb = xb.index_select(1, d["perm"])
        # x vector-minor: [nwin*8, 128, B] (window), [ncb, 128, B] (ellx)
        with span("transpose"):
            xt = xb.T.reshape(-1, LANES, B).contiguous()
        if self.format == "window":
            plan = self._window_plan_meta
            y = spmv_windowed_batched(d["data"], d["subidx"], d["meta"], xt,
                                      plan.num_row_blocks, plan.block_h,
                                      self._wchunk)
            return y.reshape(-1, B)[:R].T
        y = ellx_matvec_batched(d, xt, *self._ellx_args(self._ellx_plan_meta))
        return y.reshape(-1, B)[:R].T

    @traced("linear")
    def linear(self, x_batch, bias=None) -> torch.Tensor:
        """Batched ``y[B, R] = x[B, C] @ A.T + bias``, the NN-layer entry
        point, as a float32 tensor on the handle's device.  ``x_batch``
        [B, C], or [C] (the result is then [R]).  Per format: dense as one
        fp32 GeMM; block through B2 or B6 (the JAX handle's rule, see
        ``_block_uses_b2``); ellx as the grouped base product plus
        B2 overflow; window through B8; stream as the batched reference;
        routed in original space through B10 (one launch per stream for
        the whole batch, all into one vector-minor y, returned as its
        transposed view), and vector by vector (B9, B11) in rank space and
        on the banded grid; split as its hub panels plus its body (B2 for
        an ELLX body, B9 vector by vector for a routed one)."""
        with span("pad"):
            xb = torch.as_tensor(x_batch, dtype=torch.float32,
                                 device=self.device)
            squeeze = xb.ndim == 1
            if squeeze:
                xb = xb[None, :]
            if self._routed_batched:  # B10's path pads as it lays x out
                self._check_cols(xb)
            else:
                xb = self._pad_x(xb).contiguous()
        y = self._matmat(xb)
        if bias is not None:
            with span("epilogue"):
                y = y + torch.as_tensor(bias, dtype=torch.float32,
                                        device=self.device)[None, :]
        return y[0] if squeeze else y

    def verify(self, x=None, rtol=1e-3, atol=1e-5):
        """Golden check vs the host matrix (float64 accumulation)."""
        if x is None:
            i = np.arange(self.shape[1], dtype=np.float32)
            x = (i + 2.0) / (i + 1.0)  # spmv-host.cpp:17-23 test vector
        got = self.run(x).cpu().numpy()
        if self.coo is not None:
            want = self.coo.matvec(np.asarray(x, np.float64))
        elif self.format == "dense":
            dense = self._dense.cpu().numpy()[: self.shape[0], : self.shape[1]]
            want = dense.astype(np.float64) @ np.asarray(x, np.float64)
        else:
            raise ValueError("verify needs the host matrix; this handle was "
                             "built from a plan")
        return error_stats(got, want, rtol=rtol, atol=atol)


def choose_format(coo: COOMatrix, config: SpmvConfig) -> str:
    """Cheap structural dispatch, identical to the JAX package's: dense
    above 25% density, else block / window / ellx by an estimated (block_h,
    128) block fill; stream only for an empty matrix."""
    if config.dense_overlay:
        return "dense"
    density = coo.nnz / max(coo.num_rows * coo.num_cols, 1)
    if density > 0.25:
        return "dense"
    # Estimate block fill from a sample of coordinates.
    n = coo.nnz
    if n == 0:
        return "stream"
    take = min(n, 250_000)
    idx = np.linspace(0, n - 1, take).astype(np.int64)
    rb = coo.rows[idx] // config.block_h
    cb = coo.cols[idx] // LANES
    ncb = max(-(-coo.num_cols // LANES), 1)
    uniq = len(np.unique(rb.astype(np.int64) * ncb + cb))
    est_blocks = uniq * (n / take)
    est_fill = n / (est_blocks * config.block_h * LANES)
    if est_fill >= config.min_block_fill:
        return "block"
    return "window" if est_fill >= 0.01 else "ellx"


def prepare(
    matrix: Union[COOMatrix, np.ndarray],
    config: Optional[SpmvConfig] = None,
    format: str = "auto",  # noqa: A002
    device="cuda",
    profile: Optional[DeviceProfile] = None,
) -> SpmvHandle:
    """Prepare a matrix for repeated execution on ``device``, planned
    under ``profile`` (None: the device's)."""
    return SpmvHandle(matrix, config=config, format=format, device=device,
                      profile=profile)


class Accelerator:
    """Multi-matrix residency + selection + batched linear.

    Create handles for many matrices up front, keep them resident on one
    device, then run any of them back to back.  ``budget_bytes`` imitates
    the reference's fixed per-channel arena by refusing new matrices past
    the budget (``create_*`` then returns -1).  Every handle is planned
    under ``profile`` (None: the device's)."""

    def __init__(self, budget_bytes: Optional[int] = None, device="cuda",
                 profile: Optional[DeviceProfile] = None):
        self.budget_bytes = budget_bytes
        self.device = resolve_device(device)
        self.profile = profile or device_profile(self.device)
        self._handles: Dict[int, SpmvHandle] = {}
        self._next_id = 0
        self._selected: Optional[int] = None
        self.loaded = False

    @property
    def resident_bytes(self) -> int:
        return sum(h.device_bytes for h in self._handles.values())

    def create_sparse_handle(
        self,
        coo: COOMatrix,
        config: Optional[SpmvConfig] = None,
        format: str = "auto",  # noqa: A002
    ) -> int:
        """Returns a matrix id, or -1 if the memory budget is exhausted."""
        return self._register(
            SpmvHandle(coo, config=config, format=format, device=self.device,
                       profile=self.profile)
        )

    def create_dense_handle(self, arr: np.ndarray) -> int:
        return self._register(SpmvHandle(np.asarray(arr), device=self.device,
                                         profile=self.profile))

    def _register(self, h: SpmvHandle) -> int:
        if (
            self.budget_bytes is not None
            and self.resident_bytes + h.device_bytes > self.budget_bytes
        ):
            return -1
        mid = self._next_id
        self._next_id += 1
        self._handles[mid] = h
        if self._selected is None:
            self._selected = mid
        return mid

    def load_matrices(self) -> None:
        """Block until every upload has completed."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.loaded = True

    def select_matrix(self, mid: int) -> None:
        if mid not in self._handles:
            raise KeyError(f"unknown matrix id {mid}")
        self._selected = mid

    def handle(self, mid: Optional[int] = None) -> SpmvHandle:
        mid = self._selected if mid is None else mid
        if mid is None:
            raise RuntimeError("no matrix loaded")
        return self._handles[mid]

    def run_kernel(self, x, y_in=None, alpha=1.0, beta=0.0) -> torch.Tensor:
        return self.handle().run(x, y_in=y_in, alpha=alpha, beta=beta)

    def linear(self, mid: int, x_batch, bias=None) -> torch.Tensor:
        return self.handle(mid).linear(x_batch, bias=bias)
