"""Routed-stream planner: per-nnz vectorized SpMV with plan-time routing.

Carried over from ``hispmv_tpu/plan/routed.py`` (numpy, the standard
library and the port's native planning routines).  Every cost the planner
weighs comes from the ``DeviceProfile`` it is given (``tune/cost.py``):
under ``V5E``, the JAX package's values, both packages build identical
plans; the handle passes ``H100`` on the card.  The
native routines (``hispmv_tpu_torch/native``) raise when they cannot be
built; their numpy versions stay here as ``_greedy_merge_py``,
``_distinct_rank_py``, ``_tile_stats_py`` and ``np.lexsort``.  The
stream kernel is B9 (``ops/spmv_routed.py``, ``csrc/spmv_routed.cu``).
The gathered side-plan is ``plan/gathered.py`` (executor
``ops/spmv_gathered.py``: kernels B12, B11 and B13).  Original notes
follow; every time quoted in them is the TPU's, not the card's.

THE load-balance/crossbar answer for scattered matrices (v4 layout, round
3).  Every other format pays either ~4 KiB of payload per touched
(block, window) unit or ~1.8 ns per gathered unit — both collapse when
units ~= nnz.  This format processes nnz at VECTOR rate by resolving ALL
routing at plan time (the role the reference's butterfly crossbar +
out-of-order scheduler play in hardware, base_functions.cpp:356-436 +
spmv-helper.cpp:429-515):

- nnz are sorted by (column strip, row, col) where a STRIP is
  ``strip_windows`` consecutive 1024-column windows, and packed densely
  into (8,128) tiles of 1024 SLOTS.
- pass 1 (x gather): a composed two-level gather consults the sub grid
  at (target sublane, SOURCE lane), so per (row, source-lane) CELL only
  one (window, sub) source can be served per gather layer — the
  fundamental constraint the reference's crossbar resolves in hardware.
  v4 resolves it with SLAB layers: each layer is a select tree over the
  tile's whole window span W (one in-vreg sublane gather + select per
  window, measured ~0.9 ns/window/tile) driven by a per-cell 9-bit
  (win<<3 | sub) field.  Layer l serves each cell's l-th distinct
  source; three 9-bit fields ride one i32, so up to 3 layers resolve all
  conflicts (deeper conflicts are evicted and repacked into fresh
  tiles).  Slots carry a 2-bit rank selecting their layer.  Unlike
  per-window layering (v3), a layer serves conflicts across ALL of the
  tile's windows at once, so conflict pressure no longer scales with the
  strip width.
- pass 2 (segmented reduce): products are prefix-summed over the flat
  tile order (lane prefix via a triangular MXU matmul + sublane carry),
  and each row-run's sum is extracted as P'[end] - P'[start-1].
- pass 3 (y accumulate): boundary values are routed into y tiles by
  per-layer (8,128) two-level gathers, signed (+end / -start); layer =
  band chain base + conflict rank (per target sublane and source lane,
  one distinct source sublane per layer), each layer accumulating into
  its own y tile.  A row spanning several tiles accumulates partials.

v4 zero-lane layout (kept from v3): the 8 lane-0 slots of every tile are
reserved zero pads (values 0, coordinates forward-filled from the lane-1
neighbor).  No run ever starts right after or ends on a lane-0 slot, so
no boundary entry's source sits at lane 0, so the (sub, lane) = (0, 0)
read is guaranteed to see sub-field 0 and the in-tile prefix P'[0, 0]
== 0.  Boundary words therefore carry NO validity bits: a padded/absent
boundary side reads an exact 0 instead of being masked.

Tiles whose modeled cost exceeds the element-scatter residual cost are
demoted to the residual wholesale.  Remaining tiles are partitioned into
up to ``max_streams`` cost classes by (window span, pass-1 layers,
boundary layers) so light tiles are not charged the heavy tiles' padded
dimensions; each class is an independently executable stream (classes
cheaper to merge than a kernel launch are merged).

Streams are stored COMPRESSED (the stream is the cost):

- ``vals``  f32 [T,8,128]: the slot's value;
- ``slot``  i32 [T,8,128]: lane | rank<<7 at SLOT positions, plus the
  layer-3/4 cell fields at bits 10/19 (two position semantics share the
  word as disjoint bit planes);
- ``gsub``  i32 [T,8,128] at (row, SOURCE-lane) cell positions: the
  layer-l source (win_local<<3 | sub, 9 bits) at bits 9*l for l < 3;
- ``bl``    i32 [T,ceil(L/2),8,128]: boundary lanes, two layers per
  word — (end_lane | start_lane<<7) << (14*(k%2)), NO validity bits;
- ``bs``    i32 [T,ceil(L/4),8,128]: boundary subs, four layers per
  word — (end_sub | start_sub<<4) << (8*(k%4));
- ``base``  i32 [T]: the tile's window base;
- ``byt``   i32 [T,L]: y tile per boundary layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from hispmv_tpu_torch import native
from hispmv_tpu_torch.formats.matrix import COOMatrix
from hispmv_tpu_torch.profiles import V5E, DeviceProfile
from hispmv_tpu_torch.utils.trace import span, traced

WINDOW = 1024  # columns per window = one (8,128) x tile
TILE = 1024  # nnz slots per tile (8 sublanes x 128 lanes)

# The per-tile costs (tile_*_ns), the residual's (residual_ns) and the
# per-stream launch (launch_ns) are fields of the DeviceProfile each
# planner takes (tune/cost.py; V5E holds the JAX package's values).  They
# are EFFECTIVE linear constants: each dimension's share of stream traffic
# is folded into its coefficient.  Every class-cap boundary layer executes
# (padded layers add exact zeros), so a tile is charged its CLASS's lmax;
# the select tree is unrolled to the CLASS's W.
W_CAP = 64  # max window span per tile (6 bits in the gsub field)
L1_CAP = 5  # pass-1 slab layers: three 9-bit fields in gsub + two more
# in the slot word's free bits (no extra stream DMA)
L_CAP = 32  # boundary layers (band chains + conflict ranks)
# the 8 lane-0 slots of every tile are reserved zero pads (see module
# docstring: P'[0,0] == 0 is what removes all validity bits)
PAYLOAD = TILE - 8  # 8 sublane rows x 127 payload lanes


@dataclasses.dataclass
class RoutedStream:
    """One cost class of tiles, fully compressed (see module docstring)."""

    num_tiles: int
    wmax: int  # window span the slab select tree unrolls
    l1: int  # pass-1 layers (1 slab + overflow) this kernel unrolls
    lmax: int  # boundary layers this stream's kernel unrolls
    vals: np.ndarray  # f32 [T, 8, 128]
    slot: np.ndarray  # i32 [T, 8, 128]: lane | rank<<7 at slot
    # positions; layer-3/4 cell fields at bits 10/19
    gsub: np.ndarray  # i32 [T, 8, 128] at (row, source-lane) cells:
    # layer-l source (win_local<<3 | sub) at bits 9*l, l < 3
    bl: np.ndarray  # i32 [T, ceil(lmax/2), 8, 128]: boundary lanes, two
    # layers per word — (end_lane | start_lane<<7) << (14*(k%2))
    bs: np.ndarray  # i32 [T, ceil(lmax/4), 8, 128]: boundary subs, four
    # layers per word — (end_sub | start_sub<<4) << (8*(k%4))
    base: np.ndarray  # i32 [T]: window base per tile
    byt: np.ndarray  # i32 [T, lmax]: y tile per boundary layer
    lt: np.ndarray  # i32 [T]: ACTUAL boundary layers per tile (kept for
    # diagnostics/cost analysis; the kernel runs every class-cap layer —
    # padded layers read the zero slot and add exact zeros)

    @property
    def stream_bytes(self) -> int:
        return (
            self.vals.nbytes + self.slot.nbytes + self.gsub.nbytes
            + self.bl.nbytes + self.bs.nbytes
        )


@dataclasses.dataclass
class RoutedPlan:
    shape: tuple
    nnz: int
    num_windows: int
    num_ytiles: int
    s0: Optional[RoutedStream]
    s1: Optional[RoutedStream]
    s2: Optional[RoutedStream]
    residual_rows: np.ndarray  # demoted/evicted nnz (COO)
    residual_cols: np.ndarray
    residual_vals: np.ndarray
    s3: Optional[RoutedStream] = None
    s4: Optional[RoutedStream] = None
    s5: Optional[RoutedStream] = None
    # rank-space execution (build_ranked_routed_plan): panel-local
    # degree-sort permutations.  When set, the streams/residual are in
    # rank space: the executor permutes x in (x_rank[base+k] =
    # x[base+col_perms[p][k]]) and y back out (y[base+row_perms[p][k]] =
    # y_rank[base+k]).  None = original space.
    col_perms: Optional[list] = None
    row_perms: Optional[list] = None
    # gathered side-plan (plan/gathered.py): scattered short-row tiles
    # diverted out of the boundary-layer machinery entirely
    gathered: Optional[object] = None

    MAX_STREAMS = 6

    @property
    def streams(self):
        return [
            s
            for s in (self.s0, self.s1, self.s2, self.s3, self.s4, self.s5)
            if s is not None
        ]

    @property
    def num_tiles(self) -> int:
        return sum(s.num_tiles for s in self.streams)

    @property
    def l1(self) -> int:
        return max((s.l1 for s in self.streams), default=1)

    @property
    def wmax(self) -> int:
        return max((s.wmax for s in self.streams), default=1)

    @property
    def lmax(self) -> int:
        return max((s.lmax for s in self.streams), default=1)

    @property
    def stream_bytes(self) -> int:
        return sum(s.stream_bytes for s in self.streams)

    @property
    def fill(self) -> float:
        # overall slot occupancy across BOTH executors: gathered-diverted
        # nnz sit in gathered tiles, so those tiles count in the
        # denominator too (fill is always in (0, 1])
        slots = self.num_tiles * TILE
        if self.gathered is not None:
            slots += self.gathered.num_tiles * TILE
        return (self.nnz - len(self.residual_vals)) / max(slots, 1)


def _greedy_merge(strip_of: np.ndarray, bc: np.ndarray, cap: int):
    """Greedy same-strip cell merge (native C++): cells of one strip share
    a group while the summed band count stays <= cap."""
    return native.greedy_cell_merge(strip_of, bc, cap)


def _greedy_merge_py(strip_of: np.ndarray, bc: np.ndarray, cap: int):
    """Plain Python version of :func:`_greedy_merge`."""
    gid = np.empty(len(strip_of), np.int64)
    g, cur_b, cur_s = -1, 0, -1
    for i in range(len(strip_of)):
        if strip_of[i] != cur_s or cur_b + bc[i] > cap:
            g += 1
            cur_b, cur_s = 0, strip_of[i]
        gid[i] = g
        cur_b += int(bc[i])
    return gid


def _sort_mrc(
    mcell: np.ndarray, rows: np.ndarray, cols: np.ndarray,
    R: int, C: int,
) -> np.ndarray:
    """argsort by (mcell, row, col) — the planner's dominant cost.  When
    the composite key fits 63 bits (every suite matrix), one native
    parallel radix sort replaces the three-key np.lexsort (the reference
    parallelizes its prepare driver the same way,
    spmv-helper.cpp:642-715)."""
    rb = max(int(R - 1).bit_length(), 1)
    cb = max(int(C - 1).bit_length(), 1)
    mmax = int(mcell.max()) if len(mcell) else 0
    if mmax.bit_length() + rb + cb <= 63:
        key = (
            (mcell.astype(np.uint64) << np.uint64(rb + cb))
            | (rows.astype(np.uint64) << np.uint64(cb))
            | cols.astype(np.uint64)
        )
        return native.radix_argsort(key)
    return np.lexsort((cols, rows, mcell))


def _distinct_rank(
    group: np.ndarray, val: np.ndarray, width: int = 8
) -> np.ndarray:
    """Per entry: how many DISTINCT ``val`` values precede it in its
    group (0 when its (group, val) pair has been seen — entries sharing a
    pair share a rank).  Used for conflict layering: a (target sublane,
    source lane) cell can serve one source per gather layer.  ``width``
    must exceed every val (the combined sort key is group*width+val)."""
    return native.distinct_rank(group * width + val, width)


def _distinct_rank_py(
    group: np.ndarray, val: np.ndarray, width: int = 8
) -> np.ndarray:
    """Plain numpy version of :func:`_distinct_rank`."""
    key = group * width + val
    o = np.argsort(key, kind="stable")
    k_s = key[o]
    new_s = np.ones(len(o), bool)
    new_s[1:] = k_s[1:] != k_s[:-1]
    new_g = np.ones(len(o), bool)
    new_g[1:] = (k_s[1:] // width) != (k_s[:-1] // width)
    did = np.cumsum(new_s) - 1
    fd = np.where(new_g, did, 0)
    np.maximum.accumulate(fd, out=fd)
    rank = np.empty(len(group), np.int64)
    rank[o] = did - fd
    return rank


def _chain_bases(tile: np.ndarray, key: np.ndarray, need: np.ndarray,
                 first_pos: np.ndarray):
    """Per (tile, key) chain: exclusive cumulative layer base, chains
    ordered by first appearance within the tile.

    Args are per-CHAIN arrays (one row per unique (tile, key)); returns
    the base aligned with them."""
    order = np.lexsort((first_pos, tile))
    t_s, n_s = tile[order], need[order]
    csum = np.cumsum(n_s)
    new_t = np.ones(len(order), bool)
    new_t[1:] = t_s[1:] != t_s[:-1]
    start = np.where(new_t, csum - n_s, 0)
    np.maximum.accumulate(start, out=start)
    base_s = (csum - n_s) - start
    base = np.empty(len(tile), np.int64)
    base[order] = base_s
    return base


def winband_table(
    rows: np.ndarray, cols: np.ndarray, shape: tuple
) -> tuple:
    """Distinct (window, band) pairs + their nnz counts — ONE pass over
    the nnz, shared by every strip-width estimate (the per-width unique
    passes over the full nnz were the DSE's dominant cost).  Returns
    (win, band, counts) aligned arrays sorted by (win, band)."""
    R, C = shape
    nwin = max(-(-C // WINDOW), 1)
    nyt = max(-(-R // WINDOW), 1)
    key = (
        (cols.astype(np.int64, copy=False) // WINDOW) * np.int64(nyt)
        + rows.astype(np.int64, copy=False) // WINDOW
    )
    if nwin * nyt <= (1 << 26):
        cnt = np.bincount(key, minlength=nwin * nyt)
        pairs = np.nonzero(cnt)[0]
        counts = cnt[pairs]
    else:
        pairs, counts = np.unique(key, return_counts=True)
    return pairs // nyt, pairs % nyt, counts.astype(np.int64)


def estimate_routed_cost_ns(
    rows: np.ndarray,
    cols: np.ndarray,
    shape: tuple,
    strip_windows: int = 4,
    l_cap: int = L_CAP,
    conflict_sample: bool = False,
    table: Optional[tuple] = None,
    profile: DeviceProfile = V5E,
) -> dict:
    """Cheap estimate of a v4 routed plan's cost for the model-only DSE:
    mirrors the planner's macro-cell grouping + same-strip merging,
    estimating the per-tile window span from per-group window coverage
    and boundary layers from per-group band coverage.  All per-cell
    statistics aggregate the tiny (window, band) count table
    (``winband_table``; pass one in to share it across strip widths)
    instead of re-scanning the nnz.  ``rows``/``cols`` may be None when
    a table is given and ``conflict_sample`` is False.
    Returns {tiles, est_ns, stream_bytes, fill}."""
    p = profile
    R, C = shape
    if table is None:
        if len(rows) == 0:
            return {"tiles": 0, "est_ns": 0.0, "stream_bytes": 0,
                    "fill": 1.0}
        table = winband_table(rows, cols, shape)
    t_win, t_band, t_cnt = table
    if len(t_cnt) == 0:
        return {"tiles": 0, "est_ns": 0.0, "stream_bytes": 0, "fill": 1.0}
    n = int(t_cnt.sum())
    nwin = max(-(-C // WINDOW), 1)
    nyt = max(-(-R // WINDOW), 1)
    nbb = max(-(-nyt // l_cap), 1)
    # per-cell stats from the table: cells are (strip, band-block) groups
    # of table rows; table rows are distinct (win, band) pairs
    t_mcell = (t_win // strip_windows) * nbb + t_band // l_cap
    uc, inv = np.unique(t_mcell, return_inverse=True)
    csz = np.bincount(inv, weights=t_cnt.astype(np.float64)).astype(
        np.int64
    )
    # distinct bands/windows per cell from distinct (cell, band/win) pairs
    ub = np.unique(t_mcell * np.int64(nyt) + t_band)
    bc = np.bincount(np.searchsorted(uc, ub // nyt), minlength=len(uc))
    uw = np.unique(t_mcell * np.int64(nwin) + t_win)
    wc = np.bincount(np.searchsorted(uc, uw // nwin), minlength=len(uc))
    strip_of = uc // nbb
    # same greedy same-strip merge as the planner
    gid = _greedy_merge(strip_of, bc, l_cap)
    ng = int(gid[-1]) + 1 if len(gid) else 0
    gsz = np.bincount(gid, weights=csz.astype(np.float64),
                      minlength=ng).astype(np.int64)
    gb = np.bincount(gid, weights=bc.astype(np.float64),
                     minlength=ng)
    gw = np.zeros(ng)
    np.maximum.at(gw, gid, wc.astype(np.float64))
    tiles_g = -(-gsz // TILE)
    # per-tile layers: bands spread over the group's tiles (+1 seam/
    # conflict allowance); the window span is shared by every tile of the
    # strip (distinct windows lower-bound the span)
    L_g = np.clip(np.ceil(gb / np.maximum(tiles_g, 1)) + 1, 1, l_cap)
    W_g = np.clip(gw, 1, min(strip_windows, W_CAP))
    # +1 flat pass-1 conflict layer allowance (extra layers share the
    # window loads with layer 0; W-independent on the TPU)
    cost_g = tiles_g * (
        p.tile_base_ns
        + p.tile_w_ns * (W_g - 1)
        + p.tile_ov_ns + p.tile_wl_ns * W_g
        + p.tile_bnd_ns * L_g
    )
    # demotion: groups whose per-nnz cost exceeds the element residual
    demote = cost_g > p.residual_ns * gsz
    # pass-1 conflict eviction: rank >= L1_CAP entries fall to the
    # residual (the clustered-column failure mode that makes unranked
    # R-MAT plans terrible).  Measured EXACTLY on a subsample of whole
    # groups (uniform nnz sampling would thin the cells and hide the
    # multiplicity), then extrapolated.
    evict_frac = 0.0
    keep_ids = np.nonzero(~demote)[0]
    if conflict_sample and len(keep_ids):
        kept_nnz = gsz[keep_ids]
        order_g = np.argsort(-kept_nnz)
        budget = min(int(kept_nnz.sum()), 600_000)
        csum = np.cumsum(kept_nnz[order_g])
        take = order_g[: max(int(np.searchsorted(csum, budget)), 1) + 1]
        sample = np.zeros(ng, bool)
        sample[keep_ids[take]] = True
        # the sample needs actual coordinates: per-nnz mcell (computed
        # lazily — only the two cheapest strip widths pay this pass)
        rows = rows.astype(np.int64, copy=False)
        cols = cols.astype(np.int64, copy=False)
        mcell = ((cols // WINDOW) // strip_windows) * nbb \
            + (rows // WINDOW) // l_cap
        sel = sample[gid[np.searchsorted(uc, mcell)]]
        if sel.any():
            rs, cs = rows[sel], cols[sel]
            mcs = mcell[sel]
            o = np.lexsort((cs, rs, mcs))
            rs, cs = rs[o], cs[o]
            # approximate slot layout: 127-lane payload packing per group
            grp_s = np.searchsorted(np.unique(mcs), mcs[o])
            first = np.concatenate(
                [[0], np.cumsum(np.bincount(grp_s))]
            )[:-1]
            within = np.arange(len(rs)) - first[grp_s]
            slot = within % PAYLOAD
            srow = slot // 127
            tile_s = grp_s * np.int64(1 << 20) + within // PAYLOAD
            cellk = (tile_s * 8 + srow) * 128 + cs % 128
            gsk = (cs // WINDOW) * 8 + (cs // 128) % 8
            rk = _distinct_rank(cellk, gsk, width=8 * nwin)
            evict_frac = float((rk >= L1_CAP).mean())
    est = float(cost_g[~demote].sum()) \
        + p.residual_ns * float(gsz[demote].sum()) + 2 * p.launch_ns \
        + p.residual_ns * evict_frac * float(gsz[~demote].sum())
    tiles = int(tiles_g[~demote].sum())
    lbar = float((tiles_g[~demote] * L_g[~demote]).sum()) / max(tiles, 1)
    # per-slot words: vals + slot + gsub + bl (2 layers/word) + bs (4)
    words = 3 + -(-lbar // 2) + -(-lbar // 4)
    stream_bytes = int(tiles * TILE * 4 * words)
    kept = int(gsz[~demote].sum())
    return {
        "tiles": tiles,
        "est_ns": est,
        "stream_bytes": stream_bytes,
        "fill": kept / max(tiles * TILE, 1),
        "residual": int(gsz[demote].sum()),
    }


def routed_vmem_ok(shape: tuple, profile: DeviceProfile = V5E) -> bool:
    """Whether one routed plan serves ``shape``: its pow-2 padded x and y
    fit ``profile.routed_band_budget_bytes``.  The TPU kernel keeps both
    VMEM-resident, so under ``V5E`` million-row matrices (soc-Pokec
    scale) take the banded cell grid instead."""
    nwin = max(-(-shape[1] // WINDOW), 1)
    nyt = max(-(-shape[0] // WINDOW), 1)

    def b(n):
        k = 1
        while k < n:
            k *= 2
        return k

    return (b(nwin) + b(nyt)) * 8 * 128 * 4 \
        <= profile.routed_band_budget_bytes


def best_routed_estimate(
    rows: np.ndarray, cols: np.ndarray, shape: tuple, l_cap: int = L_CAP,
    profile: DeviceProfile = V5E,
) -> dict:
    """Cheapest ``estimate_routed_cost_ns`` over the auto strip widths —
    the estimate the DSE should use, mirroring build_routed_plan's auto
    mode.  The pass-1 conflict-eviction sample (the term that separates
    ranked from unranked plans on clustered matrices) is only measured
    for the two cheapest strip widths — it costs a sample sort."""
    table = winband_table(rows, cols, shape)
    ests = sorted(
        (
            estimate_routed_cost_ns(
                rows, cols, shape, strip_windows=sw, l_cap=l_cap,
                table=table, profile=profile,
            )["est_ns"],
            sw,
        )
        for sw in (2, 4, 8, 16, 32)
    )
    return min(
        (
            estimate_routed_cost_ns(
                rows, cols, shape, strip_windows=sw, l_cap=l_cap,
                conflict_sample=True, table=table, profile=profile,
            )
            for _, sw in ests[:2]
        ),
        key=lambda e: e["est_ns"],
    )


def plan_cost_ns(plan: RoutedPlan, profile: DeviceProfile = V5E) -> float:
    """Modeled execution cost of a plan under ``profile``: every tile pays
    its class's full caps (the unconditional kernel runs all lmax layers
    and the full W select tree; padding adds exact zeros)."""
    p = profile
    t = 0.0
    for s in plan.streams:
        # extra slab layers share the window loads with layer 0
        # (on the TPU, W=16 l1 2->4 did not pay another tree)
        t += p.launch_ns + s.num_tiles * (
            p.tile_base_ns
            + p.tile_w_ns * (s.wmax - 1)
            + (p.tile_ov_ns + p.tile_wl_ns * s.wmax) * (s.l1 - 1)
            + p.tile_bnd_ns * s.lmax
        )
    t += p.residual_ns * len(plan.residual_vals)
    if plan.gathered is not None:
        from hispmv_tpu_torch.plan.gathered import gathered_cost_ns

        t += gathered_cost_ns(
            plan.gathered.num_tiles, plan.gathered.num_windows,
            plan.gathered.num_panels, profile=profile,
        )
    return t


def build_routed_plan(
    coo: COOMatrix,
    strip_windows: int = 0,
    l1_cap: int = L1_CAP,
    l_cap: int = L_CAP,
    max_streams: int = 6,
    profile: DeviceProfile = V5E,
) -> RoutedPlan:
    """Build a routed plan under ``profile``'s costs; ``strip_windows=0``
    (auto) ranks strip widths {2, 4, 8, 16, 32} by the cheap macro-cell
    estimate (wider strips raise nnz per band cell — fewer boundary layers
    per tile — at a per-window select-tree cost), builds the best, and
    retries at the
    runner-up when demotion made the residual heavy, keeping the plan
    with the lower modeled cost."""
    if strip_windows == 0:
        with span("plan.routed.estimate"):
            table = winband_table(coo.rows, coo.cols, coo.shape)
            ests = sorted(
                (
                    estimate_routed_cost_ns(
                        None, None, coo.shape,
                        strip_windows=sw, l_cap=l_cap, table=table,
                        profile=profile,
                    )["est_ns"],
                    sw,
                )
                for sw in (2, 4, 8, 16, 32)
            )
        sw0, sw1 = ests[0][1], ests[1][1]
        plan = _build_routed_plan(coo, sw0, l1_cap, l_cap, max_streams,
                                  profile=profile)
        res_cost = profile.residual_ns * len(plan.residual_vals)
        if res_cost > 0.10 * plan_cost_ns(plan, profile):
            alt = _build_routed_plan(coo, sw1, l1_cap, l_cap, max_streams,
                                     profile=profile)
            if plan_cost_ns(alt, profile) < plan_cost_ns(plan, profile):
                plan, sw0 = alt, sw1
        return _repack_residual(plan, sw0, l1_cap, l_cap, profile)
    plan = _build_routed_plan(
        coo, strip_windows, l1_cap, l_cap, max_streams, profile=profile
    )
    return _repack_residual(plan, strip_windows, l1_cap, l_cap, profile)


@traced("plan.routed.repack")
def _repack_residual(
    plan: RoutedPlan, strip_windows: int, l1_cap: int, l_cap: int,
    profile: DeviceProfile = V5E,
) -> RoutedPlan:
    """Re-plan the demoted/evicted entries into their own tiles (one
    recursion level, iterated).  Entries evicted for exceeding a layer
    cap inside a FULL tile get fresh budgets in fresh tiles, so most of
    the residual packs back at vector rate.  Wider strips are also tried:
    scattered leftovers that were hopeless at the main plan's strip width
    often pack at high fill when strips are wide (the select tree is
    cheap: ``tile_w_ns`` a window)."""
    while True:
        nxt = _repack_residual_once(plan, strip_windows, l1_cap, l_cap,
                                    profile)
        if nxt is plan:
            return plan
        plan = nxt


def _repack_residual_once(
    plan: RoutedPlan, strip_windows: int, l1_cap: int, l_cap: int,
    profile: DeviceProfile = V5E,
) -> RoutedPlan:
    nres = len(plan.residual_vals)
    free = RoutedPlan.MAX_STREAMS - len(plan.streams)
    if nres < 64 or free <= 0:
        return plan
    rcoo = COOMatrix(
        plan.shape,
        plan.residual_rows,
        plan.residual_cols,
        plan.residual_vals,
    )
    # widest sensible strips for the leftover (it is scattered by
    # construction), unless the caller pinned a width
    rplan = _build_routed_plan(
        rcoo, max(strip_windows, 32), l1_cap, l_cap, max_streams=free,
        allow_gathered=plan.gathered is None, profile=profile,
    )
    if not rplan.streams and rplan.gathered is None:
        return plan
    # Accept-or-reject the repack as a WHOLE (streams + gathered side-plan
    # + residual).  rplan's gathered plan is adopted only on accept — a
    # graft on the reject path would leave the diverted nnz both in the
    # side-plan and in plan.residual_* (executed twice).  plan_cost_ns
    # includes the gathered side-plan's modeled cost, so diverted nnz are
    # charged what they cost rather than counted as pure residual savings.
    gain = profile.residual_ns * (nres - len(rplan.residual_vals))
    cost = plan_cost_ns(rplan, profile) \
        - profile.residual_ns * len(rplan.residual_vals)
    if cost >= gain:
        return plan
    slots = plan.streams + rplan.streams
    fields = {
        f"s{i}": (slots[i] if i < len(slots) else None)
        for i in range(RoutedPlan.MAX_STREAMS)
    }
    return dataclasses.replace(
        plan,
        residual_rows=rplan.residual_rows,
        residual_cols=rplan.residual_cols,
        residual_vals=rplan.residual_vals,
        gathered=rplan.gathered if rplan.gathered is not None
        else plan.gathered,
        **fields,
    )


def _bucket_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _finish_gathered(gath_parts, shape, nwinp, res_parts):
    """Build the gathered side-plan from diverted chunks; its spills are
    appended to ``res_parts`` (in place).  Returns the plan or None."""
    if not gath_parts:
        return None
    from hispmv_tpu_torch.plan.gathered import build_gathered_plan

    gr = np.concatenate([p[0] for p in gath_parts])
    gc = np.concatenate([p[1] for p in gath_parts])
    gv = np.concatenate([p[2] for p in gath_parts])
    plan, sr, sc, sv = build_gathered_plan(gr, gc, gv, shape, nwinp)
    if len(sr):
        res_parts.append((sr, sc, sv))
    return plan


def _tile_stats_py(T0, tile_of, p_win, p_band, real, nyt):
    """Plain numpy version of ``native.routed_tile_stats``: per tile (nnz,
    window min, window span, distinct bands)."""
    nnz_t = np.bincount(tile_of[real], minlength=T0)
    wmin_t = np.full(T0, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(wmin_t, tile_of, p_win)
    wmax_t = np.zeros(T0, np.int64)
    np.maximum.at(wmax_t, tile_of, p_win)
    span_t = wmax_t - wmin_t + 1
    tb = np.unique(tile_of * np.int64(nyt) + p_band)
    band_t = np.bincount((tb // nyt).astype(np.int64), minlength=T0)
    return nnz_t, wmin_t, span_t, band_t


@traced("plan.routed.build")
def _build_routed_plan(
    coo: COOMatrix,
    strip_windows: int,
    l1_cap: int = L1_CAP,
    l_cap: int = L_CAP,
    max_streams: int = 6,
    w_cap: int = W_CAP,
    allow_gathered: bool = True,
    profile: DeviceProfile = V5E,
) -> RoutedPlan:
    p = profile
    l1_cap = min(l1_cap, L1_CAP)  # the rank field is 3 bits
    R, C = coo.shape
    nwin = max(-(-C // WINDOW), 1)
    nyt = max(-(-R // WINDOW), 1)

    # All slot-level arrays are int32: every suite matrix has R, C and
    # the padded slot count N below 2^31, and int64 numpy passes over
    # 30M-element arrays measured ~2x slower (memory-bound)
    rows = coo.rows.astype(np.int32)
    cols = coo.cols.astype(np.int32)
    vals = coo.values.astype(np.float32)

    if coo.nnz == 0:
        return RoutedPlan(
            shape=(R, C), nnz=0, num_windows=nwin, num_ytiles=nyt,
            s0=None, s1=None, s2=None,
            residual_rows=rows, residual_cols=cols, residual_vals=vals,
        )

    # macro cell = (column strip, block of l_cap row bands): padding tiles
    # to cell boundaries caps both the window span (<= strip_windows) and
    # bands/tile (<= l_cap) by construction
    nbb = max(-(-nyt // l_cap), 1)

    def _div(a, d):
        # pow-2 divides compile to shifts (int64 // is the slowest numpy
        # op on these array sizes)
        return a >> int(d).bit_length() - 1 if d & (d - 1) == 0 else a // d

    mcell = (
        _div(cols >> 10, strip_windows) * np.int32(nbb)
        + _div(rows >> 10, l_cap)
    ).astype(np.int32)
    order = _sort_mrc(mcell, rows, cols, R, C)
    rows, cols, vals = rows[order], cols[order], vals[order]
    mcell = mcell[order]

    # ---- merge cells into tile groups, pad groups to whole tiles --------
    # Cells of one STRIP share the window budget, so consecutive
    # same-strip cells can share tiles as long as their combined
    # distinct-band count stays within the boundary-layer cap (only seam
    # tiles mix bands; interior tiles keep their cell's).  This is what
    # keeps fill high when cells are much smaller than a tile.
    uc, sstart = np.unique(mcell, return_index=True)
    ssize = np.diff(np.concatenate([sstart, [len(rows)]]))
    ub = np.unique(mcell.astype(np.int64) * np.int64(nyt) + (rows >> 10))
    bc = np.bincount(
        np.searchsorted(uc, ub // nyt), minlength=len(uc)
    )
    strip_of = uc // nbb
    gid = _greedy_merge(strip_of, bc, l_cap)
    gsz = np.bincount(gid, weights=ssize.astype(np.float64)).astype(
        np.int64
    )
    # every tile reserves its 8 lane-0 slots as zero pads (see the
    # PAYLOAD comment), so tiles hold 8 x 127 real slots
    gpad = -(-gsz // PAYLOAD) * TILE
    T0 = int(gpad.sum() // TILE)
    N = T0 * TILE
    goff = np.concatenate([[0], np.cumsum(gpad)])[:-1].astype(np.int64)
    gfirst = np.concatenate([[0], np.cumsum(gsz)])[:-1]
    within = (
        np.arange(len(rows), dtype=np.int64) - np.repeat(gfirst, gsz)
    ).astype(np.int32)
    wt, wp = within // PAYLOAD, within % PAYLOAD
    pos = (
        np.repeat(goff, gsz).astype(np.int64)
        + wt.astype(np.int64) * TILE + (wp // 127) * 128 + 1 + wp % 127
    )

    p_rows = np.full(N, -1, np.int32)
    p_cols = np.zeros(N, np.int32)
    p_vals = np.zeros(N, np.float32)
    p_rows[pos] = rows
    p_cols[pos] = cols
    p_vals[pos] = vals
    pad = p_rows < 0
    if pad.any():
        # padding duplicates the previous real slot with value 0: extends
        # its run, keeps a consistent (window, lane, sub) source
        idx = np.where(~pad, np.arange(N, dtype=np.int32), np.int32(0))
        np.maximum.accumulate(idx, out=idx)
        p_rows = p_rows[idx]
        p_cols = p_cols[idx]
    # reserved lane-0 slots must extend the run that FOLLOWS them (a
    # backward fill would move run ends/starts onto lane 0, or borrow the
    # previous tile's row and charge a foreign band chain): forward-fill
    # every lane-0 slot from its lane-1 neighbor
    l0 = np.arange(0, N, 128)
    p_rows[l0] = p_rows[l0 + 1]
    p_cols[l0] = p_cols[l0 + 1]

    # ---- per-tile stats + demotion to residual --------------------------
    aridx = np.arange(N, dtype=np.int32)
    tile_of = aridx >> 10
    p_win = p_cols >> 10
    p_band = p_rows >> 10
    real = ~pad

    def tile_stats(T0, tile_of, p_win, p_band, real):
        # native; _tile_stats_py is the plain version
        return tuple(a.astype(np.int64)
                     for a in native.routed_tile_stats(p_win, p_band, ~real))

    nnz_t, wmin_t, span_t, band_t = tile_stats(
        T0, tile_of, p_win, p_band, real
    )
    # Pre-demote boundary-layer estimate from RUN-level conflicts: the
    # band count alone understates lmax badly on scattered tiles (the
    # conflict ranks + chain stacking dominate there), which is exactly
    # the class the gathered diversion below exists for.  All ops here
    # are runs-sized (~rows), not nnz-sized.
    brk0 = np.ones(N, bool)
    brk0[1:] = (p_rows[1:] != p_rows[:-1]) | (
        (aridx[1:] & np.int32(1023)) == 0)
    st0 = np.nonzero(brk0)[0]
    en0 = np.concatenate([st0[1:], [N]]) - 1
    rr0 = p_rows[st0]
    et0 = (st0 >> 10).astype(np.int64)
    eb0 = (rr0 >> 10).astype(np.int64)
    sy0 = ((rr0 & 1023) >> 7).astype(np.int64)
    al0 = (en0 & 1023) % 128
    ra0 = _distinct_rank(
        ((et0 * nyt + eb0) * 8 + sy0) * 128 + al0, (en0 & 1023) // 128
    )
    tb0 = et0 * np.int64(nyt) + eb0
    ukb0, invb0 = np.unique(tb0, return_inverse=True)
    need0 = np.zeros(len(ukb0), np.int64)
    np.maximum.at(need0, invb0, ra0 + 1)
    L_pre = np.zeros(T0, np.int64)
    np.add.at(L_pre, (ukb0 // nyt).astype(np.int64), need0)
    cost_t = (
        p.tile_base_ns
        + p.tile_w_ns * np.maximum(span_t - 1, 0)
        + p.tile_wl_ns * span_t
        + p.tile_bnd_ns * np.maximum(np.maximum(band_t, L_pre), 1)
    )
    demote = (
        (cost_t > p.residual_ns * nnz_t)
        | (band_t > l_cap)
        | (span_t > w_cap)
    )

    res_parts = []  # (rows, cols, vals) chunks headed for the residual
    gath_parts = []  # chunks headed for the gathered side-plan
    if allow_gathered:
        # Divert tiles whose modeled cost exceeds the gathered
        # executor's per-nnz cost with margin (plan/gathered.py): the
        # gathered path removes span/l1/boundary terms entirely for
        # scattered short rows (its own spill rules return what it
        # cannot take).
        gath_per_nnz = (p.gath_tile_ns + 3 * p.gath_stage_ns) / 1000.0
        # what the tile will ACTUALLY be charged: its class buckets lmax
        # to a power of two and the merge charges group maxima, and the
        # kernel runs ~l1 extra pass-1 layers — cost_t (used for the
        # demote-to-residual rule) reflects none of that
        Lb = np.maximum(np.maximum(band_t, L_pre), 1)
        Lb2 = np.int64(1) << np.int64(
            np.ceil(np.log2(np.maximum(Lb, 1))))
        cost_cls = (
            p.tile_base_ns
            + p.tile_w_ns * np.maximum(span_t - 1, 0)
            + (p.tile_ov_ns + p.tile_wl_ns * span_t) * 2.0
            + p.tile_bnd_ns * Lb2
        )
        to_gather = (
            ~demote
            & (cost_cls > 1.25 * gath_per_nnz * np.maximum(nnz_t, 1))
        )
        # Honest acceptance: the gathered executor's S1/S2 stages walk
        # ALL of each panel's K x-windows, and panels are cut as soon as
        # any window's cumulative fan-out hits FANOUT_CAP — so window
        # CONCENTRATION in the diverted set drives the panel count P,
        # and the true stage cost is (2*P*K + T) windows, not 3/tile.
        # (Round 4 shipped the 3/tile assumption; measured end-to-end it
        # LOST on its target matrix — language 9.0 -> 7.2 GFLOP/s —
        # because hub windows forced ~5-tile panels.)  Estimate P from
        # the candidates' per-window edge histogram and accept the
        # diversion only if the honest model still saves.
        gross = float(cost_cls[to_gather].sum())
        if to_gather.any():
            from hispmv_tpu_torch.plan.gathered import (
                FANOUT_CAP, gathered_cost_ns)

            Kp = _bucket_pow2(nwin)
            mg = to_gather[tile_of] & real & (p_vals != 0.0)
            ng = int(mg.sum())
            tg = max(ng // int(TILE * 0.9), 1)
            e_w = np.bincount(p_win[mg], minlength=1)
            e_max_per_tile = float(e_w.max()) / tg
            pw_est = max(1.0, min(
                float(Kp), FANOUT_CAP / max(e_max_per_tile, 1.0)))
            p_est = int(np.ceil(tg / pw_est))
            # gcost already includes the measured launch+glue intercept
            # (gath_launch_ns); the margin only guards model noise
            gcost = gathered_cost_ns(tg, Kp, p_est, profile=p)
            if gross - gcost < 10e3:
                to_gather[:] = False
        if to_gather.any():
            m = to_gather[tile_of] & real & (p_vals != 0.0)
            gath_parts.append((p_rows[m], p_cols[m], p_vals[m]))
            demote = demote | to_gather
    if demote.any():
        m = demote[tile_of] & real
        if gath_parts:
            # gathered tiles are not residual: re-mask to the demoted-
            # only tiles for the residual chunk
            only_res = demote & ~to_gather if allow_gathered else demote
            m = only_res[tile_of] & real
        res_parts.append((p_rows[m], p_cols[m], p_vals[m]))
        keep_slots = ~demote[tile_of]
        p_rows, p_cols, p_vals = (
            p_rows[keep_slots], p_cols[keep_slots], p_vals[keep_slots]
        )
        pad = pad[keep_slots]
        real = ~pad
        N = len(p_rows)
        T0 = N // TILE
        aridx = np.arange(N, dtype=np.int32)
        tile_of = aridx >> 10
        p_win = p_cols >> 10
        p_band = p_rows >> 10
        nnz_t, wmin_t, span_t, band_t = tile_stats(
            T0, tile_of, p_win, p_band, real
        )

    if T0 == 0:
        gathered = _finish_gathered(
            gath_parts, (R, C), _bucket_pow2(nwin), res_parts
        )
        rr, rc, rv = (
            np.concatenate([p[0] for p in res_parts])
            if res_parts else np.zeros(0, np.int64),
            np.concatenate([p[1] for p in res_parts])
            if res_parts else np.zeros(0, np.int64),
            np.concatenate([p[2] for p in res_parts])
            if res_parts else np.zeros(0, np.float32),
        )
        return RoutedPlan(
            shape=(R, C), nnz=coo.nnz, num_windows=nwin, num_ytiles=nyt,
            s0=None, s1=None, s2=None,
            residual_rows=rr, residual_cols=rc, residual_vals=rv,
            gathered=gathered,
        )

    # ---- pass-1 slab layering: per-cell distinct-source ranks -----------
    # A composed two-level gather consults the sub grid at (target
    # sublane, SOURCE lane): per such CELL, one (window, sub) source per
    # layer.  Every layer is a full select tree over the tile's span, so
    # layer l simply serves each cell's l-th distinct source; ranks
    # beyond l1_cap (three 9-bit fields per i32) are evicted and
    # repacked into fresh tiles.
    src_lane = p_cols & np.int32(127)
    src_sub = (p_cols >> 7) & np.int32(7)
    win_local = (p_win - wmin_t[tile_of]).astype(np.int32)
    j_of = aridx & np.int32(127)
    s_of = (aridx >> 7) & np.int32(7)
    ridx = np.nonzero(real)[0]
    cell = (
        (tile_of[ridx].astype(np.int64) * 8 + s_of[ridx]) * 128
        + src_lane[ridx]
    )
    gs = (win_local[ridx] * np.int32(8) + src_sub[ridx]).astype(np.int64)
    layer1 = _distinct_rank(cell, gs, width=512)

    evict1 = layer1 >= l1_cap
    if evict1.any():
        e = ridx[evict1]
        res_parts.append((p_rows[e], p_cols[e], p_vals[e].copy()))
        p_vals[e] = 0.0
        keep = ~evict1
        ridx = ridx[keep]
        cell, gs, layer1 = cell[keep], gs[keep], layer1[keep]

    l1_t = np.ones(T0, np.int64)
    np.maximum.at(l1_t, tile_of[ridx], layer1 + 1)

    # ---- row runs & boundary entries (two-sided, v3 machinery) ----------
    brk = np.ones(N, bool)
    brk[1:] = (p_rows[1:] != p_rows[:-1]) | ((aridx[1:] & np.int32(1023)) == 0)
    starts = np.nonzero(brk)[0]
    ends = np.concatenate([starts[1:], [N]]) - 1
    run_rows = p_rows[starts]

    e_tile = (starts // TILE).astype(np.int64)
    e_band = (run_rows // WINDOW).astype(np.int64)
    a_src = (ends % TILE).astype(np.int64)
    has_b = (starts % TILE) != 0
    b_src = np.where(has_b, (starts - 1) % TILE, 0).astype(np.int64)
    sy = ((run_rows % WINDOW) // 128).astype(np.int64)
    jy = (run_rows % 128).astype(np.int64)
    a_lane, a_sub = a_src % 128, a_src // 128
    b_lane, b_sub = b_src % 128, b_src // 128

    # conflict ranks within (tile, band, sy, source lane), sides separate
    grp_a = ((e_tile * nyt + e_band) * 8 + sy) * 128 + a_lane
    rank_a = _distinct_rank(grp_a, a_sub)
    rank_b = np.zeros(len(e_tile), np.int64)
    if has_b.any():
        hb = np.nonzero(has_b)[0]
        grp_b = ((e_tile[hb] * nyt + e_band[hb]) * 8 + sy[hb]) * 128 \
            + b_lane[hb]
        rank_b[hb] = _distinct_rank(grp_b, b_sub[hb])

    # band chains per tile
    tbkey = e_tile * np.int64(nyt) + e_band
    ukb, invb = np.unique(tbkey, return_inverse=True)
    needb = np.zeros(len(ukb), np.int64)
    np.maximum.at(needb, invb, np.maximum(rank_a, rank_b) + 1)
    firstb = np.full(len(ukb), N, np.int64)
    np.minimum.at(firstb, invb, starts)
    baseb = _chain_bases(ukb // nyt, ukb % nyt, needb, firstb)
    layer_a = baseb[invb] + rank_a
    layer_b = baseb[invb] + rank_b

    evict_run = (layer_a >= l_cap) | (has_b & (layer_b >= l_cap))
    if evict_run.any():
        # zero the run's slots (extends the neighbor run with zeros — the
        # prefix sums of every other run are unchanged) and residualize
        er = np.nonzero(evict_run)[0]
        slot_mask = np.zeros(N + 1, np.int64)
        np.add.at(slot_mask, starts[er], 1)
        np.add.at(slot_mask, ends[er] + 1, -1)
        in_evicted = np.cumsum(slot_mask[:-1]) > 0
        m = in_evicted & real & (p_vals != 0.0)
        res_parts.append((p_rows[m], p_cols[m], p_vals[m].copy()))
        p_vals[m] = 0.0
        kr = ~evict_run
        e_tile, e_band, sy, jy = e_tile[kr], e_band[kr], sy[kr], jy[kr]
        a_lane, a_sub = a_lane[kr], a_sub[kr]
        b_lane, b_sub = b_lane[kr], b_sub[kr]
        has_b, layer_a, layer_b = has_b[kr], layer_a[kr], layer_b[kr]

    L_t = np.zeros(T0, np.int64)
    if len(e_tile):
        np.maximum.at(L_t, e_tile, layer_a + 1)
        hb2 = np.nonzero(has_b)[0]
        if len(hb2):
            np.maximum.at(L_t, e_tile[hb2], layer_b[hb2] + 1)
    L_t = np.maximum(L_t, 1)
    byt_l = np.zeros((T0, l_cap), np.int32)
    for chains in [None]:
        ct = (ukb // nyt).astype(np.int64)
        cb = (ukb % nyt).astype(np.int32)
        reps = needb.astype(np.int64)
        tt = np.repeat(ct, reps)
        ll = np.repeat(baseb, reps) + (
            np.arange(int(reps.sum())) -
            np.repeat(np.concatenate([[0], np.cumsum(reps)])[:-1], reps)
        )
        bb = np.repeat(cb, reps)
        ok = ll < l_cap
        byt_l[tt[ok], ll[ok]] = bb[ok]

    # ---- class partition (up to max_streams by bucketed dims) -----------
    def _bucket(n, cap):
        b = 1
        while b < n:
            b *= 2
        return min(b, cap)

    wb = np.array([_bucket(int(v), w_cap) for v in span_t])
    l1b = np.array([_bucket(int(v), l1_cap) for v in l1_t])
    lb = np.array([_bucket(int(v), l_cap) for v in L_t])
    classes = (wb * 16 + l1b) * 64 + lb  # composite class key

    def _cls_dims(key):
        return int(key) // 1024, (int(key) // 64) % 16, int(key) % 64

    def _cls_cost(wv, l1v, lv):
        return (
            wv * p.tile_w_ns
            + (l1v - 1) * (p.tile_ov_ns + p.tile_wl_ns * wv)
            + lv * p.tile_bnd_ns
        )

    ucls, cls_inv, cls_cnt = np.unique(
        classes, return_inverse=True, return_counts=True
    )
    # order classes by PADDING cost; merge cheapest-adjacent until
    # <= max_streams, and keep merging while a merge beats the launch it
    # saves
    cls_cost = np.array([_cls_cost(*_cls_dims(k)) for k in ucls])
    corder = np.argsort(cls_cost)
    groups = [[i] for i in corder]
    while len(groups) > 1:
        best, bcost = None, None
        for gi in range(len(groups) - 1):
            a, b = groups[gi], groups[gi + 1]
            dims = [_cls_dims(ucls[i]) for i in a + b]
            la = _cls_cost(
                max(d[0] for d in dims), max(d[1] for d in dims),
                max(d[2] for d in dims),
            )
            added = sum(
                cls_cnt[i] * (la - cls_cost[i]) for i in a + b
            )
            if bcost is None or added < bcost:
                best, bcost = gi, added
        if len(groups) > max_streams or bcost < p.launch_ns:
            groups[best] = groups[best] + groups.pop(best + 1)
        else:
            break

    # ---- emit one compressed stream per class group (single pass) -------
    # All slot-level routing words are computed ONCE over the global slot
    # arrays (the per-stream re-scans of all N slots were the planner's
    # single largest cost on 30M-nnz matrices); per-stream arrays are then
    # one stable tile permutation + contiguous slices.

    def _grp_dims(g):
        ds = [_cls_dims(ucls[i]) for i in g]
        return (max(d[0] for d in ds), max(d[1] for d in ds),
                max(d[2] for d in ds))

    groups.sort(key=lambda g: _cls_cost(*_grp_dims(g)))
    gdims = [_grp_dims(g) for g in groups]
    sid_cls = np.empty(len(ucls), np.int32)
    for si, g in enumerate(groups):
        sid_cls[np.asarray(g)] = si
    sid_t = sid_cls[cls_inv]
    sW_t = np.array([d[0] for d in gdims], np.int64)[sid_t]

    # slab trees read windows [base, base+sW): clamp base left so reads
    # stay inside the executor's pow-2-padded x (edge tiles whose span <
    # the class span would otherwise read past the end); gs shifts by the
    # clamp delta
    nwinp = _bucket(nwin, 1 << 30)
    base_cl_t = np.maximum(np.minimum(wmin_t, nwinp - sW_t), 0)
    delta_t = wmin_t - base_cl_t  # >= 0 per tile

    # global slot word: lane | rank<<7 at slot positions (padding slots
    # carry a forward-filled lane and rank 0 — their value is 0); layer
    # 3-4 cell fields ride the free bits 10/19 (disjoint bit planes)
    p_layer = np.zeros(N, np.int32)
    p_layer[ridx] = layer1
    g_slot = (src_lane | (p_layer << np.int32(7))).astype(np.uint32)
    # global gsub word at (row, SOURCE-lane) CELL positions: layer-l
    # source (win_local<<3 | sub) at bits 9*l; within a layer, cells are
    # unique-or-equal by the rank construction, so OR-assign is exact
    g_gsub = np.zeros(N, np.uint32)
    cellpos = (tile_of[ridx] * 8 + s_of[ridx]) * 128 + src_lane[ridx]
    f_all = (gs + 8 * delta_t[tile_of[ridx]]).astype(np.uint32)
    lmax1 = int(layer1.max()) + 1 if len(layer1) else 0
    for l in range(lmax1):
        ml = layer1 == l
        if not ml.any():
            continue
        if l < 3:
            g_gsub[cellpos[ml]] |= f_all[ml] << np.uint32(9 * l)
        else:  # layers 3-4 ride the slot word's free bits
            g_slot[cellpos[ml]] |= f_all[ml] << np.uint32(10 + 9 * (l - 3))
    g_vals = p_vals.astype(np.float32, copy=True)
    # force the reserved zero slots (P'[0,0] == 0 is what lets boundary/
    # start pointers skip validity bits entirely)
    g_vals.reshape(-1, 128)[:, 0] = 0.0

    # stable tile permutation: stream s's tiles contiguous, cheapest
    # class first (grid pipelines stream large/cheap classes first)
    torder = np.argsort(sid_t, kind="stable")
    tpos = np.empty(T0, np.int64)
    tpos[torder] = np.arange(T0)
    Ts_s = np.bincount(sid_t, minlength=len(groups))
    off_s = np.concatenate([[0], np.cumsum(Ts_s)])
    gpos_e = tpos[e_tile]  # permuted position per boundary entry
    sid_e = sid_t[e_tile]

    vals_p = g_vals.reshape(T0, TILE)[torder]
    slot_p = g_slot.reshape(T0, TILE)[torder]
    gsub_p = g_gsub.reshape(T0, TILE)[torder]
    byt_p = byt_l[torder]
    lt_p = L_t[torder]
    base_p = base_cl_t[torder]

    streams = []
    for si, (sW, sl1, sL) in enumerate(gdims):
        Ts = int(Ts_s[si])
        if Ts == 0:
            continue
        lo, hi = int(off_s[si]), int(off_s[si + 1])
        vals_s = vals_p[lo:hi].reshape(Ts, 8, 128)
        slot_s = slot_p[lo:hi].view(np.int32).reshape(Ts, 8, 128)
        gsub_s = gsub_p[lo:hi].view(np.int32).reshape(Ts, 8, 128)

        # Bitfield accumulation for bl/bs: contributions are split into
        # CLASSES whose cells are unique (per-(cell, layer) dedup + one
        # class per layer slot within a word), so each class is a plain
        # vectorized OR-assign into the uint32 output.
        def _acc(classes, size):
            out = np.zeros(size, np.uint32)
            for cells, w in classes:
                if len(cells):
                    out[cells] |= w.astype(np.uint32)
            return out.view(np.int32)

        npair = -(-sL // 2)
        nquad = -(-sL // 4)
        esel = sid_e == si
        et = gpos_e[esel] - lo
        ea, eb = layer_a[esel], layer_b[esel]
        ey, ej = sy[esel], jy[esel]
        al, as_ = a_lane[esel], a_sub[esel]
        bll, bss = b_lane[esel], b_sub[esel]
        hb3 = np.nonzero(has_b[esel])[0]
        # bl: boundary entries are unique per (tile, layer, sy, jy); one
        # class per (side, word parity).  NO validity bits — absent
        # sides/entries stay 0 and read the reserved zero slot (0, 0)
        cp = ((et * npair + ea // 2) * 8 + ey) * 128 + ej
        bl_classes = []
        for par in (0, 1):
            m = (ea % 2) == par
            bl_classes.append((cp[m], al[m] << (14 * par)))
        if len(hb3):
            cb = ((et[hb3] * npair + eb[hb3] // 2) * 8 + ey[hb3]) * 128 \
                + ej[hb3]
            ebh = eb[hb3]
            for par in (0, 1):
                m = (ebh % 2) == par
                bl_classes.append(
                    (cb[m], (bll[hb3][m] << 7) << (14 * par))
                )
        bl_s = _acc(bl_classes, Ts * npair * TILE).reshape(
            Ts, npair, 8, 128
        )
        # bs: dedup per (cell, layer, side) — same-layer entries sharing a
        # (sy, source lane) share the sub by the rank construction
        cqa = ((et * nquad + ea // 4) * 8 + ey) * 128 + al
        pka = cqa * 4 + ea % 4
        oa = np.argsort(pka, kind="stable")
        fa = np.ones(len(oa), bool)
        fa[1:] = pka[oa][1:] != pka[oa][:-1]
        foa = oa[fa]
        laf = ea[foa] % 4
        bs_classes = [
            (cqa[foa][laf == q], as_[foa][laf == q] << (8 * q))
            for q in range(4)
        ]
        if len(hb3):
            cqb = ((et[hb3] * nquad + eb[hb3] // 4) * 8 + ey[hb3]) * 128 \
                + bll[hb3]
            pkb = cqb * 4 + eb[hb3] % 4
            ob = np.argsort(pkb, kind="stable")
            fb = np.ones(len(ob), bool)
            fb[1:] = pkb[ob][1:] != pkb[ob][:-1]
            fob = ob[fb]
            lbf = eb[hb3][fob] % 4
            bs_classes += [
                (
                    cqb[fob][lbf == q],
                    (bss[hb3][fob][lbf == q] << 4) << (8 * q),
                )
                for q in range(4)
            ]
        bs_s = _acc(bs_classes, Ts * nquad * TILE).reshape(
            Ts, nquad, 8, 128
        )

        streams.append(RoutedStream(
            num_tiles=Ts, wmax=int(sW), l1=int(sl1), lmax=int(sL),
            vals=vals_s, slot=slot_s, gsub=gsub_s, bl=bl_s, bs=bs_s,
            base=base_p[lo:hi].astype(np.int32),
            byt=byt_p[lo:hi, :sL].astype(np.int32),
            lt=lt_p[lo:hi].astype(np.int32),
        ))

    # groups were emitted cheapest-class-first; the merge loop guarantees
    # len(streams) <= max_streams <= MAX_STREAMS
    assert len(streams) <= RoutedPlan.MAX_STREAMS
    gathered = _finish_gathered(gath_parts, (R, C), nwinp, res_parts)
    if res_parts:
        rr = np.concatenate([p[0] for p in res_parts])
        rc = np.concatenate([p[1] for p in res_parts])
        rv = np.concatenate([p[2] for p in res_parts])
    else:
        rr = np.zeros(0, np.int64)
        rc = np.zeros(0, np.int64)
        rv = np.zeros(0, np.float32)

    return RoutedPlan(
        shape=(R, C), nnz=coo.nnz, num_windows=nwin, num_ytiles=nyt,
        residual_rows=rr, residual_cols=rc, residual_vals=rv,
        gathered=gathered,
        **{
            f"s{i}": (streams[i] if i < len(streams) else None)
            for i in range(RoutedPlan.MAX_STREAMS)
        },
    )


def build_ranked_routed_plan(
    coo: COOMatrix,
    strip_windows: int = 0,
    l1_cap: int = L1_CAP,
    l_cap: int = L_CAP,
    max_streams: int = 6,
    profile: DeviceProfile = V5E,
) -> RoutedPlan:
    """Routed plan in RANK SPACE: rows and columns degree-sorted (stable,
    panel-local) before planning, so power-law nonzeros concentrate into
    dense tiles with small window spans and few band layers.  x/y are
    moved between original and rank space by the fast 3-stage permutation
    kernels (plan/permute.py).

    This is the planner's answer to the reference's HI crossbar + shared
    row balancing for scale-free matrices (base_functions.cpp:356-436,
    spmv-helper.cpp:265-347)."""
    from hispmv_tpu_torch.plan.permute import degree_rank_perms

    R, C = coo.shape
    rdeg = np.bincount(coo.rows, minlength=R)
    cdeg = np.bincount(coo.cols, minlength=C)
    rrank, row_perms = degree_rank_perms(rdeg)
    crank, col_perms = degree_rank_perms(cdeg)
    ranked = COOMatrix(
        (R, C),
        rrank[coo.rows.astype(np.int64)],
        crank[coo.cols.astype(np.int64)],
        coo.values,
    )
    plan = build_routed_plan(
        ranked, strip_windows, l1_cap, l_cap, max_streams, profile=profile
    )
    plan.col_perms = col_perms
    plan.row_perms = row_perms
    return plan


def _rank_of_perms(perms, n: int) -> np.ndarray:
    """rank[orig] from panel-local perms (inverse of the perm gather)."""
    rank = np.empty(n, np.int64)
    base = 0
    for p in perms:
        rank[base + p] = base + np.arange(len(p))
        base += len(p)
    assert base == n
    return rank


def _stream_matvec_numpy(
    s: RoutedStream, x2d: np.ndarray, y: np.ndarray
) -> None:
    """Golden executor for one stream, mirroring the kernel's exact
    dataflow (float64 accumulate), accumulating into ``y``."""
    lanes = np.arange(128)
    for t in range(s.num_tiles):
        slot = s.slot[t].view(np.uint32)
        gsub = s.gsub[t].view(np.uint32)
        lane = (slot & 127).astype(np.int64)
        rank = ((slot >> 7) & 7).astype(np.int64)
        base = int(s.base[t])
        # pass 1: per layer, a slab select tree over the span, then the
        # composed lane gather; the slot's rank picks its layer
        xg = np.zeros((8, 128), np.float64)
        for l in range(s.l1):
            src_w = gsub if l < 3 else slot
            sh = 9 * l if l < 3 else 10 + 9 * (l - 3)
            gsl = ((src_w >> sh) & 511).astype(np.int64)
            sub = gsl & 7
            vid = gsl >> 3
            acc = np.zeros((8, 128), np.float64)
            for v in range(s.wmax):
                win8 = x2d[(base + v) * 8 : (base + v) * 8 + 8]
                g = win8[sub, lanes[None, :]]
                acc = np.where(vid == v, g, acc)
            g = np.take_along_axis(acc, lane, axis=1)
            xg = np.where(rank == l, g, xg)
        p = s.vals[t].astype(np.float64) * xg
        # pass 2: flat inclusive prefix
        pf = np.cumsum(p.reshape(-1)).reshape(8, 128)
        # pass 3: two-sided boundary extraction (no validity bits —
        # absent sides read the reserved zero slot P'[0,0] == 0)
        for k in range(s.lmax):
            raw = (s.bl[t, k // 2].view(np.uint32) >> (14 * (k % 2))) \
                & 0x3FFF
            q = (s.bs[t, k // 4].view(np.uint32) >> (8 * (k % 4))) & 0xFF
            a_lane = (raw & 127).astype(np.int64)
            b_lane = ((raw >> 7) & 127).astype(np.int64)
            a_sub = (q & 7).astype(np.int64)
            b_sub = ((q >> 4) & 7).astype(np.int64)
            ga = np.take_along_axis(
                pf[a_sub, lanes[None, :]], a_lane, axis=1
            )
            gb = np.take_along_axis(
                pf[b_sub, lanes[None, :]], b_lane, axis=1
            )
            b = int(s.byt[t, k])
            y[b * WINDOW : (b + 1) * WINDOW] += (ga - gb).reshape(-1)


def routed_matvec_numpy(plan: RoutedPlan, x: np.ndarray) -> np.ndarray:
    """Golden numpy executor (float64 accumulate), incl. the residual and
    the rank-space in/out permutations when the plan carries them."""
    R, C = plan.shape
    if plan.col_perms is not None:
        perm = np.concatenate([
            base + p for base, p in zip(
                np.cumsum([0] + [len(p) for p in plan.col_perms[:-1]]),
                plan.col_perms,
            )
        ])
        x = np.asarray(x)[perm]
    # pad to the executor's pow-2 window count: the slab tree of an edge
    # tile may read (and discard) windows past num_windows
    nwp = 1
    while nwp < plan.num_windows:
        nwp *= 2
    xp = np.zeros(nwp * WINDOW, np.float64)
    xp[:C] = x
    x2d = xp.reshape(nwp * 8, 128)
    y = np.zeros(plan.num_ytiles * WINDOW, np.float64)
    for s in plan.streams:
        _stream_matvec_numpy(s, x2d, y)
    if plan.gathered is not None:
        from hispmv_tpu_torch.plan.gathered import gathered_matvec_numpy

        yg = gathered_matvec_numpy(plan.gathered, xp.astype(np.float32))
        y[: len(yg)] += yg
    if len(plan.residual_vals):
        np.add.at(
            y, plan.residual_rows,
            plan.residual_vals.astype(np.float64) * xp[plan.residual_cols],
        )
    y = y[:R]
    if plan.row_perms is not None:
        y = y[_rank_of_perms(plan.row_perms, R)]
    return y.astype(np.float32)


# ---------------------------------------------------------------------------
# Banded routed plans: matrices whose x + y exceed VMEM
# ---------------------------------------------------------------------------
#
# The reference handles arbitrary row counts by row tiles
# (spmv-helper.cpp:139-263, MAX_ROWS_PER_PE spmv.h:35); the routed format's
# analog is a grid of independent sub-plans.  Rows are cut into BANDS whose
# y tile set fits VMEM and columns into PANELS whose x slice fits VMEM;
# each non-empty (band, panel) cell is a self-contained RoutedPlan over
# LOCAL indices.  The executor slices x per panel (static offsets), runs
# each cell's streams, and sums panel results into the band's y.  A row
# whose run crosses a panel boundary simply splits into two runs whose
# partial sums accumulate — exactness is preserved by construction.

# Cell sizing: x panel (1024 windows = 4 MiB) + y band (512 tiles = 2 MiB)
# + the per-stream chunk double buffers stay inside the kernel's VMEM
# budget (routed_vmem_ok's 8 MiB pair bound).
BAND_ROWS = 512 * WINDOW  # 524288 rows -> 512 y tiles (2 MiB)
PANEL_COLS = 1024 * WINDOW  # 1 Mi cols -> 1024 windows (4 MiB)


@dataclasses.dataclass
class RoutedCell:
    """One (row band, column panel) cell of a banded routed plan.  The
    nested plan's row/col indices are LOCAL to (r0, c0)."""

    r0: int
    c0: int
    nrows: int
    ncols: int
    plan: RoutedPlan


@dataclasses.dataclass
class BandedRoutedPlan:
    """Routed execution for matrices whose x + y exceed VMEM (soc-Pokec
    scale): a grid of VMEM-feasible RoutedPlan cells (see module comment
    above).  With ``col_perms``/``row_perms`` the whole GRID is in rank
    space (global panel-local degree sort, as build_ranked_routed_plan):
    x is permuted in once, y permuted out once — power-law nonzeros then
    concentrate into the top-left cells."""

    shape: tuple
    nnz: int
    band_rows: int
    panel_cols: int
    cells: list  # of RoutedCell, band-major order
    col_perms: Optional[list] = None
    row_perms: Optional[list] = None

    @property
    def num_bands(self) -> int:
        return -(-self.shape[0] // self.band_rows)

    @property
    def num_panels(self) -> int:
        return -(-self.shape[1] // self.panel_cols)

    @property
    def num_tiles(self) -> int:
        return sum(c.plan.num_tiles for c in self.cells)

    @property
    def stream_bytes(self) -> int:
        return sum(c.plan.stream_bytes for c in self.cells)

    @property
    def residual_nnz(self) -> int:
        return sum(len(c.plan.residual_vals) for c in self.cells)

    @property
    def fill(self) -> float:
        slots = self.num_tiles * TILE
        return (self.nnz - self.residual_nnz) / max(slots, 1)


def build_banded_routed_plan(
    coo: COOMatrix,
    rank_sort: bool = False,
    band_rows: int = BAND_ROWS,
    panel_cols: int = PANEL_COLS,
    strip_windows: int = 0,
    max_streams: int = 4,
    profile: DeviceProfile = V5E,
) -> BandedRoutedPlan:
    """Partition ``coo`` into (band, panel) cells and build one RoutedPlan
    per non-empty cell.  ``rank_sort`` degree-sorts rows/cols FIRST
    (panel-local global perms, the scale-free concentration step) so hub
    nonzeros land in the top-left cells at high fill."""
    R, C = coo.shape
    rows = coo.rows.astype(np.int64)
    cols = coo.cols.astype(np.int64)
    vals = coo.values
    col_perms = row_perms = None
    if rank_sort:
        from hispmv_tpu_torch.plan.permute import degree_rank_perms

        rdeg = np.bincount(rows, minlength=R)
        cdeg = np.bincount(cols, minlength=C)
        rrank, row_perms = degree_rank_perms(rdeg)
        crank, col_perms = degree_rank_perms(cdeg)
        rows = rrank[rows]
        cols = crank[cols]

    nb = -(-R // band_rows)
    npn = -(-C // panel_cols)
    cell_of = (rows // band_rows) * npn + (cols // panel_cols)
    order = np.argsort(cell_of, kind="stable")
    bounds = np.searchsorted(
        cell_of[order], np.arange(nb * npn + 1)
    )
    cells = []
    for ci in range(nb * npn):
        lo, hi = bounds[ci], bounds[ci + 1]
        if lo == hi:
            continue
        bi, pi = divmod(ci, npn)
        r0, c0 = bi * band_rows, pi * panel_cols
        nrows = min(band_rows, R - r0)
        ncols = min(panel_cols, C - c0)
        sel = order[lo:hi]
        sub = COOMatrix(
            (nrows, ncols), rows[sel] - r0, cols[sel] - c0, vals[sel]
        )
        cells.append(RoutedCell(
            r0=r0, c0=c0, nrows=nrows, ncols=ncols,
            plan=build_routed_plan(
                sub, strip_windows=strip_windows, max_streams=max_streams,
                profile=profile,
            ),
        ))
    return BandedRoutedPlan(
        shape=coo.shape, nnz=coo.nnz, band_rows=band_rows,
        panel_cols=panel_cols, cells=cells,
        col_perms=col_perms, row_perms=row_perms,
    )


def estimate_banded_routed_ns(
    rows: np.ndarray,
    cols: np.ndarray,
    shape: tuple,
    rank_sort: bool = True,
    band_rows: int = BAND_ROWS,
    panel_cols: int = PANEL_COLS,
    profile: DeviceProfile = V5E,
) -> dict:
    """Model-only cost estimate of a banded routed plan: per-cell
    ``estimate_routed_cost_ns`` (strip widths 4 and 32) summed + one
    launch per cell stream-class.  Used by the DSE when
    ``routed_vmem_ok`` fails."""
    R, C = shape
    rows = rows.astype(np.int64)
    cols = cols.astype(np.int64)
    if rank_sort:
        # panel-local perms, exactly as build_banded_routed_plan builds
        # them — a global argsort would model a hub concentration the
        # built plan cannot achieve
        from hispmv_tpu_torch.plan.permute import degree_rank_perms

        rdeg = np.bincount(rows, minlength=R)
        cdeg = np.bincount(cols, minlength=C)
        rrank, _ = degree_rank_perms(rdeg)
        crank, _ = degree_rank_perms(cdeg)
        rows = rrank[rows]
        cols = crank[cols]
    nb = -(-R // band_rows)
    npn = -(-C // panel_cols)
    # band_rows/panel_cols are WINDOW multiples, so the global
    # (window, band) table partitions exactly into grid cells — the
    # per-cell estimates aggregate table slices, never re-scan the nnz
    t_win, t_band, t_cnt = winband_table(rows, cols, (R, C))
    bw = band_rows // WINDOW
    pw = panel_cols // WINDOW
    t_cell = (t_band // bw) * npn + (t_win // pw)
    order = np.argsort(t_cell, kind="stable")
    bounds = np.searchsorted(t_cell[order], np.arange(nb * npn + 1))
    est_ns = 0.0
    tiles = 0
    sbytes = 0
    residual = 0
    for ci in range(nb * npn):
        lo, hi = bounds[ci], bounds[ci + 1]
        if lo == hi:
            continue
        bi, pi = divmod(ci, npn)
        nrows = min(band_rows, R - bi * band_rows)
        ncols = min(panel_cols, C - pi * panel_cols)
        sel = order[lo:hi]
        local = (t_win[sel] - pi * pw, t_band[sel] - bi * bw, t_cnt[sel])
        e = min(
            (estimate_routed_cost_ns(
                None, None, (nrows, ncols), strip_windows=sw, table=local,
                profile=profile,
            ) for sw in (4, 8, 16, 32)),
            key=lambda d: d["est_ns"],
        )
        est_ns += e["est_ns"] + 2 * profile.launch_ns
        tiles += e["tiles"]
        sbytes += e["stream_bytes"]
        residual += int(e.get("residual", 0))
    return {
        "tiles": tiles, "est_ns": est_ns, "stream_bytes": sbytes,
        "residual": residual,
    }


def banded_routed_matvec_numpy(
    plan: BandedRoutedPlan, x: np.ndarray
) -> np.ndarray:
    """Golden numpy executor for a banded plan (float64 accumulate)."""
    R, C = plan.shape
    x = np.asarray(x, np.float64)
    if plan.col_perms is not None:
        perm = np.concatenate([
            base + p for base, p in zip(
                np.cumsum([0] + [len(p) for p in plan.col_perms[:-1]]),
                plan.col_perms,
            )
        ])
        x = x[perm]
    y = np.zeros(R, np.float64)
    for c in plan.cells:
        yc = routed_matvec_numpy(
            c.plan, x[c.c0:c.c0 + c.ncols].astype(np.float32)
        )
        y[c.r0:c.r0 + c.nrows] += yc.astype(np.float64)
    if plan.row_perms is not None:
        y = y[_rank_of_perms(plan.row_perms, R)]
    return y.astype(np.float32)
