"""Gathered-stream plan: scatter-free SpMV for scattered short rows.

Carried over from ``hispmv_tpu/plan/gathered.py`` (numpy and the port's
``plan/permute.py``), the wide-matrix guard included, so that both
packages build identical plans.  The modelled cost (``gathered_cost_ns``,
which the routed planner's diversion gate weighs) takes the costs of a
``DeviceProfile`` (``gath_*_ns``; ``V5E`` holds the JAX package's values,
from ``hispmv_tpu/plan/gathered.py``).  The executor is
``ops/spmv_gathered.py``: S1 is kernel B12, S2 and S3 are B11
(``ops/permute.py``) and the tile kernel is B13 (``csrc/spmv_gathered.cu``).
Original notes follow; the costs quoted are the TPU's, not the card's.


The routed format's cost on tiles built from SHORT, SCATTERED rows is
dominated by three terms the tile's structure forces: the window-span
select tree (W up to 64), pass-1 conflict layers (l1 up to 5, each
re-paying part of the tree at large W), and boundary layers (lmax up to
32 at ~13 ns each).  This module removes ALL three for that class — the
TPU answer to the reference's out-of-order row scheduler + HI crossbar on
its worst-case scattered inputs (base_functions.cpp:356-436,
spmv-helper.cpp:429-515):

1.  nnz are packed in ROW-MAJOR order into (8,128) tiles, each row
    wholly inside one tile (rows longer than ROW_CAP stay routed), each
    tile's rows inside ONE 1024-row y window, slot (0,0) reserved zero.
2.  ``x[col]`` values are delivered to their slots by a 3-stage Benes
    GATHER over panels of up to K = nwinp output tiles:
      - S1: within-x-window 2-level gather with routed-style conflict
        layers (duplicate sources — popular x entries — share a sub
        field, so only DISTINCT elements colliding on a (color-row,
        source-lane) cell need extra layers; > S1_CAP ranks spill);
      - transpose; S2: within-window Clos permute over GROUPED windows
        (1024/K color-rows per window — the fixed 1024-window cost of
        the naive scheme is gone); transpose;
      - S3: within-output-window Clos permute to final slot order.
    Edge colors come from the Konig/Euler coloring (plan/permute.py);
    per-(panel, x-window) fan-out is capped at FANOUT_CAP by cutting
    panels early (variable panel width), and hub overflow spills.
    S2/S3 cells without edges are filled BIJECTIVELY from unused
    sources, so every stage row is a true permutation — no dummy-edge
    regularization needed.
3.  The kernel per tile: products = vals * xg (slot-aligned, no x
    residency), one flat prefix, then run sums leave as the DIFFERENCE
    of two within-window Clos permutes of the prefix: route1 brings each
    row's end, route2 the slot before its start, to the row's y cell;
    empty cells get the same source from both routes (exact zero); the
    permutation-counting imbalance (-total) lands in the reserved trash
    cell (0,0), masked in-kernel.  ONE y read-modify-write per tile; no
    boundary layers at all.

Tile routing rides ONE i32 word: two 13-bit Clos routes
(subA 3 | laneB 7 | subC 3) at bits 0-12 and 13-25.  S1's word carries
lane|rank at the slot (bits 0-8) and up to 4 per-layer 3-bit sub fields
at the (color-row, source-lane) cell (bits 16-27).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hispmv_tpu_torch.plan.permute import (
    WindowStage,
    color_permutation,
    pack_window_stage,
)
from hispmv_tpu_torch.profiles import V5E, DeviceProfile

WINDOW = 1024
TILE = 1024
ROW_CAP = 512  # rows longer than this stay in the routed classes
S1_CAP = 4  # S1 conflict layers (4 x 3-bit sub fields in the word)
FANOUT_CAP = 1016  # per-(panel, x-window) edge cap (slack under 1024)



def _distinct_rank_local(group: np.ndarray, val: np.ndarray) -> np.ndarray:
    """Rank of each (group, val) pair among its group's DISTINCT vals
    (duplicate pairs share a rank) — plan/routed.py::_distinct_rank
    without the native dependency (panel-sized inputs)."""
    key = group.astype(np.int64) * 8 + val
    o = np.argsort(key, kind="stable")
    k_s = key[o]
    new_s = np.ones(len(o), bool)
    new_s[1:] = k_s[1:] != k_s[:-1]
    g_s = group[o]
    gnew = np.ones(len(o), bool)
    gnew[1:] = g_s[1:] != g_s[:-1]
    idx = np.cumsum(new_s) - 1
    first = np.zeros(len(o), np.int64)
    np.maximum.accumulate(np.where(gnew, idx, 0), out=first)
    rank = np.empty(len(o), np.int64)
    rank[o] = idx - first
    return rank


def _color_regularized(sw: np.ndarray, dw: np.ndarray, K: int) -> np.ndarray:
    """1024-color the REAL edges of an irregular bipartite multigraph by
    padding it to 1024-regular with dummy edges first (the Euler-split
    coloring is only exact on regular graphs — every walk is then a
    closed circuit and each split halves every vertex's degree exactly;
    on irregular graphs stuck walks compound a per-vertex imbalance and
    the 'coloring' collides).  Virtual dst windows absorb the dummy
    edges; only the real edges' colors are returned."""
    nreal = len(sw)
    src_def = np.maximum(TILE - np.bincount(sw, minlength=K), 0)
    dst_def = np.maximum(TILE - np.bincount(dw, minlength=K), 0)
    need = int(src_def.sum())
    # extend with virtual dst windows until both sides balance
    extra = need - int(dst_def.sum())
    assert extra % TILE == 0
    nvirt = extra // TILE
    dst_def = np.concatenate([dst_def, np.full(nvirt, TILE, np.int64)])
    sw_d = np.repeat(np.arange(K), src_def)
    dw_d = np.repeat(np.arange(len(dst_def)), dst_def)
    colors = color_permutation(
        np.concatenate([sw, sw_d]), np.concatenate([dw, dw_d])
    )
    return colors[:nreal].astype(np.int64)


def _bijective_fill(dst: np.ndarray, used_src: np.ndarray) -> None:
    """Fill dst rows' unassigned cells (-1) with each row's unused source
    positions, in order (dst [W, 1024] int64, used_src [W, 1024] bool).
    Counts match per row by construction."""
    dt, dp = np.nonzero(dst < 0)
    ft, fp = np.nonzero(~used_src)
    dst[dt, dp] = fp


@dataclasses.dataclass
class GatheredPlan:
    """Row-major tiles + the 3-stage x gather that feeds them."""

    shape: tuple  # (R, C) this plan's rows/cols live in
    num_tiles: int
    num_windows: int  # x windows K (pow-2 padded, == routed nwinp)
    num_ytiles: int
    panel_tiles: tuple  # PW per panel (sum == num_tiles)
    vals: np.ndarray  # f32 [T, 8, 128] (slot (0,0) of each tile is 0)
    word: np.ndarray  # i32 [T, 8, 128]: route1 | route2<<13
    byt: np.ndarray  # i32 [T]: the single y tile per tile
    s1: np.ndarray  # i32 [P*K, 8, 128] 2-level gather words
    s2: np.ndarray  # i32 [P*K, 8, 128] Clos routes (grouped windows)
    s3: np.ndarray  # i32 [T, 8, 128] Clos routes (output windows)

    @property
    def num_panels(self) -> int:
        return len(self.panel_tiles)

    @property
    def stream_bytes(self) -> int:
        return (
            self.vals.nbytes + self.word.nbytes
            + self.s1.nbytes + self.s2.nbytes + self.s3.nbytes
        )


def gathered_cost_ns(num_tiles: int, num_windows: int = 0,
                     num_panels: int = 0,
                     profile: DeviceProfile = V5E) -> float:
    """Modeled device cost of executing a gathered plan under
    ``profile``: a fixed cost for the chain's launches, one per tile (the
    tile kernel) and one per gather-stage window (2*P*K + T)."""
    if num_tiles == 0:
        return 0.0
    if not num_panels:
        num_panels = 1
    nwin_stages = 2 * num_panels * max(num_windows, 1) + num_tiles
    return profile.gath_launch_ns + num_tiles * profile.gath_tile_ns \
        + nwin_stages * profile.gath_stage_ns


def build_gathered_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple,
    num_windows: int,
):
    """Build a GatheredPlan for (rows, cols, vals) within ``shape``.

    ``num_windows``: the executor's pow-2-padded x window count (must
    match the routed plan's nwinp so both read the same padded x).

    Returns ``(plan_or_None, spill_rows, spill_cols, spill_vals)`` —
    spilled entries are long rows, rows at y offset 0, fan-out overflow
    and S1-conflict overflow; the caller routes them elsewhere.
    """
    R, C = shape
    K = int(num_windows)
    n = len(rows)
    # K > WINDOW (matrices wider than 2^20 cols): the grouped-S2 stage
    # needs g = WINDOW // K >= 1 grouped color-rows per window; spill
    # everything back to the caller instead of building a degenerate plan
    if n == 0 or K < 1 or K > WINDOW:
        return None, rows, cols, vals

    rows = rows.astype(np.int64, copy=False)
    cols = cols.astype(np.int64, copy=False)
    vals = vals.astype(np.float32, copy=False)

    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]

    # ---- spill: long rows + rows at y offset 0 -------------------------
    ur, rstart = np.unique(rows, return_index=True)
    rlen = np.diff(np.concatenate([rstart, [n]]))
    bad = (rlen > ROW_CAP) | ((ur % WINDOW) == 0)
    if bad.any():
        sp = np.repeat(bad, rlen)
        srows, scols, svals = rows[sp], cols[sp], vals[sp]
        rows, cols, vals = rows[~sp], cols[~sp], vals[~sp]
        n = len(rows)
        if n == 0:
            return None, srows, scols, svals
        ur, rstart = np.unique(rows, return_index=True)
        rlen = np.diff(np.concatenate([rstart, [n]]))
    else:
        srows = np.zeros(0, np.int64)
        scols = np.zeros(0, np.int64)
        svals = np.zeros(0, np.float32)

    # ---- tile packing: row-aligned, y-window-aligned, slot 0 reserved --
    ybt_of_row = (ur // WINDOW).astype(np.int64)
    nrows_u = len(ur)
    tile_id = np.empty(nrows_u, np.int64)
    row_off = np.empty(nrows_u, np.int64)
    t = -1
    used = TILE
    cur_y = -1
    for i in range(nrows_u):
        ln = int(rlen[i])
        y = int(ybt_of_row[i])
        if y != cur_y or used + ln > TILE:
            t += 1
            used = 1  # slot (0,0) reserved zero
            cur_y = y
        tile_id[i] = t
        row_off[i] = used
        used += ln
    T = t + 1
    N = T * TILE

    slot = (
        np.repeat(tile_id * TILE + row_off, rlen)
        + (np.arange(n) - np.repeat(rstart, rlen))
    )
    g_vals = np.zeros(N, np.float32)
    g_vals[slot] = vals
    src = np.full(N, -1, np.int64)  # -1: dummy slot (no edge)
    src[slot] = cols

    # ---- dual within-tile output permutes ------------------------------
    ends = slot[np.cumsum(rlen) - 1]
    e_tile = ends // TILE
    e_pos = ends % TILE
    start1_pos = row_off - 1
    ypos = (ur % WINDOW).astype(np.int64)  # != 0 by the spill rule

    is_end = np.zeros(N, bool)
    is_end[ends] = True
    lastend = np.zeros(T, np.int64)
    np.maximum.at(lastend, e_tile, e_pos)

    perm1 = np.full((T, TILE), -1, np.int64)
    perm2 = np.full((T, TILE), -1, np.int64)
    perm1[tile_id, ypos] = e_pos
    perm2[tile_id, ypos] = start1_pos
    perm1[:, 0] = 0  # trash: pf[0] == 0
    perm2[:, 0] = lastend  # trash: -total, masked in the kernel
    # shared fill: k-th free source slot -> k-th empty cell, per tile;
    # identical sources in both routes make empty cells exactly zero
    free_src = ~is_end.reshape(T, TILE)
    free_src[:, 0] = False
    dt, dp = np.nonzero(perm1 < 0)
    ft, fp = np.nonzero(free_src)
    perm1[dt, dp] = fp
    perm2[dt, dp] = fp
    r1 = pack_window_stage(perm1).route.astype(np.int64).reshape(T, TILE)
    r2 = pack_window_stage(perm2).route.astype(np.int64).reshape(T, TILE)
    word = (r1 | (r2 << 13)).astype(np.int32).reshape(T, 8, 128)

    byt = np.zeros(T, np.int64)
    byt[tile_id] = ybt_of_row

    # ---- panel cuts: per-(panel, x-window) fan-out <= FANOUT_CAP -------
    # Overflow edges are NEUTRALIZED in place, never re-planned: the
    # slot keeps its position with val 0 (its product is 0, so the run's
    # prefix difference simply omits it) and the nnz spills to the
    # caller's residual.  The same applies to S1-conflict overflow.
    swin = src >> 10  # -1 slots -> negative, excluded below
    drop = np.zeros(N, bool)  # edges to neutralize
    panel_tiles = []
    cut = 0
    while cut < T:
        cnt = np.zeros(K, np.int64)
        pw = 0
        while cut + pw < T and pw < K:
            tw = swin[(cut + pw) * TILE:(cut + pw + 1) * TILE]
            tc = np.bincount(np.minimum(tw[tw >= 0], K - 1), minlength=K)
            if pw > 0 and (cnt + tc > FANOUT_CAP).any():
                break
            cnt += tc
            pw += 1
        pw = max(pw, 1)  # single over-cap tiles shed edges below
        lo, hi = cut * TILE, (cut + pw) * TILE
        pm = slice(lo, hi)
        sw_p = swin[pm]
        valid = sw_p >= 0
        # per window keep the first FANOUT_CAP edges (slot order)
        order_w = np.argsort(sw_p[valid], kind="stable")
        wsorted = sw_p[valid][order_w]
        within = np.arange(len(wsorted)) - np.searchsorted(
            wsorted, wsorted)
        over = within >= FANOUT_CAP
        if over.any():
            pos = np.nonzero(valid)[0][order_w[over]]
            drop[lo + pos] = True
        panel_tiles.append(pw)
        cut += pw
    P = len(panel_tiles)

    # ---- per-panel stage construction ----------------------------------
    g = WINDOW // K
    s1_word = np.zeros((P * K, WINDOW), np.uint32)
    s2_src = np.full((P * K, WINDOW), -1, np.int64)
    s2_used = np.zeros((P * K, WINDOW), bool)
    s3_src = np.full((T, WINDOW), -1, np.int64)
    s3_used = np.zeros((T, WINDOW), bool)
    off = 0
    for p, pw in enumerate(panel_tiles):
        lo = off * TILE
        hi = (off + pw) * TILE
        esel = np.nonzero((src[lo:hi] >= 0) & ~drop[lo:hi])[0]
        sw = swin[lo:hi][esel]
        dpos = esel
        dw = dpos // TILE  # 0..pw-1
        colors = _color_regularized(sw, dw, K)
        src_off = src[lo:hi][esel] % WINDOW
        src_lane = src_off % 128
        src_sub = src_off // 128
        crow = colors // 128
        cellk = (sw * 8 + crow) * 128 + src_lane
        rank = _distinct_rank_local(cellk, src_sub)
        over = rank >= S1_CAP
        if over.any():
            drop[lo + dpos[over]] = True
            keepm = ~over
        else:
            keepm = np.ones(len(esel), bool)
        w1 = s1_word[p * K:(p + 1) * K]
        w1[sw[keepm], colors[keepm]] |= (
            src_lane[keepm] | (rank[keepm] << 7)
        ).astype(np.uint32)
        for l in range(S1_CAP):
            ml = keepm & (rank == l)
            if ml.any():
                w1[sw[ml], crow[ml] * 128 + src_lane[ml]] |= (
                    src_sub[ml].astype(np.uint32) << np.uint32(16 + 3 * l)
                )
        # S2 (grouped): element of edge (c, sw) sits at grouped window
        # c//g, position (c%g)*K + sw; moves to (c%g)*K + dw
        w2 = colors[keepm] // g
        r2v = colors[keepm] % g
        s2b = s2_src[p * K:(p + 1) * K]
        s2u = s2_used[p * K:(p + 1) * K]
        s2b[w2, r2v * K + dw[keepm]] = r2v * K + sw[keepm]
        s2u[w2, r2v * K + sw[keepm]] = True
        # S3: output slot (dpos % TILE) of window dw reads color row c
        s3b = s3_src[off:off + pw]
        s3u = s3_used[off:off + pw]
        s3b[dw[keepm], dpos[keepm] % TILE] = colors[keepm]
        s3u[dw[keepm], colors[keepm]] = True
        off += pw

    if drop.any():
        # neutralize: zero the vals; spill the nnz to the caller
        dsel = drop[slot]
        srows = np.concatenate([srows, rows[dsel]])
        scols = np.concatenate([scols, cols[dsel]])
        svals = np.concatenate([svals, vals[dsel]])
        g_vals[slot[dsel]] = 0.0

    _bijective_fill(s2_src, s2_used)
    _bijective_fill(s3_src, s3_used)
    s1 = s1_word.view(np.int32).reshape(P * K, 8, 128)
    s2 = pack_window_stage(s2_src).route.reshape(P * K, 8, 128)
    s3 = pack_window_stage(s3_src).route.reshape(T, 8, 128)

    plan = GatheredPlan(
        shape=(R, C),
        num_tiles=T,
        num_windows=K,
        num_ytiles=max(-(-R // WINDOW), 1),
        panel_tiles=tuple(panel_tiles),
        vals=g_vals.reshape(T, 8, 128),
        word=word,
        byt=byt.astype(np.int32),
        s1=s1,
        s2=s2,
        s3=s3,
    )
    return plan, srows, scols, svals


# ---------------------------------------------------------------------------
# Golden executors (mirror the device dataflow)
# ---------------------------------------------------------------------------


def _s1_gather_numpy(word: np.ndarray, xw: np.ndarray) -> np.ndarray:
    """Golden S1: 2-level layered gather per window (word u32 [K, 1024],
    xw f32 [K, 1024])."""
    K = word.shape[0]
    out = np.empty_like(xw)
    for w in range(K):
        wd = word[w].astype(np.int64)
        win8 = xw[w].reshape(8, 128)
        cell = wd.reshape(8, 128)
        lane = (wd & 127).reshape(8, 128)
        rank = ((wd >> 7) & 3).reshape(8, 128)
        res = np.zeros((8, 128), np.float32)
        for l in range(S1_CAP):
            sub_at_cell = (cell >> (16 + 3 * l)) & 7
            # inner take uses the RAW cell plane: after the outer lane
            # gather, sub ends up consulted at (row, SOURCE lane) —
            # exactly the routed pass-1 composition
            gth = np.take_along_axis(
                np.take_along_axis(win8, sub_at_cell, axis=0),
                lane, axis=1,
            )
            res = np.where(rank == l, gth, res)
        out[w] = res.reshape(-1)
    return out


def _clos_apply(route: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Apply one 13-bit Clos route (subA|laneB<<3|subC<<10) to (8,128)."""
    lanes = np.arange(128)
    subA = route & 7
    laneB = (route >> 3) & 127
    subC = (route >> 10) & 7
    t1 = a[subA, lanes[None, :]]
    t2 = np.take_along_axis(t1, laneB, axis=1)
    return t2[subC, lanes[None, :]]


def gather_x_numpy(plan: GatheredPlan, x: np.ndarray) -> np.ndarray:
    """Apply the 3-stage gather: xg [T*1024] with xg[slot] ==
    x_padded[src[slot]] at every real slot."""
    from hispmv_tpu_torch.plan.permute import stage_matvec_numpy

    K = plan.num_windows
    need = K * WINDOW
    xp = np.zeros(need, np.float32)
    xp[: min(len(x), need)] = x[:need]
    out = np.empty(plan.num_tiles * TILE, np.float32)
    off = 0
    for p, pw in enumerate(plan.panel_tiles):
        w1 = plan.s1[p * K:(p + 1) * K].view(np.uint32).reshape(
            K, WINDOW)
        a = _s1_gather_numpy(w1, xp.reshape(K, WINDOW))
        # transpose (K, 1024) -> (1024, K) -> grouped (K, g*K=1024)
        at = a.reshape(K, WINDOW).T.reshape(K, WINDOW)
        s2 = WindowStage(K, plan.s2[p * K:(p + 1) * K])
        b = stage_matvec_numpy(s2, at)
        # ungroup + transpose back; keep the pw real output windows
        bt = b.reshape(WINDOW, K).T[:pw]
        s3 = WindowStage(pw, plan.s3[off:off + pw])
        c = stage_matvec_numpy(s3, np.ascontiguousarray(bt))
        out[off * TILE:(off + pw) * TILE] = c.reshape(-1)
        off += pw
    return out


def gathered_matvec_numpy(plan: GatheredPlan, x: np.ndarray) -> np.ndarray:
    """Golden full matvec of the gathered plan: returns y [R]."""
    R, C = plan.shape
    xg = gather_x_numpy(plan, np.asarray(x, np.float32))
    y = np.zeros(plan.num_ytiles * WINDOW, np.float64)
    for t in range(plan.num_tiles):
        vals = plan.vals[t].astype(np.float64)
        prod = vals * xg[t * TILE:(t + 1) * TILE].reshape(8, 128)
        pf = np.cumsum(prod.reshape(-1)).reshape(8, 128)
        word = plan.word[t].astype(np.int64)
        out = _clos_apply(word & 0x1FFF, pf) \
            - _clos_apply((word >> 13) & 0x1FFF, pf)
        out[0, 0] = 0.0  # trash cell
        b = int(plan.byt[t])
        y[b * WINDOW:(b + 1) * WINDOW] += out.reshape(-1)
    return y[:R]
