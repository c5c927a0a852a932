"""Fast arbitrary-permutation plans: 3 within-window stages + 2 transposes.

Carried over unchanged from ``hispmv_tpu/plan/permute.py`` (numpy and the
standard library only), so that both packages build identical plans.  The
colouring runs in the port's own native library (``hispmv_tpu_torch/
native``), which raises when it cannot be built; ``_color_py`` stays beside
it as its plain version and walks the edges in the same order, so the two
give the same colours.  The stage kernel is B11 (``ops/permute.py``,
``csrc/permute.cu``).  Original notes follow; the speeds quoted are the TPU's.

TPUs have no fast element gather (measured 0.10-0.14 Gelem/s via XLA
gather), but they DO have two fast primitives:

- within-(8,128)-tile two-level gathers (sublane take_along_axis composed
  with lane take_along_axis) — the machinery the routed-stream kernel uses
  for pass 1 (ops/spmv_routed.py), ~4 ns per (8,128) tile per layer;
- XLA 2-D transposes, which run near memory speed.

Any permutation of ``N = W * 1024`` elements (``W <= 1024``) decomposes
into three stages that each permute WITHIN a 1024-element window, with a
transpose between stages (the classic Benes/Hall routing argument):

    y = S3( T( S2( T( S1(x) ) ) ) )

where S1 permutes within the W source windows, S2 within the 1024 rows of
the transposed (1024, W) view, and S3 within the W destination windows.
Stage construction needs a proper 1024-edge-coloring of the W-vertex
bipartite multigraph {src_window -> dst_window}; a coloring always exists
(Konig) and is computed by recursive Euler splitting (d = 1024 = 2^10
levels), in native C++ for large N (hispmv_native.euler_color) with a
pure-Python fallback.

A within-window permutation is itself Clos-decomposed into EXACTLY three
gathers (sublane, lane, sublane): an 8-color edge coloring of the
src-lane/dst-lane bipartite multigraph (8-regular, so colorable by
Konig) assigns each element its intermediate sublane.  One i32 route
word per element carries all three index fields.

This is the plan-time answer to the reference's hardware shuffle networks
(base_functions.cpp:417-436 SSW): data movement is resolved into static
routing tables once, then executed at vector rate.  It is what makes
rank-space (degree-sorted) SpMV execution affordable: x is permuted into
rank space and y back out of it in ~0.1 ns/element instead of ~7-16.
"""

from __future__ import annotations

import dataclasses
import numpy as np

from hispmv_tpu_torch.profiles import V5E, DeviceProfile

WINDOW = 1024


# ---------------------------------------------------------------------------
# Bipartite 1024-regular multigraph edge coloring (recursive Euler split)
# ---------------------------------------------------------------------------


def _euler_split_py(sw: np.ndarray, dw: np.ndarray) -> np.ndarray:
    """Split a d-regular (d even) bipartite multigraph into two halves of
    degree d/2 by walking Eulerian circuits with alternating assignment.
    Returns side 0/1 per edge."""
    n = len(sw)
    side = np.zeros(n, np.int8)
    used = np.zeros(n, bool)

    l_order = np.argsort(sw, kind="stable")
    r_order = np.argsort(dw, kind="stable")
    nl = int(sw.max()) + 1 if n else 0
    nr = int(dw.max()) + 1 if n else 0
    l_start = np.searchsorted(sw[l_order], np.arange(nl + 1))
    r_start = np.searchsorted(dw[r_order], np.arange(nr + 1))
    l_cur = l_start[:-1].copy()
    r_cur = r_start[:-1].copy()

    def next_left(v):
        c = l_cur[v]
        end = l_start[v + 1]
        while c < end and used[l_order[c]]:
            c += 1
        l_cur[v] = c
        return l_order[c] if c < end else -1

    def next_right(v):
        c = r_cur[v]
        end = r_start[v + 1]
        while c < end and used[r_order[c]]:
            c += 1
        r_cur[v] = c
        return r_order[c] if c < end else -1

    for seed in range(n):
        if used[seed]:
            continue
        e = seed
        s = 0
        while e >= 0:
            used[e] = True
            side[e] = s
            if s == 0:  # traversed L->R: continue from the right vertex
                e = next_right(dw[e])
            else:  # traversed R->L: continue from the left vertex
                e = next_left(sw[e])
            s ^= 1
    return side


def _color_py(sw: np.ndarray, dw: np.ndarray, d: int) -> np.ndarray:
    """Recursive Euler-split coloring: d colors (d a power of two) such
    that edges sharing a left or right vertex get distinct colors."""
    n = len(sw)
    colors = np.zeros(n, np.int32)
    if d == 1 or n == 0:
        return colors
    side = _euler_split_py(sw, dw)
    for s, base in ((side == 0, 0), (side == 1, d // 2)):
        idx = np.nonzero(s)[0]
        colors[idx] = base + _color_py(sw[idx], dw[idx], d // 2)
    return colors


def color_permutation(
    sw: np.ndarray, dw: np.ndarray, d: int = WINDOW
) -> np.ndarray:
    """Edge-color a d-regular bipartite multigraph (d a power of two):
    edges sharing a left or right vertex get distinct colors.  Used at
    d=WINDOW for the window-level stage decomposition and at d=8 for the
    within-window sublane routing.  Runs the native C++ pass
    (``_color_py`` is its plain version: the same walk, O(N) but slow at
    millions of elements)."""
    from hispmv_tpu_torch import native

    return native.euler_color(sw, dw, d)


# ---------------------------------------------------------------------------
# Within-window gather-route packing (shared by all three stages)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WindowStage:
    """One within-window permutation stage, packed for the Pallas kernel.

    A within-(8,128) permutation is itself Clos-decomposed into exactly
    three gathers — sublane, then lane, then sublane (the 8-color edge
    coloring of the src-lane/dst-lane bipartite multigraph picks each
    element's intermediate sublane).  All three index fields ride one i32:

        a[r, j]  = in[subA(r, j), j]        bits 0-2
        b[r, dj] = a[r, laneB(r, dj)]       bits 3-9
        out[s,j] = b[subC(s, j), j]         bits 10-12
    """

    num_windows: int
    route: np.ndarray  # i32 [W, 8, 128]: subA | laneB<<3 | subC<<10

    @property
    def stream_bytes(self) -> int:
        return self.route.nbytes


def pack_window_stage(src: np.ndarray) -> WindowStage:
    """Pack within-window source indices ``src`` [W, 1024] (each row a
    permutation of 0..1023) into the 3-gather Clos routing."""
    W = src.shape[0]
    src = src.astype(np.int64)
    dpos = np.broadcast_to(
        np.arange(WINDOW, dtype=np.int64)[None, :], src.shape
    )
    w_of = np.broadcast_to(np.arange(W, dtype=np.int64)[:, None], src.shape)
    w = w_of.ravel()
    sj, ss = (src % 128).ravel(), (src // 128).ravel()
    dj, ds = (dpos % 128).ravel(), (dpos // 128).ravel()
    # 8-regular bipartite multigraph: left = (window, src lane), right =
    # (window, dst lane); the 8-coloring is each element's intermediate
    # sublane r (distinct per src lane and per dst lane by Konig)
    r = color_permutation(w * 128 + sj, w * 128 + dj, d=8).astype(np.int64)
    subA = np.zeros((W, 8, 128), np.int64)
    subA[w, r, sj] = ss
    laneB = np.zeros((W, 8, 128), np.int64)
    laneB[w, r, dj] = sj
    subC = np.zeros((W, 8, 128), np.int64)
    subC[w, ds, dj] = r
    route = (subA | (laneB << 3) | (subC << 10)).astype(np.int32)
    return WindowStage(num_windows=W, route=route)


def stage_matvec_numpy(stage: WindowStage, a: np.ndarray) -> np.ndarray:
    """Golden executor: apply one stage to ``a`` [W, 1024] (any dtype)."""
    W = stage.num_windows
    out = np.zeros_like(a)
    route = stage.route.astype(np.int64)
    lanes = np.arange(128)
    for w in range(W):
        win8 = a[w].reshape(8, 128)
        subA = route[w] & 7
        laneB = (route[w] >> 3) & 127
        subC = (route[w] >> 10) & 7
        t1 = win8[subA, lanes[None, :]]
        t2 = np.take_along_axis(t1, laneB, axis=1)
        t3 = t2[subC, lanes[None, :]]
        out[w] = t3.reshape(-1)
    return out


# ---------------------------------------------------------------------------
# Full permutation plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PermutePlan:
    """``y[i] = x[perm[i]]`` for ``i < n`` via S1 -> T -> S2 -> T -> S3.

    S2 always operates on the (1024, 1024)-padded transposed view; its
    window count is fixed at 1024 regardless of W (wasteful for small N —
    the planner is only worth using when N is large; see
    ``estimate_permute_cost_ns``)."""

    n: int  # logical length
    num_windows: int  # W = ceil(n / 1024), <= 1024
    s1: WindowStage  # W windows
    s2: WindowStage  # 1024 windows (transposed view, cols padded to 1024)
    s3: WindowStage  # W windows

    @property
    def stream_bytes(self) -> int:
        return (
            self.s1.stream_bytes + self.s2.stream_bytes
            + self.s3.stream_bytes
        )


def build_permute_plan(perm: np.ndarray) -> PermutePlan:
    """Build the 3-stage plan for ``y = x[perm]`` (perm a permutation of
    ``len(perm)`` <= 1024*1024 elements)."""
    n = len(perm)
    W = max(-(-n // WINDOW), 1)
    if W > WINDOW:
        raise ValueError(
            f"permutation of {n} elements exceeds the single-panel limit "
            f"({WINDOW * WINDOW}); split into panels"
        )
    Np = W * WINDOW
    full = np.concatenate(
        [np.asarray(perm, np.int64), np.arange(n, Np, dtype=np.int64)]
    )
    d_idx = np.arange(Np, dtype=np.int64)
    sw = full // WINDOW
    dw = d_idx // WINDOW
    colors = color_permutation(sw, dw).astype(np.int64)

    s1src = np.zeros((W, WINDOW), np.int64)
    s1src[sw, colors] = full % WINDOW
    # transposed view: row = color, col = window (cols >= W are identity)
    s2src = np.broadcast_to(
        np.arange(WINDOW, dtype=np.int64)[None, :], (WINDOW, WINDOW)
    ).copy()
    s2src[colors, dw] = sw
    s3src = np.zeros((W, WINDOW), np.int64)
    s3src[dw, d_idx % WINDOW] = colors

    return PermutePlan(
        n=n,
        num_windows=W,
        s1=pack_window_stage(s1src),
        s2=pack_window_stage(s2src),
        s3=pack_window_stage(s3src),
    )


def permute_numpy(plan: PermutePlan, x: np.ndarray) -> np.ndarray:
    """Golden executor for the full plan (mirrors the device dataflow)."""
    W = plan.num_windows
    xp = np.zeros(W * WINDOW, x.dtype)
    xp[: plan.n] = x[: plan.n]
    a = stage_matvec_numpy(plan.s1, xp.reshape(W, WINDOW))
    at = np.zeros((WINDOW, WINDOW), x.dtype)
    at[:, :W] = a.T
    b = stage_matvec_numpy(plan.s2, at)
    bt = b.T[:W]
    y = stage_matvec_numpy(plan.s3, np.ascontiguousarray(bt))
    return y.reshape(-1)[: plan.n]


PANEL = WINDOW * WINDOW  # single-plan element limit (1 Mi)


def degree_rank_perms(deg: np.ndarray):
    """Degree-descending stable ranks, computed within PANEL-sized panels
    (the permutation plans are panel-local, so axes longer than 1 Mi are
    ranked per panel — concentration within a 1 Mi neighborhood is nearly
    as good as global for the routed planner).

    Returns ``(rank, perms)``: ``rank[i]`` = rank-space position of
    original index i (``panel(rank[i]) == panel(i)``), and ``perms`` the
    per-panel local permutations with ``ranked[p*PANEL + k] =
    orig[p*PANEL + perms[p][k]]``."""
    n = len(deg)
    rank = np.empty(n, np.int64)
    perms = []
    for base in range(0, max(n, 1), PANEL):
        end = min(base + PANEL, n)
        local = np.argsort(-deg[base:end], kind="stable")
        perms.append(local)
        rank[base + local] = base + np.arange(end - base)
    return rank, perms


def build_panel_permute_plans(perms) -> list:
    """One PermutePlan per panel-local permutation."""
    return [build_permute_plan(p) for p in perms]


def panel_permute_numpy(plans: list, x: np.ndarray) -> np.ndarray:
    """Golden: apply per-panel plans to consecutive PANEL slices of x."""
    out = np.empty_like(x)
    base = 0
    for plan in plans:
        out[base : base + plan.n] = permute_numpy(
            plan, x[base : base + plan.n]
        )
        base += plan.n
    assert base == len(x)
    return out


def estimate_permute_cost_ns(n: int, profile: DeviceProfile = V5E) -> float:
    """Rough device cost of applying a permutation of n elements under
    ``profile`` (``tune/cost.py``; ``V5E`` by default): three stage
    kernels (S2 fixed at 1024 windows) + two transposes + a fixed cost."""
    W = max(-(-n // WINDOW), 1)
    t_stages = (2 * W + WINDOW) * profile.permute_window_ns
    t_transpose = 2 * (WINDOW * W * 4 / 1e6) * profile.transpose_ns_per_mb
    return t_stages + t_transpose + profile.permute_fixed_ns
