"""B9 and B10, the routed-stream SpMV against one vector and against B
vectors: packer, stream table, CUDA kernel wrappers and plain PyTorch
versions.

Port of ``hispmv_tpu/ops/spmv_routed.py`` (``chunk_for_stream``,
``_chunk_terms``, ``_segment_terms``, ``stream_array_names``,
``pack_stream``, ``_routed_kernel`` / ``spmv_routed_stream_pallas``,
``_routed_kernel_batched`` / ``spmv_routed_stream_batched_pallas``).  Both
kernels are in ``csrc/spmv_routed.cu``; they consume the packed arrays of
the TPU kernels, so both packages can be fed identical inputs.  B9 runs
every stream of a routed plan in one launch: :func:`routed_table` checks
the streams' arrays once and lays them out for the kernel, and
:func:`spmv_routed_streams` adds their product into one y.  B10 runs B9's
tile against B vectors given vector-minor, as xt [nwin*8, 128, B], and
adds into a vector-minor y [nyt*1024, B]: one CTA a tile for the whole
batch, one launch a stream, every stream into the same y.  It sums each
boundary layer's run of slots directly (:func:`decode_runs`) instead of
differencing a tile prefix.

Per (8,128) tile of 1024 slots, cell (s, j) being sublane s and lane j:

1. x gather.  L = slot[s,j] & 127, rank = (slot[s,j] >> 7) & 7; the
   slot's layer (rank, or 0 when the stream has one pass-1 layer) names a
   9-bit field read at cell (s, L): gsub >> 9l for l < 3, slot >> (10 +
   9(l-3)) for l = 3, 4.  sub = field & 7, vid = field >> 3, and
   xg = x2d[(base[t] + vid)*8 + sub, L] (0 when vid >= W or the layer is
   >= l1).
2. p = vals * xg; P = inclusive prefix over the tile's 1024 slots in flat
   order s*128 + j (the reserved lane-0 slots make P[0, 0] == 0): fp64 in
   B9, so that a small row's difference of two large prefixes keeps its
   digits (as B13's).
3. Per boundary layer k < lmax: raw (bl word, or the merged bm word when
   lmax == 1) gives end lane a and start lane b, the sub fields are read at
   the gathered lanes, and P[sub_a, a] - P[sub_b, b] is added into y tile
   byt[t, k] at (s, j).  Layers k >= lt[t] (the plan's ``RoutedStream.lt``)
   are padding that adds P[0, 0] - P[0, 0] = 0: B9 and B10 on the card
   skip them, B9's plain version runs every layer.

B10 adds the same differences as run sums: with ea = sub_a*128 + a and
eb = sub_b*128 + b, P[ea] - P[eb] is the sum of p over the flat slots
(eb, ea] (negated where ea < eb), taken in fp32 in slot order.

Left out of the port on purpose: the TPU's bf16x3 prefix split (the port's
prefix is a plain scan).  The pow-2 bucketing of W, lmax and the
segment grids is kept only behind ``pack_stream(bucket=True)``, so tests
can feed both packages identical arrays; the handle packs with
``bucket=False`` and one tile per chunk.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from hispmv_tpu_torch.ops import cuda_build
from hispmv_tpu_torch.ops.spmv_chunked import check_cuda_tensors
from hispmv_tpu_torch.plan.routed import (
    L1_CAP,
    L_CAP,
    TILE,
    W_CAP,
    RoutedStream,
)
from hispmv_tpu_torch.profiles import V5E
from hispmv_tpu_torch.utils.trace import tally, traced

LANES = 128
DEFAULT_TCHUNK = 16
PIECE = 32  # slots of a run that B10 sums before its add (csrc kPiece)


def _bucket(n: int) -> int:
    """Round up to a power of two."""
    b = 1
    while b < n:
        b *= 2
    return b


def chunk_for_stream(s: RoutedStream) -> int:
    """Tiles per chunk of the TPU kernel (the JAX package's sizing, kept so
    ``pack_stream`` gives identical arrays)."""
    if s.lmax <= 4:
        return 32
    if s.lmax <= 16:
        return DEFAULT_TCHUNK
    return 8


def _chunk_terms(nch: int, max_terms: int = 4, cap: int = 0) -> list:
    """Binary decomposition of a chunk count into descending powers of two,
    capped at ``max_terms`` (the remainder rounds UP to one final pow-2
    term); ``cap`` bounds any single term, and capped full terms repeat
    without counting against ``max_terms``."""
    terms = []
    rem = max(nch, 1)
    if cap:
        while rem > cap:
            terms.append(cap)
            rem -= cap
    nfull = len(terms)  # cap-sized terms don't count against max_terms
    while rem and len(terms) - nfull < max_terms - 1:
        k = 1 << (rem.bit_length() - 1)
        terms.append(k)
        rem -= k
    if rem:
        terms.append(_bucket(rem))
    return terms


def stream_array_names(lmax: int = 2) -> tuple:
    """Device-dict key names of one packed segment's data arrays, in
    ``pack_stream`` order (without base/byt).  lmax == 1 streams carry ONE
    merged boundary word ``bm`` (end_lane | start_lane<<7 | end_sub<<14 |
    start_sub<<17) instead of the bl/bs pair."""
    if lmax == 1:
        return ("vals", "slot", "gsub", "bm")
    return ("vals", "slot", "gsub", "bl", "bs")


def _segment_terms(nch: int, chunk_cost_ns: float, cap: int = 0) -> list:
    """The pow-2 segmentation of the JAX package (binary split or one
    rounded-up grid, whichever its TPU cost model, ``V5E``, finds
    cheaper)."""
    split = _chunk_terms(nch, cap=cap)
    single = [_bucket(max(nch, 1))]
    if cap and single[0] > cap:
        return split
    cost_split = V5E.launch_ns * len(split) \
        + chunk_cost_ns * (sum(split) - nch)
    cost_single = V5E.launch_ns + chunk_cost_ns * (single[0] - nch)
    return single if cost_single <= cost_split else split


def pack_stream(s: RoutedStream, tchunk: int = 0, bucket: bool = True):
    """Pad one compressed stream to whole chunks of ``tchunk`` tiles.

    Returns a list of ``(arrays, dims)`` segments: ``arrays`` is
    ``(vals, slot, gsub, bm, base, byt)`` when the padded layer count lp is
    1 and ``(vals, slot, gsub, bl, bs, base, byt)`` otherwise; ``dims`` is
    ``(nch, tchunk, W, l1, lp)``.  The 3-D arrays are ``[nch, tchunk*rows,
    128]`` (rows 8 for vals/slot/gsub/bm, ``ceil(lp/2)*8`` for bl,
    ``ceil(lp/4)*8`` for bs); base is ``[nch*tchunk]``, byt
    ``[nch*tchunk*lp]``.  With ``bucket=True`` W, lp and the segment grids
    are bucketed to powers of two exactly as the JAX package does (its
    arrays, without the ``lt`` table); ``bucket=False`` gives one segment
    at the stream's own W and lmax.  Padding tiles are all zero and add
    exact zeros into y tile 0."""
    tchunk = tchunk or chunk_for_stream(s)
    T = s.num_tiles
    nch = max(-(-T // tchunk), 1)
    W = s.wmax if not bucket else _bucket(s.wmax)
    l1 = min(s.l1, L1_CAP)
    lp = s.lmax if not bucket else _bucket(s.lmax)
    if bucket:
        # the JAX package's TPU layout, sized by its costs (V5E)
        chunk_cost = tchunk * (
            V5E.tile_base_ns + V5E.tile_w_ns * (W - 1)
            + V5E.tile_ov_ns * (l1 - 1) + V5E.tile_bnd_ns * lp
        )

        # the TPU keeps base/byt/lt in 1 MiB of scalar memory, padded per
        # row to 512 B: the largest pow-2 segment that fits
        def _smem_bytes(seg_chunks):
            t = seg_chunks * tchunk
            return sum(max(t * d * 4, 512) for d in (1, lp, 1))

        cap = 1
        while _smem_bytes(cap * 2) <= 600 * 1024:
            cap *= 2
        terms = _segment_terms(nch, chunk_cost, cap=cap)
    else:
        terms = [nch]
    nch = sum(terms)
    Tp = nch * tchunk
    npair = -(-lp // 2)
    nquad = -(-lp // 4)

    vals = np.zeros((Tp, 8, LANES), np.float32)
    vals[:T] = s.vals
    slot = np.zeros((Tp, 8, LANES), np.int32)
    slot[:T] = s.slot
    gsub = np.zeros((Tp, 8, LANES), np.int32)
    gsub[:T] = s.gsub
    base = np.zeros(Tp, np.int32)
    base[:T] = s.base
    byt = np.zeros((Tp, lp), np.int32)
    byt[:T, : s.byt.shape[1]] = s.byt

    if lp == 1:
        # merged single boundary word: a pack-time transformation of the
        # plan's bl/bs pair
        bm = np.zeros((Tp, 1, 8, LANES), np.int32)
        blv = s.bl[:, 0].view(np.uint32)
        bsv = s.bs[:, 0].view(np.uint32)
        bm[:T, 0] = (
            (blv & np.uint32(0x3FFF))
            | ((bsv & np.uint32(7)) << np.uint32(14))
            | (((bsv >> np.uint32(4)) & np.uint32(7)) << np.uint32(17))
        ).view(np.int32)
        bnd = [bm.reshape(nch, tchunk * 8, LANES)]
    else:
        bl = np.zeros((Tp, npair, 8, LANES), np.int32)
        bl[:T, : s.bl.shape[1]] = s.bl
        bs = np.zeros((Tp, nquad, 8, LANES), np.int32)
        bs[:T, : s.bs.shape[1]] = s.bs
        bnd = [
            bl.reshape(nch, tchunk * npair * 8, LANES),
            bs.reshape(nch, tchunk * nquad * 8, LANES),
        ]

    full = [
        vals.reshape(nch, tchunk * 8, LANES),
        slot.reshape(nch, tchunk * 8, LANES),
        gsub.reshape(nch, tchunk * 8, LANES),
        *bnd,
        base.reshape(nch, tchunk),
        byt.reshape(nch, tchunk * lp),
    ]
    segments = []
    off = 0
    for term in terms:
        seg = tuple(
            np.ascontiguousarray(a[off: off + term])
            if a.ndim == 3
            else np.ascontiguousarray(a[off: off + term]).reshape(-1)
            for a in full
        )
        segments.append((seg, (term, tchunk, W, l1, lp)))
        off += term
    return segments


def _unpack(packed, dims):
    """Split ``packed`` into (vals, slot, gsub, bl, bs, base, byt), with bl
    the merged bm word and bs None when lmax == 1."""
    lmax = dims[4]
    want = len(stream_array_names(lmax)) + 2
    if len(packed) != want:
        raise ValueError(f"spmv_routed: {len(packed)} arrays for lmax="
                         f"{lmax}, want {want} (see pack_stream)")
    if lmax == 1:
        vals, slot, gsub, bm, base, byt = packed
        return vals, slot, gsub, bm, None, base, byt
    return packed


def _check_packed(packed, dims):
    """Validate one packed segment against its dims."""
    nch, tchunk, W, l1, lmax = dims
    vals, slot, gsub, bl, bs, base, byt = _unpack(packed, dims)
    if not (1 <= W <= W_CAP and 1 <= l1 <= L1_CAP and 1 <= lmax <= L_CAP):
        raise ValueError(f"spmv_routed: dims W={W}, l1={l1}, lmax={lmax} "
                         f"outside the caps ({W_CAP}, {L1_CAP}, {L_CAP})")
    if vals.dtype != torch.float32:
        raise TypeError("spmv_routed: vals must be float32")
    words = [slot, gsub, bl, base, byt] + ([bs] if bs is not None else [])
    if any(a.dtype != torch.int32 for a in words):
        raise TypeError("spmv_routed: routing words must be int32")
    Tp = nch * tchunk
    npair = 1 if lmax == 1 else -(-lmax // 2)
    shapes = [(vals, (nch, tchunk * 8, LANES)),
              (slot, (nch, tchunk * 8, LANES)),
              (gsub, (nch, tchunk * 8, LANES)),
              (bl, (nch, tchunk * npair * 8, LANES)),
              (base, (Tp,)), (byt, (Tp * lmax,))]
    if bs is not None:
        shapes.append((bs, (nch, tchunk * (-(-lmax // 4)) * 8, LANES)))
    for a, shape in shapes:
        if tuple(a.shape) != shape:
            raise ValueError(f"spmv_routed: array of shape {tuple(a.shape)}"
                             f" where {shape} is needed for dims {dims}")


def check_stream_args(packed, dims, x, num_ytiles):
    """Validate one packed segment and the dtype of its x before any
    launch (each wrapper checks the shape of its own x)."""
    _check_packed(packed, dims)
    if x.dtype != torch.float32:
        raise TypeError("spmv_routed: vals and x must be float32")
    if num_ytiles < 1:
        raise ValueError("spmv_routed: num_ytiles must be >= 1")


MAX_STREAMS = 8  # streams a B9 launch takes (a routed plan has at most 6)
_TABLE_WORDS = 13  # per stream: 8 array addresses, W, l1, lmax, tiles, first


@dataclasses.dataclass
class RoutedTable:
    """The streams of one B9 launch, checked once (see :func:`routed_table`).
    ``streams``: ``(packed, dims, lt)`` each, ``lt`` i32 [Tp] or None (then
    every tile runs all lmax layers); ``words``: their int64 rows for the
    kernel (``csrc/spmv_routed.cu::hispmv_spmv_routed_streams``), on the
    host."""

    streams: list
    num_ytiles: int
    num_tiles: int
    device: torch.device
    words: torch.Tensor

    @property
    def lt_nbytes(self) -> int:
        return sum(int(lt.nbytes) for _, _, lt in self.streams
                   if lt is not None)


def routed_table(streams, num_ytiles) -> RoutedTable:
    """Check the streams of one B9 launch and lay them out end to end in its
    grid, the largest lmax first: the card starts CTAs in grid order, so
    the tiles with the longest layer loops start first and overlap the
    rest.  ``streams``: ``(packed, dims, lt)`` each, ``packed``/``dims`` as
    :func:`pack_stream` gives them, ``lt`` i32 [nch*tchunk] (the plan's
    live boundary layers a tile, 0 on padding tiles) or None.  Raises on a
    wrong dtype or shape, dims outside the caps, tensors on more than one
    device or not contiguous, and (on the card) a boundary array that is not
    16-byte aligned."""
    streams = sorted(streams, key=lambda e: -e[1][4])
    if not 1 <= len(streams) <= MAX_STREAMS:
        raise ValueError(f"spmv_routed: {len(streams)} streams, want 1 to "
                         f"{MAX_STREAMS}")
    if num_ytiles < 1:
        raise ValueError("spmv_routed: num_ytiles must be >= 1")
    device = streams[0][0][0].device
    rows, first = [], 0
    for packed, dims, lt in streams:
        _check_packed(packed, dims)
        nch, tchunk, W, l1, lmax = dims
        tiles = nch * tchunk
        if lt is not None and (lt.dtype != torch.int32
                               or tuple(lt.shape) != (tiles,)):
            raise ValueError(f"spmv_routed: lt must be int32 [{tiles}]")
        arrays = list(packed) + ([lt] if lt is not None else [])
        for t in arrays:
            if t.device != device:
                raise ValueError(f"spmv_routed: tensors on {t.device} and "
                                 f"{device}")
            if not t.is_contiguous():
                raise ValueError("spmv_routed: tensors must be contiguous")
        vals, slot, gsub, bl, bs, base, byt = _unpack(packed, dims)
        if device.type == "cuda" and any(
                t.data_ptr() % 16 for t in (bl, bs) if t is not None):
            raise ValueError("spmv_routed: bl and bs must be 16-byte aligned")
        ptrs = [t.data_ptr() if t is not None else 0
                for t in (vals, slot, gsub, bl, bs, base, byt, lt)]
        rows.append(ptrs + [W, l1, lmax, tiles, first])
        first += tiles
    words = torch.tensor(rows, dtype=torch.int64)
    return RoutedTable(streams, num_ytiles, first, device, words)


def segment_lts(s: RoutedStream, segments) -> list:
    """The lt array of each :func:`pack_stream` segment of stream ``s``: the
    plan's live boundary layers a tile, 0 on padding tiles (the JAX
    packer's ``lt`` table, split as the segments are)."""
    out, off = [], 0
    for _, (nch, tchunk, *_) in segments:
        lt = np.zeros(nch * tchunk, np.int32)
        part = s.lt[off: off + nch * tchunk]
        lt[: len(part)] = part
        out.append(lt)
        off += nch * tchunk
    return out


def _routed_plain(packed, dims, x3, num_ytiles, acc=torch.float64):
    """B9's arithmetic on a batch, the prefix form: ``x3`` f32 [B, x_rows,
    128] -> y f32 [B, num_ytiles*1024].  Gathers and advanced indexing for
    the x gather, ``cumsum`` over the 1024 flat slots of each tile in
    ``acc`` (float64 for B9; the tests also take it in float32, the JAX
    package's prefix), ``index_add_`` over ``byt`` in ``acc``, one rounding
    to f32 at the end."""
    nch, tchunk, W, l1, lmax = dims
    vals, slot, gsub, bl, bs, base, byt = _unpack(packed, dims)
    dev = x3.device
    B, x_rows = x3.shape[0], x3.shape[1]
    Tp = nch * tchunk
    vals = vals.reshape(Tp, 8, LANES)
    t_idx = torch.arange(Tp, device=dev).view(Tp, 1)
    s_idx = torch.arange(8, device=dev).view(1, 8, 1)
    j_idx = torch.arange(LANES, device=dev).view(1, 1, LANES)

    # 1. x gather
    xo = _gather_offsets(packed, dims, x_rows).reshape(Tp, 8, LANES)
    ok = xo >= 0
    xg = x3.reshape(B, -1)[:, xo.clamp_min(0)]
    xg = torch.where(ok, xg, torch.zeros((), device=dev))

    # 2. products and the flat inclusive prefix of each tile
    p = vals.to(acc) * xg.to(acc)
    pf = torch.cumsum(p.reshape(B, Tp, TILE), dim=2).reshape(B, Tp, 8, LANES)

    # 3. boundary layers into the y tiles
    y = torch.zeros((B, num_ytiles * TILE), dtype=acc, device=dev)
    byt = byt.reshape(Tp, lmax).long()
    for k in range(lmax):
        ea, eb = _run_ends(bl, bs, lmax, Tp, k)
        pflat = pf.reshape(B, Tp, TILE)
        diff = pflat[:, t_idx, ea] - pflat[:, t_idx, eb]
        ok = byt[:, k] < num_ytiles
        dest = (byt[:, k].view(Tp, 1, 1) * TILE + s_idx * LANES + j_idx)
        y.index_add_(1, dest[ok].reshape(-1), diff[:, ok].reshape(B, -1))
    return y.float()


def _gather_offsets(packed, dims, x_rows):
    """Where each slot gathers from: i64 [Tp*1024], row*128 + lane within
    one vector's x (x_rows rows of 128), or -1 where the slot gathers
    nothing (step 1 of the module docstring).  Every shift is masked, so
    torch's arithmetic ``>>`` on int32 reads the kernel's bits."""
    nch, tchunk, W, l1, lmax = dims
    vals, slot, gsub, bl, bs, base, byt = _unpack(packed, dims)
    Tp = nch * tchunk
    slot = slot.reshape(Tp, 8, LANES)
    gsub = gsub.reshape(Tp, 8, LANES)
    lane = (slot & 127).long()
    rank = (slot >> 7) & 7
    xo = torch.full((Tp, 8, LANES), -1, dtype=torch.long, device=slot.device)
    for layer in range(l1):
        word = gsub if layer < 3 else slot
        shift = 9 * layer if layer < 3 else 10 + 9 * (layer - 3)
        field = torch.gather((word >> shift) & 511, 2, lane)
        vid = (field >> 3).long()
        row = (base.long().view(Tp, 1, 1) + vid) * 8 + (field & 7).long()
        got = torch.where((vid < W) & (row < x_rows), row * LANES + lane, -1)
        xo = got if l1 == 1 else torch.where(rank == layer, got, xo)
    return xo.reshape(-1)


def _run_ends(bl, bs, lmax, Tp, k):
    """The prefix entries (ea, eb), i64 [Tp, 1024] flat slots sub*128 +
    lane, of every cell of boundary layer k: the layer adds P[ea] - P[eb]
    (step 3 of the module docstring)."""
    if lmax == 1:
        raw = bl.reshape(Tp, 8, LANES)
        q = ((raw >> 14) & 7) | (((raw >> 17) & 7) << 4)
    else:
        raw = bl.reshape(Tp, -(-lmax // 2), 8, LANES)[:, k // 2] \
            >> (14 * (k % 2))
        q = bs.reshape(Tp, -(-lmax // 4), 8, LANES)[:, k // 4] \
            >> (8 * (k % 4))
    a = (raw & 127).long()
    b = ((raw >> 7) & 127).long()
    ea = (torch.gather(q, 2, a) & 7).long() * LANES + a
    eb = ((torch.gather(q, 2, b) >> 4) & 7).long() * LANES + b
    return ea.reshape(Tp, TILE), eb.reshape(Tp, TILE)


def decode_runs(packed, dims, num_ytiles, lt=None, tiles=None):
    """B10's runs of one packed stream, as i64 tensors ``(tile, yrow,
    first, length)``: y row yrow = byt*1024 + cell gets the sum of the
    products of the tile's flat slots first .. first + |length| - 1,
    negated where length < 0.  A live layer k (k < lt[t], its y tile in
    [0, num_ytiles)) gives cell c the pair (ea, eb), +P[ea] - P[eb].  The
    layers of one y tile in a row are merged cell by cell: a pair that
    starts where the pending one ends (+P[a] - P[b] + P[b] - P[e]) or ends
    where it starts (+P[a] - P[b] + P[e] - P[a]) joins it, as the planner
    spells a run across two layers through a shared entry; any other pair
    sends the pending one out as it is.  A pair with equal ends is no
    run.  ``lt`` i32 [Tp] (None: every layer); ``tiles`` (start, stop)
    decodes a range of tiles only."""
    nch, tchunk, W, l1, lmax = dims
    vals, slot, gsub, bl, bs, base, byt = _unpack(packed, dims)
    Tp = nch * tchunk
    t0, t1 = tiles if tiles is not None else (0, Tp)
    n = t1 - t0
    npair = 1 if lmax == 1 else -(-lmax // 2)
    bl = bl.reshape(Tp, npair * TILE)[t0:t1]
    if bs is not None:
        bs = bs.reshape(Tp, -(-lmax // 4) * TILE)[t0:t1]
    byt = byt.reshape(Tp, lmax)[t0:t1].long()
    live_layers = (torch.full((n,), lmax, device=bl.device) if lt is None
                   else lt[t0:t1].long())
    dev = bl.device
    none = torch.full((n, TILE), -1, dtype=torch.long, device=dev)
    pa, pb, cur = none.clone(), none.clone(), torch.full(
        (n,), -1, dtype=torch.long, device=dev)
    out = []

    def flush(mask):  # send out the pending pairs of the masked cells
        t, c = (mask & (pa != pb)).nonzero(as_tuple=True)
        out.append((t, cur[t] * TILE + c, pa[t, c], pb[t, c]))
        pa[mask] = -1
        pb[mask] = -1

    for k in range(lmax):
        ea, eb = _run_ends(bl, bs, lmax, n, k)
        yt = byt[:, k]
        on = (k < live_layers) & (yt >= 0) & (yt < num_ytiles)
        new = on & (yt != cur)
        flush(new[:, None] & (pa >= 0))
        cur = torch.where(new, yt, cur)
        live = on[:, None] & (ea != eb)
        held = live & (pa >= 0)
        join_b = held & (pb == ea)  # +P[pa] - P[eb]
        join_a = held & ~join_b & (pa == eb)  # +P[ea] - P[pb]
        flush(held & ~join_b & ~join_a)
        pb = torch.where(join_b, eb, pb)
        pa = torch.where(join_a, ea, pa)
        fresh = live & ~join_b & ~join_a
        pa = torch.where(fresh, ea, pa)
        pb = torch.where(fresh, eb, pb)
        # a pair joined into equal ends adds nothing: drop it
        gone = (join_a | join_b) & (pa == pb)
        pa = torch.where(gone, -1, pa)
        pb = torch.where(gone, -1, pb)
    flush(pa >= 0)
    tile, yrow, a, b = (torch.cat(o) for o in zip(*out))
    lo = torch.minimum(a, b)
    return tile + t0, yrow, lo + 1, a - b


def stream_runs(packed, dims, num_ytiles, lt=None, tiles_a_pass=2048):
    """The number of runs B10 adds for one packed stream a call (see
    :func:`decode_runs`), decoded ``tiles_a_pass`` tiles at a time."""
    Tp = dims[0] * dims[1]
    return sum(int(decode_runs(packed, dims, num_ytiles, lt,
                               (t, min(t + tiles_a_pass, Tp)))[0].numel())
               for t in range(0, Tp, tiles_a_pass))


def spmv_routed_stream_plain(packed, dims, x2d, num_ytiles):
    """Plain PyTorch version of B9 on the same arrays (see
    :func:`_routed_plain`, fp64 prefix); returns y f32 [num_ytiles*8,
    128]."""
    y = _routed_plain(packed, dims, x2d[None], num_ytiles, torch.float64)
    return y.reshape(num_ytiles * 8, LANES)


def spmv_routed_stream_batched_plain(packed, dims, xt, y, lt=None):
    """Plain PyTorch version of B10: each run of :func:`decode_runs` summed
    as the kernel sums it (fp32 products of value and x, added in slot
    order a piece of at most ``PIECE`` slots at a time, slots of value 0
    and slots that gather nothing left out, negated where the run
    subtracts) and added into its row of ``y`` f32 [nyt*1024, B]
    (vector-minor) in place; returns y.  ``xt`` f32 [nwin*8, 128, B]."""
    nyt, B = y.shape[0] // TILE, xt.shape[2]
    dev = xt.device
    tile, yrow, first, length = decode_runs(packed, dims, nyt, lt)
    n = length.abs()
    # the runs' pieces, and the slots of each piece
    npieces = (n + PIECE - 1) // PIECE
    run = torch.repeat_interleave(torch.arange(n.numel(), device=dev),
                                  npieces)
    k = torch.arange(run.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(npieces, 0) - npieces, npieces)
    plen = torch.clamp(n[run] - k * PIECE, max=PIECE)
    piece = torch.repeat_interleave(torch.arange(run.numel(), device=dev),
                                    plen)
    j = torch.arange(piece.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(plen, 0) - plen, plen)
    flat = (tile[run] * TILE + first[run] + k * PIECE)[piece] + j
    xo = _gather_offsets(packed, dims, xt.shape[0])[flat]
    v = packed[0].reshape(-1)[flat]
    xv = xt.reshape(-1, B)[xo.clamp_min(0)]
    xv = torch.where(((xo >= 0) & (v != 0))[:, None], xv,
                     torch.zeros((), device=dev))
    prod = v[:, None] * xv
    sums = torch.zeros((run.numel(), B), dtype=torch.float32, device=dev)
    sums.index_add_(0, piece, prod)
    sums = torch.where((length[run] < 0)[:, None], -sums, sums)
    y.index_add_(0, yrow[run], sums)
    return y


def _check_x(name, x2d, device):
    if x2d.ndim != 2 or x2d.shape[1] != LANES:
        raise ValueError(f"{name}: x must be [n, {LANES}], got "
                         f"{tuple(x2d.shape)}")
    if x2d.dtype != torch.float32:
        raise TypeError(f"{name}: x must be float32")
    if x2d.device != device:
        raise ValueError(f"{name}: x on {x2d.device}, the streams on "
                         f"{device}")


def spmv_routed_streams_plain(table: RoutedTable, x2d, y=None):
    """Plain PyTorch version of B9 on a table: each stream's product (see
    :func:`_routed_plain`, every layer run) added into ``y`` f32
    [num_ytiles*8, 128] in place, or into zeros when ``y`` is None;
    returns it."""
    nyt = table.num_ytiles
    if y is None:
        y = torch.zeros((nyt * 8, LANES), dtype=torch.float32,
                        device=x2d.device)
    for packed, dims, _ in table.streams:
        y += _routed_plain(packed, dims, x2d[None], nyt,
                           torch.float64).reshape(-1, LANES)
    return y


@traced("kernel.B9")
def spmv_routed_streams(table: RoutedTable, x2d, y=None):
    """Run every stream of ``table`` (from :func:`routed_table`) against
    ``x2d`` f32 [nwin*8, 128] in one B9 launch, adding into ``y`` f32
    [num_ytiles*8, 128] in place (into zeros when ``y`` is None); returns
    y.  The streams' arrays were checked when the table was built: this
    checks x and y.  CPU tensors take the plain PyTorch version; CUDA
    tensors launch the CUDA kernel (csrc/spmv_routed.cu) or raise."""
    _check_x("spmv_routed", x2d, table.device)
    shape = (table.num_ytiles * 8, LANES)
    if y is not None and (tuple(y.shape) != shape or y.dtype != torch.float32
                          or y.device != table.device
                          or not y.is_contiguous()):
        raise ValueError(f"spmv_routed: y must be a contiguous float32 "
                         f"{list(shape)} on {table.device}")
    if x2d.device.type == "cpu":
        return spmv_routed_streams_plain(table, x2d, y)
    check_cuda_tensors("spmv_routed", x2d)
    lib = cuda_build.get_lib()
    if y is None:
        y = torch.zeros(shape, dtype=torch.float32, device=x2d.device)
    with torch.cuda.device(x2d.device):
        rc = lib.hispmv_spmv_routed_streams(
            table.words.data_ptr(), len(table.streams), x2d.data_ptr(),
            x2d.shape[0], y.data_ptr(), table.num_ytiles,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(rc, "spmv_routed")
    spmv_routed_streams.launches += 1
    return y


spmv_routed_streams.launches = 0  # B9 launches, for the smoke run's check


def spmv_routed_stream(packed, dims, x2d, num_ytiles):
    """Run one packed routed-stream segment; returns y f32 [num_ytiles*8,
    128].  ``packed``/``dims`` come from :func:`pack_stream`, ``x2d`` is
    f32 [nwin*8, 128].  B9 on a one-entry table, every layer run (counted
    in ``spmv_routed_streams.launches``).  CPU tensors take the plain
    PyTorch version; CUDA tensors launch the CUDA kernel
    (csrc/spmv_routed.cu) or raise."""
    check_stream_args(packed, dims, x2d, num_ytiles)
    _check_x("spmv_routed", x2d, x2d.device)
    if x2d.device.type == "cpu":
        return spmv_routed_stream_plain(packed, dims, x2d, num_ytiles)
    check_cuda_tensors("spmv_routed", x2d, *packed)
    return spmv_routed_streams(
        routed_table([(packed, dims, None)], num_ytiles), x2d)


@traced("kernel.B10")
def spmv_routed_stream_batched(packed, dims, xt, y, lt, runs, counted=None):
    """Run one packed routed-stream segment against the B vectors of ``xt``
    f32 [nwin*8, 128, B] (vector-minor: xt[r, L, b] is vector b's x row r,
    lane L), adding into ``y`` f32 [nyt*1024, B] (vector-minor: y[r, b] is
    row r of vector b's product) in place; returns y.  One launch covers
    the whole batch: one CTA a tile, or a tile and a slice of the batch
    where the stream's tiles alone would leave SMs idle.  ``lt`` i32 [Tp]
    (the plan's live layers a tile; None: every layer) and ``runs`` (the
    stream's run count, :func:`stream_runs`) come from the pack; ``runs``
    is added to ``.runs`` beside ``.launches`` on the card, and to the
    program's tracer (``kernel.B10.runs``).  ``counted``: None, or an
    int64 [1] tensor on the device to which the launch adds the runs it
    decoded itself (the check of the kernel's decode against ``runs``).
    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    CUDA kernel (csrc/spmv_routed.cu) or raise."""
    check_stream_args(packed, dims, xt, 1)
    if (xt.ndim != 3 or xt.shape[1] != LANES or xt.shape[0] % 8
            or xt.shape[2] < 1):
        raise ValueError(f"spmv_routed_batched: x must be [nwin*8, {LANES}, "
                         f"B], got {tuple(xt.shape)}")
    B = xt.shape[2]
    if (y.ndim != 2 or y.shape[1] != B or y.shape[0] % TILE
            or y.shape[0] == 0 or y.dtype != torch.float32
            or y.device != xt.device or not y.is_contiguous()):
        raise ValueError(f"spmv_routed_batched: y must be a contiguous "
                         f"float32 [nyt*{TILE}, {B}] on {xt.device}, got "
                         f"{y.dtype} {tuple(y.shape)} on {y.device}")
    nch, tchunk, W, l1, lmax = dims
    if lt is not None and (lt.dtype != torch.int32
                           or tuple(lt.shape) != (nch * tchunk,)):
        raise ValueError(f"spmv_routed_batched: lt must be int32 "
                         f"[{nch * tchunk}]")
    if counted is not None and (counted.dtype != torch.int64
                                or counted.numel() != 1
                                or counted.device != xt.device):
        raise ValueError(f"spmv_routed_batched: counted must be one int64 "
                         f"on {xt.device}")
    nyt = y.shape[0] // TILE
    if xt.device.type == "cpu":
        if counted is not None:
            counted += stream_runs(packed, dims, nyt, lt)
        tally("kernel.B10.runs", runs)
        return spmv_routed_stream_batched_plain(packed, dims, xt, y, lt)
    vals, slot, gsub, bl, bs, base, byt = _unpack(packed, dims)
    check_cuda_tensors("spmv_routed_batched", xt, y, *packed,
                       *(() if lt is None else (lt,)),
                       *(() if counted is None else (counted,)))
    if any(t.data_ptr() % 16 for t in (bl, bs) if t is not None):
        raise ValueError("spmv_routed_batched: bl and bs must be 16-byte "
                         "aligned")
    lib = cuda_build.get_lib()
    with torch.cuda.device(xt.device):
        rc = lib.hispmv_spmv_routed_batched(
            vals.data_ptr(), slot.data_ptr(), gsub.data_ptr(),
            bl.data_ptr(), 0 if bs is None else bs.data_ptr(),
            base.data_ptr(), byt.data_ptr(),
            0 if lt is None else lt.data_ptr(), xt.data_ptr(), xt.shape[0],
            B, y.data_ptr(), nyt, nch * tchunk, W, l1, lmax,
            0 if counted is None else counted.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(rc, "spmv_routed_batched")
    spmv_routed_stream_batched.launches += 1
    spmv_routed_stream_batched.runs += runs
    tally("kernel.B10.runs", runs)
    return y


spmv_routed_stream_batched.launches = 0  # kernel launches, for the smoke run
spmv_routed_stream_batched.runs = 0  # the pack's runs of those launches


def routed_batched_shape(B, num_tiles, xt, y):
    """(vectors a lane, lanes a run piece, slices of the batch, vectors a
    slice) of B10's launch for a batch of ``B`` on a stream of
    ``num_tiles`` tiles, on these ``xt`` and ``y`` (their alignment picks
    the vector width) and their device (its SMs pick the slices).  Needs
    the built library."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(xt.device):
        rc = cuda_build.get_lib().hispmv_spmv_routed_batched_shape(
            B, num_tiles, xt.data_ptr(), y.data_ptr(),
            ctypes.addressof(out))
    cuda_build.check(rc, "spmv_routed_batched_shape")
    return tuple(out)
