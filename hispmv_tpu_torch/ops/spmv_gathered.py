"""B12 and B13, the gathered executor of the routed format's side-plan
(``plan/gathered.py``): packer, the full x gather, CUDA kernel wrappers
and plain PyTorch versions.

Port of ``hispmv_tpu/ops/spmv_gathered.py`` (``pack_gathered``,
``_s1_kernel`` / ``s1_gather_pallas``, ``gathered_gather_apply``,
``_gathered_kernel`` / ``spmv_gathered_tiles_pallas``).  Both kernels are
in ``csrc/spmv_gathered.cu``; they consume the packed arrays of the TPU
kernels, so both packages can be fed identical inputs.

1. :func:`s1_gather` (B12): the within-x-window two-level layered gather
   (stage S1).  Window ``p*K + k`` of panel ``p`` reads x window ``k``.
2. S2 and S3 are B11 (``ops/permute.py``); :func:`gathered_gather_apply`
   strings S1 -> transpose -> S2 -> transpose -> S3 together, the
   transposes and the concatenation of each panel's real windows in plain
   torch, as the JAX package leaves them to XLA.
3. :func:`spmv_gathered_tiles` (B13): per tile, products ``vals * xg``,
   the inclusive prefix over the tile's 1024 slots in fp64 (an fp32
   prefix cancels short rows' sums away), run sums as the difference of
   two Clos routes of the prefix rounded to fp32, trash cell (0,0)
   dropped, the result added into y tile ``byt[t]``.  The kernel reads
   vals, word and xg by 16-byte loads, 256 threads a tile
   (:func:`spmv_gathered_grid` gives its launch shape).

The port packs exactly (no pow-2 chunk count); the wrappers take the JAX
package's bucketed arrays and meta as well.
"""

from __future__ import annotations

import numpy as np
import torch

from hispmv_tpu_torch.ops import cuda_build
from hispmv_tpu_torch.ops.permute import clos_gather, permute_stage
from hispmv_tpu_torch.ops.spmv_chunked import check_aligned, check_cuda_tensors
from hispmv_tpu_torch.plan.gathered import GatheredPlan
from hispmv_tpu_torch.utils.trace import traced

LANES = 128
WINDOW = 1024


def pack_gathered(plan: GatheredPlan, tchunk: int = 1):
    """Arrays + static meta for one gathered plan: tiles padded to whole
    chunks of ``tchunk`` only, S3 one window a chunk.  Padding tiles have
    route 0 both ways and byt 0: they add exact zeros to y tile 0."""
    T = plan.num_tiles
    nch = max(-(-T // tchunk), 1)
    Tp = nch * tchunk
    vals = np.zeros((Tp, 8, LANES), np.float32)
    vals[:T] = plan.vals
    word = np.zeros((Tp, 8, LANES), np.int32)
    word[:T] = plan.word
    byt = np.zeros(Tp, np.int32)
    byt[:T] = plan.byt
    K = plan.num_windows
    P = plan.num_panels
    nch3 = max(T, 1)
    s3 = np.zeros((nch3, 8, LANES), np.int32)
    s3[:T] = plan.s3
    arrays = {
        "vals": vals.reshape(nch, tchunk * 8, LANES),
        "word": word.reshape(nch, tchunk * 8, LANES),
        "byt": byt,
        "s1": plan.s1.reshape(P * K * 8, LANES),
        "s2": plan.s2.reshape(P * K * 8, LANES),
        "s3": s3.reshape(nch3 * 8, LANES),
    }
    meta = {
        "K": K,
        "P": P,
        "panel_tiles": tuple(plan.panel_tiles),
        "T": T,
        "nch": nch,
        "tchunk": tchunk,
        "nch3": nch3,
        "tc3": 1,
    }
    return arrays, meta


# ---------------------------------------------------------------------------
# B12: S1, the within-x-window layered gather
# ---------------------------------------------------------------------------


def _check_s1(s1_words, x2d, P, K):
    if s1_words.dtype != torch.int32 or x2d.dtype != torch.float32:
        raise TypeError("s1_gather: words must be int32 and x float32")
    if P < 1 or K < 1:
        raise ValueError("s1_gather: P and K must be >= 1")
    if tuple(s1_words.shape) != (P * K * 8, LANES):
        raise ValueError(f"s1_gather: words shape {tuple(s1_words.shape)} is "
                         f"not [{P}*{K}*8, {LANES}]")
    if tuple(x2d.shape) != (K * 8, LANES):
        raise ValueError(f"s1_gather: x shape {tuple(x2d.shape)} is not "
                         f"[{K}*8, {LANES}]")


def s1_gather_plain(s1_words, x2d, P, K):
    """Plain PyTorch version of B12: per cell (s, j) of window ``p*K + k``,
    L = word & 127 and rank = (word >> 7) & 3 at (s, j), the rank's 3-bit
    sub field read at (s, L), and x window k's element [sub, L]."""
    w = s1_words.reshape(P, K, 8, LANES)
    lane = (w & 127).long()
    rank = (w >> 7) & 3
    sub = (torch.gather(w, 3, lane) >> (16 + 3 * rank)) & 7
    k = torch.arange(K, device=w.device).view(1, K, 1, 1)
    idx = (k * 8 + sub.long()) * LANES + lane
    return x2d.reshape(-1)[idx].reshape(P * K * 8, LANES)


@traced("kernel.B12")
def s1_gather(s1_words, x2d, P, K):
    """S1 of the gathered x gather: ``s1_words`` i32 [P*K*8, 128], ``x2d``
    f32 [K*8, 128] -> f32 [P*K*8, 128], panel p's window w gathered from x
    window w.  CPU tensors take the plain PyTorch version; CUDA tensors
    launch the CUDA kernel (csrc/spmv_gathered.cu) or raise, also when
    ``s1_words`` (read by 16-byte loads) is not 16-byte aligned."""
    _check_s1(s1_words, x2d, P, K)
    if x2d.device.type == "cpu":
        return s1_gather_plain(s1_words, x2d, P, K)
    check_cuda_tensors("s1_gather", x2d, s1_words)
    check_aligned("s1_gather", s1_words)
    lib = cuda_build.get_lib()
    out = torch.empty((P * K * 8, LANES), dtype=torch.float32,
                      device=x2d.device)
    with torch.cuda.device(x2d.device):
        rc = lib.hispmv_s1_gather(
            s1_words.data_ptr(), x2d.data_ptr(), out.data_ptr(), P * K, K,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(rc, "s1_gather")
    s1_gather.launches += 1
    return out


s1_gather.launches = 0  # kernel launches, for the smoke run's check


def s1_gather_grid(P, K):
    """B12's launch shape on P x K windows: (warps a CTA, rows, CTAs), a
    warp a row at a time, the CTAs one wave of the card's resident CTAs
    or fewer.  Needs the built library and a card."""
    return cuda_build.launch_shape("hispmv_s1_gather_grid", P * K)


def gathered_gather_apply(d: dict, meta: dict, prefix: str, x2d):
    """The full 3-stage gather (B12, B11, B11): ``x2d`` f32 [K*8, 128] (the
    routed executor's padded x, its first K windows) -> xg f32 [T*8, 128]
    in tile-slot order."""
    K, P = meta["K"], meta["P"]
    panel_tiles = meta["panel_tiles"]
    T = sum(panel_tiles)
    a = s1_gather(d[prefix + "s1"], x2d, P, K)
    # transpose (P, K, 1024) -> (P, 1024, K) -> grouped (P*K, 1024)
    at = a.reshape(P, K, WINDOW).transpose(1, 2).reshape(P * K * 8, LANES)
    b = permute_stage([d[prefix + "s2"].reshape(P * K, 8, LANES)],
                      (P * K, 1), at.contiguous())
    # ungroup + transpose back; keep each panel's real windows
    bt = b.reshape(P, WINDOW, K).transpose(1, 2)
    bt2 = torch.cat([bt[p, :pw] for p, pw in enumerate(panel_tiles)])
    nch3, tc3 = meta["nch3"], meta["tc3"]
    bt2 = bt2.reshape(T * 8, LANES)
    need = nch3 * tc3 * 8
    if bt2.shape[0] < need:
        bt2 = torch.nn.functional.pad(bt2, (0, 0, 0, need - bt2.shape[0]))
    xg = permute_stage([d[prefix + "s3"].reshape(nch3, tc3 * 8, LANES)],
                       (nch3, tc3), bt2.contiguous())
    return xg[: T * 8]


# ---------------------------------------------------------------------------
# B13: the tile kernel
# ---------------------------------------------------------------------------


def _check_tiles(vals3, word3, byt, xg, num_ytiles, nch, tchunk):
    if vals3.dtype != torch.float32 or xg.dtype != torch.float32:
        raise TypeError("spmv_gathered: vals and xg must be float32")
    if word3.dtype != torch.int32 or byt.dtype != torch.int32:
        raise TypeError("spmv_gathered: word and byt must be int32")
    shape = (nch, tchunk * 8, LANES)
    if tuple(vals3.shape) != shape or tuple(word3.shape) != shape:
        raise ValueError(f"spmv_gathered: vals {tuple(vals3.shape)} and word "
                         f"{tuple(word3.shape)} are not {list(shape)}")
    if tuple(byt.shape) != (nch * tchunk,):
        raise ValueError(f"spmv_gathered: byt must be [{nch * tchunk}]")
    if xg.ndim != 2 or xg.shape[1] != LANES or xg.shape[0] > nch * tchunk * 8:
        raise ValueError(f"spmv_gathered: xg must be [<= {nch * tchunk}*8, "
                         f"{LANES}], got {tuple(xg.shape)}")
    if num_ytiles < 1:
        raise ValueError("spmv_gathered: num_ytiles must be >= 1")


def spmv_gathered_tiles_plain(vals3, word3, byt, xg, num_ytiles, nch,
                              tchunk):
    """Plain PyTorch version of B13: fp64 ``cumsum`` over each tile's 1024
    flat slots, two :func:`clos_gather` of the prefix, their difference
    in fp32, cell (0,0) zeroed, ``index_add_`` into y tile ``byt``."""
    Tp = nch * tchunk
    xg = torch.nn.functional.pad(xg, (0, 0, 0, Tp * 8 - xg.shape[0]))
    p = vals3.reshape(Tp, WINDOW).double() * xg.reshape(Tp, WINDOW)
    pf = torch.cumsum(p, dim=1).reshape(Tp, 8, LANES)
    word = word3.reshape(Tp, 8, LANES)
    out = (clos_gather(word & 0x1FFF, pf)
           - clos_gather((word >> 13) & 0x1FFF, pf)).float()
    out[:, 0, 0] = 0.0  # trash cell
    keep = byt < num_ytiles
    y = torch.zeros((num_ytiles, WINDOW), dtype=torch.float32,
                    device=xg.device)
    y.index_add_(0, byt[keep].long(), out[keep].reshape(-1, WINDOW))
    return y.reshape(num_ytiles * 8, LANES)


@traced("kernel.B13")
def spmv_gathered_tiles(vals3, word3, byt, xg, num_ytiles, nch, tchunk):
    """Run the gathered tile kernel; returns y f32 [num_ytiles*8, 128].
    ``vals3`` / ``word3`` f32 / i32 [nch, tchunk*8, 128] and ``byt`` i32
    [nch*tchunk] from :func:`pack_gathered`, ``xg`` f32 [<= nch*tchunk*8,
    128] from :func:`gathered_gather_apply` (missing rows read as 0).  CPU
    tensors take the plain PyTorch version; CUDA tensors launch the CUDA
    kernel (csrc/spmv_gathered.cu) or raise, also when ``vals3``,
    ``word3`` or ``xg`` (read by 16-byte loads) is not 16-byte aligned."""
    _check_tiles(vals3, word3, byt, xg, num_ytiles, nch, tchunk)
    if xg.device.type == "cpu":
        return spmv_gathered_tiles_plain(vals3, word3, byt, xg, num_ytiles,
                                         nch, tchunk)
    check_cuda_tensors("spmv_gathered", xg, vals3, word3, byt)
    check_aligned("spmv_gathered", vals3, word3, xg)
    lib = cuda_build.get_lib()
    y = torch.zeros((num_ytiles * 8, LANES), dtype=torch.float32,
                    device=xg.device)
    with torch.cuda.device(xg.device):
        rc = lib.hispmv_spmv_gathered(
            vals3.data_ptr(), word3.data_ptr(), byt.data_ptr(),
            xg.data_ptr(), xg.shape[0], y.data_ptr(), num_ytiles,
            nch * tchunk, torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(rc, "spmv_gathered")
    spmv_gathered_tiles.launches += 1
    return y


spmv_gathered_tiles.launches = 0  # kernel launches, for the smoke run's check


def spmv_gathered_grid(num_tiles):
    """B13's launch shape on ``num_tiles`` tiles: (threads a CTA, CTAs,
    resident CTAs an SM), 256 threads and one CTA a tile.  Needs the
    built library and a card."""
    return cuda_build.launch_shape("hispmv_spmv_gathered_grid", num_tiles)
