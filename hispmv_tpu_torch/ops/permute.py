"""B11, the within-window permutation stage, and the full-permutation
driver on PyTorch.

Port of ``hispmv_tpu/ops/permute.py``.  A plan (``plan/permute.py``) moves
``x`` to ``x[perm]`` as S1 -> transpose -> S2 -> transpose -> S3; each stage
permutes within (8,128) windows by one 13-bit route word per element
(``subA | laneB<<3 | subC<<10``).  The stage is the CUDA kernel
``csrc/permute.cu``, with :func:`permute_stage_plain` (three
``torch.gather`` calls, as the TPU's three ``take_along_axis``) beside it;
the transposes and pads between stages are plain torch, as the JAX package
leaves them to XLA.

The port packs stages with one window per chunk and no pow-2 bucketing
(``pack_permute_plan``), so no padded window is permuted; ``pack_stage``
keeps the JAX package's chunking behind its ``tchunk``/``bucket``
arguments, so tests can feed both packages identical arrays.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from hispmv_tpu_torch.ops import cuda_build
from hispmv_tpu_torch.ops.spmv_chunked import check_aligned, check_cuda_tensors
from hispmv_tpu_torch.plan.permute import WINDOW, PermutePlan, WindowStage
from hispmv_tpu_torch.utils.device import resolve_device
from hispmv_tpu_torch.utils.trace import traced

LANES = 128
TCHUNK = 16


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def pack_stage(stage: WindowStage, tchunk: int = TCHUNK, bucket: bool = True):
    """Pad a stage's route array to whole chunks of ``tchunk`` windows
    (optionally bucketing the chunk count to a power of two, as the JAX
    package does).  Returns ``((route,), (nch, tchunk))`` with route i32
    [nch, tchunk*8, 128].  Padding windows get route word 0 (they only
    permute padding data)."""
    W = stage.num_windows
    nch = max(-(-W // tchunk), 1)
    if bucket:
        nch = _bucket(nch)
    Wp = nch * tchunk

    route = np.zeros((Wp, 8, LANES), np.int32)
    route[:W] = stage.route
    return (route.reshape(nch, tchunk * 8, LANES),), (nch, tchunk)


def _check_stage_args(arrays, dims, a):
    nch, tchunk = dims
    if len(arrays) != 1:
        raise ValueError("permute_stage: one route array per stage")
    (route,) = arrays
    if route.dtype != torch.int32 or a.dtype != torch.float32:
        raise TypeError("permute_stage: route must be int32 and a float32")
    if tuple(route.shape) != (nch, tchunk * 8, LANES):
        raise ValueError(f"permute_stage: route shape {tuple(route.shape)} "
                         f"is not [{nch}, {tchunk}*8, {LANES}]")
    if tuple(a.shape) != (nch * tchunk * 8, LANES):
        raise ValueError(f"permute_stage: a shape {tuple(a.shape)} is not "
                         f"[{nch}*{tchunk}*8, {LANES}]")
    return route


def clos_gather(route, a):
    """The three gathers of one 13-bit route word per cell (``subA |
    laneB<<3 | subC<<10``) on windows ``a`` [W, 8, 128] with ``route`` of
    the same shape: a sublane, a lane and a sublane gather."""
    sub_a = (route & 7).long()
    lane_b = ((route >> 3) & 127).long()
    sub_c = ((route >> 10) & 7).long()
    a1 = torch.gather(a, 1, sub_a)
    b1 = torch.gather(a1, 2, lane_b)
    return torch.gather(b1, 1, sub_c)


def permute_stage_plain(arrays, dims, a):
    """Plain PyTorch version of B11: :func:`clos_gather` per window."""
    (route,) = arrays
    Wp = dims[0] * dims[1]
    return clos_gather(route.reshape(Wp, 8, LANES),
                       a.reshape(Wp, 8, LANES)).reshape(Wp * 8, LANES)


@traced("kernel.B11")
def permute_stage(arrays, dims, a):
    """Apply one within-window stage to ``a`` f32 [Wp*8, 128] (Wp from
    ``dims``); returns the permuted array of the same shape.  CPU tensors
    take the plain PyTorch version; CUDA tensors launch the CUDA kernel
    (csrc/permute.cu) or raise, also when the route or ``a`` (read by
    16-byte loads) is not 16-byte aligned."""
    route = _check_stage_args(arrays, dims, a)
    if a.device.type == "cpu":
        return permute_stage_plain(arrays, dims, a)
    check_cuda_tensors("permute_stage", a, route)
    check_aligned("permute_stage", route, a)
    lib = cuda_build.get_lib()
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        rc = lib.hispmv_permute_stage(
            route.data_ptr(), a.data_ptr(), out.data_ptr(),
            dims[0] * dims[1], torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(rc, "permute_stage")
    permute_stage.launches += 1
    return out


permute_stage.launches = 0  # kernel launches, for the smoke run's check


def permute_stage_grid(nwin):
    """B11's launch shape on ``nwin`` windows: (windows a CTA, threads a
    CTA, CTAs).  Needs the built library."""
    return cuda_build.launch_shape("hispmv_permute_stage_grid", nwin)


def pack_permute_plan(plan: PermutePlan, device="cuda") -> dict:
    """All three stages as device tensors (one window per chunk, no
    padding) + shape metadata."""
    device = resolve_device(device)
    stages = [pack_stage(s, tchunk=1, bucket=False)
              for s in (plan.s1, plan.s2, plan.s3)]
    return {
        "arrays": [[torch.from_numpy(r).to(device) for r in arrays]
                   for arrays, _ in stages],
        "dims": [dims for _, dims in stages],
        "n": plan.n,
        "num_windows": plan.num_windows,
    }


def pack_permute_into(d: dict, plan: PermutePlan, prefix: str,
                      device="cuda") -> dict:
    """Store a plan's stage arrays in device dict ``d`` under ``prefix``;
    returns the static meta the runner needs to reassemble them."""
    packed = pack_permute_plan(plan, device)
    counts = []
    for si, arrays in enumerate(packed["arrays"]):
        counts.append(len(arrays))
        for ai, a in enumerate(arrays):
            d[f"{prefix}a{si}_{ai}"] = a
    return {
        "n": packed["n"],
        "num_windows": packed["num_windows"],
        "dims": packed["dims"],
        "counts": counts,
    }


def permute_apply_from(d: dict, meta: dict, prefix: str, x):
    """Apply a plan stored by ``pack_permute_into``."""
    arrays = [
        [d[f"{prefix}a{si}_{ai}"] for ai in range(cnt)]
        for si, cnt in enumerate(meta["counts"])
    ]
    return permute_apply(meta, arrays, x)


def panel_permute_apply_from(d: dict, metas: list, prefix: str, x):
    """Apply per-panel plans to consecutive slices of ``x`` (panels of
    plan/permute.py PANEL elements; the last may be shorter)."""
    outs = []
    base = 0
    for i, meta in enumerate(metas):
        seg = x[base: base + meta["n"]]
        outs.append(permute_apply_from(d, meta, f"{prefix}{i}_", seg))
        base += meta["n"]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def permute_apply(meta: dict, arrays, x):
    """``y = x[perm]``: ``meta`` holds the dims, ``arrays`` the stage route
    arrays, ``x`` is f32 [n] (or longer; extra entries are ignored).
    Returns f32 [n]."""
    n = meta["n"]
    d1, d2, d3 = meta["dims"]
    Wp1 = d1[0] * d1[1]
    need = Wp1 * WINDOW
    x = F.pad(x, (0, need - x.shape[0])) if x.shape[0] < need else x[:need]
    if x.data_ptr() % 16:  # a view into a batch row: B11 reads by 16 bytes
        x = x.clone()
    a = permute_stage(arrays[0], d1, x.reshape(Wp1 * 8, LANES))
    # transpose to (1024, Wp1), pad cols to the S2 width (always 1024)
    at = a.reshape(Wp1, WINDOW).T
    Wp2 = d2[0] * d2[1]
    at = F.pad(at, (0, WINDOW - Wp1, 0, Wp2 - WINDOW)).contiguous()
    b = permute_stage(arrays[1], d2, at.reshape(Wp2 * 8, LANES))
    # transpose back: rows become the original window index; keep Wp3
    bt = b.reshape(Wp2, WINDOW)[:WINDOW].T
    Wp3 = d3[0] * d3[1]
    bt = bt[:Wp3].contiguous()
    y = permute_stage(arrays[2], d3, bt.reshape(Wp3 * 8, LANES))
    return y.reshape(-1)[:n]
