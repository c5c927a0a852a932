"""Multi-device SpMV: nnz-balanced row sharding over a list of devices.

Port of ``hispmv_tpu/dist/shard.py``.  The planners are carried over, so
the sharded plans equal the JAX package's array for array:

- rows are sharded across devices in contiguous row-block runs, with the
  split points chosen so each device carries an (approximately) equal
  number of dense blocks;
- x is replicated, or column-sharded and gathered ("gather"), or rotated
  around a ring ("ring", the chunked executor);
- y comes out row-sharded with no communication (the planner keeps whole
  row-blocks on one device) and is then put back together.

The JAX package runs one program over a ``Mesh`` of devices with
``shard_map``, and the mesh may span processes.  The executors here take
either of two meshes, and the mesh's type picks the exchange:

- :class:`Mesh`, one process: a tuple of ``torch.device``\\ s, shard d's
  arrays on ``devices[d]``, every x exchange a device-to-device copy, y
  put back together on ``devices[0]``.  The tuple may repeat one card (or
  name ``"cpu"``): then the planner, the padding, the local row-block ids,
  the ring schedule and the reassembly all run as on D devices, while the
  copies stay on one card.  Such a mesh shows the schedule, not the
  interconnect's bandwidth.
- :class:`ProcessMesh`, one rank a device under ``torch.distributed``
  (NCCL on cards, gloo on the CPU): every rank builds the same plan and
  holds only its own shard; x is gathered by ``all_gather_into_tensor`` or
  rotated by ``batch_isend_irecv``, and y is all-gathered, so every rank
  returns the full y on its device.

Per shard the executors launch B5 (``spmv_sharded``, ops/spmv_block.py),
B7 (``spmv_sharded_window``, ops/spmv_windowed.py) or B3 per ring step
(``spmv_sharded_chunked``, ops/spmv_chunked.py), the same call in both
forms.  A plan's shards are uploaded to their devices once
(:func:`to_device`, also at the first call) and kept on the plan.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from hispmv_tpu_torch.formats.matrix import COOMatrix
from hispmv_tpu_torch.ops.spmv_block import run_starts, spmv_block_stream
from hispmv_tpu_torch.ops.spmv_chunked import chunk_for, spmv_chunked_paneled
from hispmv_tpu_torch.ops.spmv_windowed import (
    chunk_for_windowed,
    spmv_windowed,
)
from hispmv_tpu_torch.plan.blocks import LANES, BlockPlan, build_block_plan
from hispmv_tpu_torch.plan.windows import SEGS, build_window_plan
from hispmv_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices a sharded plan runs on: shard d on ``devices[d]``."""

    devices: tuple  # of torch.device; may repeat one device
    axis: str = "rows"

    @property
    def size(self) -> int:
        return len(self.devices)


def _explicit(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(num_devices: Optional[int] = None, axis: str = "rows",
              devices=None) -> Mesh:
    """A mesh of the first ``num_devices`` CUDA cards (all of them when
    None); raises when there are fewer.  ``devices=`` names the devices
    instead, one per shard: a list that may repeat one card, or name
    ``"cpu"`` (the plain PyTorch versions then run).  There is no silent
    move to the CPU or onto a shared card."""
    if devices is not None:
        devs = tuple(_explicit(resolve_device(d)) for d in devices)
        if not devs or len({d.type for d in devs}) != 1:
            raise ValueError("make_mesh: name one or more devices, all CUDA "
                             "or all CPU")
        if num_devices is not None and num_devices != len(devs):
            raise ValueError(f"make_mesh: num_devices={num_devices} but "
                             f"{len(devs)} devices named")
        return Mesh(devs, axis)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if num_devices is None else num_devices
    if n < 1 or n > have:
        raise RuntimeError(
            f"make_mesh: {n} CUDA cards wanted, {have} present; name the "
            "devices with devices=[...] (one card may repeat, or 'cpu')"
        )
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


# the backend the port runs a process mesh's collectives on, by device type
_BACKEND_FOR = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """The ranks of a process group, one shard a rank: shard ``rank`` on
    this process's ``device``.  Raises when the group's backend cannot
    carry tensors on ``device`` (NCCL on a card, gloo on the CPU)."""

    group: object  # torch.distributed.ProcessGroup
    rank: int
    size: int
    device: torch.device

    def __post_init__(self):
        name = str(dist.get_backend(self.group))
        want = _BACKEND_FOR.get(self.device.type)
        # "nccl", or "cpu:gloo,cuda:nccl" for a group of several backends
        if name != want and f"{self.device.type}:{want}" not in \
                name.split(","):
            raise RuntimeError(
                f"ProcessMesh: the group's backend {name!r} cannot carry "
                f"tensors on {self.device}: the collectives run NCCL on a "
                "card and gloo on the CPU")


def make_process_mesh(device=None, group=None) -> ProcessMesh:
    """A mesh of the joined process group (the default group when None),
    this rank on ``local_device(device)``: ``cuda:$LOCAL_RANK`` unless a
    device is named.  Raises when no group has been joined
    (``init_distributed``)."""
    from hispmv_tpu_torch.dist.init import local_device

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_process_mesh: no process group has been "
                           "joined; call init_distributed() first (under "
                           "torchrun it reads the launcher's variables)")
    group = dist.group.WORLD if group is None else group
    return ProcessMesh(group, dist.get_rank(group), dist.get_world_size(group),
                       local_device(device))


AnyMesh = Union[Mesh, ProcessMesh]


def _local(mesh: AnyMesh) -> list:
    """(shard, device) of each shard this process runs: every shard of a
    Mesh, the rank's own of a ProcessMesh."""
    if isinstance(mesh, ProcessMesh):
        return [(mesh.rank, mesh.device)]
    return list(enumerate(mesh.devices))


def _home(mesh: AnyMesh) -> torch.device:
    """Where x is given and y is returned."""
    return mesh.device if isinstance(mesh, ProcessMesh) else mesh.devices[0]


def _cache_field():
    # device arrays per mesh, filled by to_device(); not part of the plan
    return dataclasses.field(default_factory=dict, repr=False, compare=False)


@dataclasses.dataclass
class ShardedBlockPlan:
    """Per-device stacked block streams (leading axis = device)."""

    shape: tuple
    nnz: int
    block_h: int
    num_devices: int
    # stacked, padded arrays; leading dim D
    data: np.ndarray  # f32 [D, nb_max, block_h, LANES]
    block_rows: np.ndarray  # i32 [D, nb_max] LOCAL row-block ids
    block_cols: np.ndarray  # i32 [D, nb_max]
    block_firsts: np.ndarray  # i32 [D, nb_max]
    block_lasts: np.ndarray  # i32 [D, nb_max]
    nrb_per_dev: tuple  # real row-blocks per device
    nrb_max: int
    num_col_blocks: int
    blocks_per_dev: tuple  # real (unpadded) block count per device
    device_cache: dict = _cache_field()

    @property
    def balance(self) -> float:
        """max/mean block load across devices (1.0 = perfect)."""
        loads = np.asarray(self.blocks_per_dev, np.float64)
        return float(loads.max() / max(loads.mean(), 1e-9))


def _split_boundaries(counts: np.ndarray, parts: int) -> np.ndarray:
    """Split a sequence of per-item weights into ``parts`` contiguous chunks
    with near-equal weight (prefix-sum bisection)."""
    cum = np.concatenate([[0], np.cumsum(counts)])
    total = cum[-1]
    targets = total * np.arange(1, parts) / parts
    cuts = np.searchsorted(cum, targets, side="left")
    cuts = np.clip(cuts, 1, len(counts))
    if len(counts) >= parts:
        # enough items: make every chunk non-empty (strictly increasing
        # cuts with room left for the chunks after each cut)
        for i in range(len(cuts) - 1, -1, -1):
            cuts[i] = min(cuts[i], len(counts) - (len(cuts) - i))
        for i in range(len(cuts)):
            lo = cuts[i - 1] + 1 if i else 1
            cuts[i] = max(cuts[i], lo)
    else:
        # fewer items than devices: leading chunks get one item each
        cuts = np.minimum(np.arange(1, parts), len(counts))
    return np.concatenate([[0], cuts, [len(counts)]]).astype(np.int64)


def _device_slices(block_rows, nrb, num_devices):
    """Balanced row-block boundaries and each device's [start, end) of the
    block stream."""
    blocks_per_rb = np.bincount(block_rows, minlength=nrb)
    bounds = _split_boundaries(blocks_per_rb, num_devices)
    rb_starts = np.concatenate([[0], np.cumsum(blocks_per_rb)])
    slices = [
        (int(rb_starts[bounds[d]]), int(rb_starts[bounds[d + 1]]))
        for d in range(num_devices)
    ]
    nrb_per_dev = tuple(
        int(bounds[d + 1] - bounds[d]) for d in range(num_devices)
    )
    return bounds, slices, nrb_per_dev


def build_sharded_block_plan(
    coo: COOMatrix,
    num_devices: int,
    block_h: int = 8,
    col_perm: Optional[np.ndarray] = None,
) -> ShardedBlockPlan:
    """Build one global block plan, then cut it into balanced device shards."""
    plan: BlockPlan = build_block_plan(coo, block_h=block_h, col_perm=col_perm)
    bounds, dev_slices, nrb_per_dev = _device_slices(
        plan.block_rows, plan.num_row_blocks, num_devices)
    nb_real = [e - s for s, e in dev_slices]
    nb_max = max(max(nb_real), 1)
    nrb_max = max(max(nrb_per_dev), 1)

    D = num_devices
    data = np.zeros((D, nb_max, block_h, LANES), np.float32)
    rows = np.zeros((D, nb_max), np.int32)
    cols = np.zeros((D, nb_max), np.int32)
    firsts = np.zeros((D, nb_max), np.int32)
    lasts = np.zeros((D, nb_max), np.int32)
    for d, (s, e) in enumerate(dev_slices):
        n = e - s
        if n == 0:
            # degenerate empty shard: one zero block on local row-block 0
            rows[d, 0] = 0
            firsts[d, 0] = 1
            lasts[d, 0] = 1
            continue
        data[d, :n] = plan.data[s:e]
        rows[d, :n] = plan.block_rows[s:e] - int(bounds[d])  # localize
        cols[d, :n] = plan.block_cols[s:e]
        firsts[d, :n] = plan.block_firsts[s:e]
        lasts[d, :n] = plan.block_lasts[s:e]
        # padding blocks: revisit the shard's last row-block, contribute
        # nothing, never flush (data stays zero, firsts/lasts stay 0)
        if n < nb_max:
            rows[d, n:] = rows[d, n - 1]

    return ShardedBlockPlan(
        shape=plan.shape,
        nnz=plan.nnz,
        block_h=block_h,
        num_devices=D,
        data=data,
        block_rows=rows,
        block_cols=cols,
        block_firsts=firsts,
        block_lasts=lasts,
        nrb_per_dev=nrb_per_dev,
        nrb_max=nrb_max,
        num_col_blocks=plan.num_col_blocks,
        blocks_per_dev=tuple(nb_real),
    )


# ---------------------------------------------------------------------------
# Windowed-format sharding: same contiguous nnz-balanced row-block splits,
# with the windowed stream's sub-index sideband carried per shard.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedWindowPlan:
    shape: tuple
    nnz: int
    block_h: int
    num_devices: int
    data: np.ndarray  # f32 [D, nb_max, block_h, LANES]
    subidx: np.ndarray  # i32 [D, nb_max, LANES]
    block_rows: np.ndarray  # i32 [D, nb_max] local row-block ids
    block_wins: np.ndarray  # i32 [D, nb_max]
    block_firsts: np.ndarray  # i32 [D, nb_max]
    block_lasts: np.ndarray  # i32 [D, nb_max]
    nrb_per_dev: tuple
    nrb_max: int
    num_windows: int
    blocks_per_dev: tuple
    device_cache: dict = _cache_field()

    @property
    def balance(self) -> float:
        loads = np.asarray(self.blocks_per_dev, np.float64)
        return float(loads.max() / max(loads.mean(), 1e-9))


def build_sharded_window_plan(
    coo: COOMatrix, num_devices: int, block_h: int = 8
) -> ShardedWindowPlan:
    plan = build_window_plan(coo, block_h=block_h)
    bounds, dev_slices, nrb_per_dev = _device_slices(
        plan.block_rows, plan.num_row_blocks, num_devices)
    nb_real = [e - s for s, e in dev_slices]
    nb_max = max(max(nb_real), 1)
    # pad shard length to a whole number of chunks
    chunk = min(chunk_for_windowed(block_h), max(nb_max, 8))
    nb_max = -(-nb_max // chunk) * chunk
    nrb_max = max(max(nrb_per_dev), 1)

    D = num_devices
    data = np.zeros((D, nb_max, block_h, LANES), np.float32)
    subidx = np.zeros((D, nb_max, LANES), np.int32)
    rows = np.zeros((D, nb_max), np.int32)
    wins = np.zeros((D, nb_max), np.int32)
    firsts = np.zeros((D, nb_max), np.int32)
    lasts = np.zeros((D, nb_max), np.int32)
    for d, (s, e) in enumerate(dev_slices):
        n = e - s
        if n == 0:
            rows[d, 0] = 0
            firsts[d, 0] = 1
            lasts[d, 0] = 1
            continue
        data[d, :n] = plan.data[s:e]
        subidx[d, :n] = plan.subidx[s:e]
        rows[d, :n] = plan.block_rows[s:e] - int(bounds[d])
        wins[d, :n] = plan.block_wins[s:e]
        firsts[d, :n] = plan.block_firsts[s:e]
        lasts[d, :n] = plan.block_lasts[s:e]
        if n < nb_max:
            rows[d, n:] = rows[d, n - 1]

    return ShardedWindowPlan(
        shape=plan.shape,
        nnz=plan.nnz,
        block_h=block_h,
        num_devices=D,
        data=data,
        subidx=subidx,
        block_rows=rows,
        block_wins=wins,
        block_firsts=firsts,
        block_lasts=lasts,
        nrb_per_dev=nrb_per_dev,
        nrb_max=nrb_max,
        num_windows=plan.num_windows,
        blocks_per_dev=tuple(nb_real),
    )


# ---------------------------------------------------------------------------
# Chunked stream + x ring: x column-sharded, rotated device to device while
# each device processes the segment of the x shard it holds.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedChunkedPlan:
    """Per-device, per-x-shard chunked segments (ring schedule).

    data5 [D, STEP, nch_max, chunk*bh, LANES]: device d's blocks for RING
    STEP t (i.e. x shard (d - t) mod D, the shard device d holds after t
    rotations), packed as an add-flush chunked stream with shard-local
    column ids.  meta5 [D, STEP, nch_max, 2, chunk].
    """

    shape: tuple
    nnz: int
    block_h: int
    chunk: int
    num_devices: int
    data5: np.ndarray
    meta5: np.ndarray
    nrb_per_dev: tuple
    nrb_max: int
    num_col_blocks: int
    ncb_per_shard: int
    blocks_per_dev: tuple
    device_cache: dict = _cache_field()

    @property
    def balance(self) -> float:
        loads = np.asarray(self.blocks_per_dev, np.float64)
        return float(loads.max() / max(loads.mean(), 1e-9))


def build_sharded_chunked_plan(
    coo: COOMatrix,
    num_devices: int,
    block_h: int = 8,
    chunk: Optional[int] = None,
) -> ShardedChunkedPlan:
    plan: BlockPlan = build_block_plan(coo, block_h=block_h)
    D = num_devices
    bh = block_h
    chunk = chunk or min(chunk_for(bh), 128)
    ncb = plan.num_col_blocks
    ncb_per = max(-(-ncb // D), 1)
    bounds, dev_slices, nrb_per_dev = _device_slices(
        plan.block_rows, plan.num_row_blocks, D)
    nrb_max = max(max(nrb_per_dev), 1)

    # segment blocks by (device, x shard); count chunks
    segs = {}
    nch_max = 1
    blocks_per_dev = []
    for d, (s0, e0) in enumerate(dev_slices):
        blocks_per_dev.append(e0 - s0)
        rows_l = plan.block_rows[s0:e0] - int(bounds[d])
        cols_g = plan.block_cols[s0:e0]
        shard = cols_g // ncb_per
        for s in range(D):
            sel = shard == s
            n = int(sel.sum())
            segs[(d, s)] = (
                plan.data[s0:e0][sel],
                rows_l[sel],
                (cols_g - s * ncb_per)[sel],
            )
            nch_max = max(nch_max, -(-n // chunk))

    data5 = np.zeros((D, D, nch_max, chunk * bh, LANES), np.float32)
    meta5 = np.zeros((D, D, nch_max, 2, chunk), np.int32)
    for (d, s), (dat, rows_l, cols_l) in segs.items():
        step = (d - s) % D  # ring step at which device d holds shard s
        n = len(rows_l)
        if n == 0:
            continue
        n_pad = nch_max * chunk
        db = np.zeros((n_pad, bh, LANES), np.float32)
        db[:n] = dat
        m = np.zeros((2, n_pad), np.int32)
        # add-flush kernel: last flag per (row_block) run within the segment
        lasts = np.ones(n, np.int32)
        lasts[:-1] = (rows_l[1:] != rows_l[:-1]).astype(np.int32)
        m[0, :n] = rows_l * 2 + lasts
        m[1, :n] = cols_l
        if n_pad > n:
            m[0, n:] = rows_l[-1] * 2
        data5[d, step] = db.reshape(nch_max, chunk * bh, LANES)
        meta5[d, step] = np.ascontiguousarray(
            m.reshape(2, nch_max, chunk).transpose(1, 0, 2)
        )

    return ShardedChunkedPlan(
        shape=plan.shape,
        nnz=plan.nnz,
        block_h=bh,
        chunk=chunk,
        num_devices=D,
        data5=data5,
        meta5=meta5,
        nrb_per_dev=nrb_per_dev,
        nrb_max=nrb_max,
        num_col_blocks=ncb,
        ncb_per_shard=ncb_per,
        blocks_per_dev=tuple(blocks_per_dev),
    )


# ---------------------------------------------------------------------------
# Upload and execution
# ---------------------------------------------------------------------------


def _shard_arrays(splan, d: int) -> dict:
    """Shard d's arrays in the form its kernel takes (host side)."""
    if isinstance(splan, ShardedBlockPlan):
        return {"data": splan.data[d], "rows": splan.block_rows[d],
                "cols": splan.block_cols[d], "firsts": splan.block_firsts[d],
                "lasts": splan.block_lasts[d],
                "starts": run_starts(splan.block_firsts[d]).numpy()}
    if isinstance(splan, ShardedWindowPlan):
        # the packed 2-row meta of the windowed stream, cut into chunks
        nb_max, bh = splan.data.shape[1], splan.block_h
        chunk = _window_chunk(splan)
        nch = nb_max // chunk
        meta = np.stack([splan.block_rows[d] * 2 + splan.block_lasts[d],
                         splan.block_wins[d]])
        return {"data": splan.data[d].reshape(nch, chunk * bh, LANES),
                "subidx": splan.subidx[d].reshape(nch, chunk, LANES),
                "meta": meta.reshape(2, nch, chunk).transpose(1, 0, 2)}
    if isinstance(splan, ShardedChunkedPlan):
        return {"data": splan.data5[d], "meta": splan.meta5[d],
                "panels": np.zeros(splan.data5.shape[2], np.int32)}
    raise TypeError(f"not a sharded plan: {type(splan)}")


def _window_chunk(splan: ShardedWindowPlan) -> int:
    nb_max = splan.data.shape[1]
    chunk = min(chunk_for_windowed(splan.block_h), nb_max)
    assert nb_max % chunk == 0, (nb_max, chunk)
    return chunk


def to_device(splan, mesh: AnyMesh) -> list:
    """The shards this process runs, on their devices, as one dict of
    tensors per shard: shard d on ``mesh.devices[d]`` for a Mesh, only the
    rank's own shard on its device for a ProcessMesh.  Uploaded once per
    mesh and kept on the plan; every executor calls it."""
    if mesh.size != splan.num_devices:
        raise ValueError(f"plan has {splan.num_devices} shards, mesh "
                         f"{mesh.size} devices")
    key = ((mesh.rank, mesh.device) if isinstance(mesh, ProcessMesh)
           else mesh.devices)
    shards = splan.device_cache.get(key)
    if shards is None:
        shards = [
            {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for k, a in _shard_arrays(splan, d).items()}
            for d, dev in _local(mesh)
        ]
        splan.device_cache[key] = shards
    return shards


def device_bytes(splan, mesh: AnyMesh) -> int:
    """Bytes of the plan's shards that this process holds on its devices."""
    return sum(int(t.nbytes) for sh in to_device(splan, mesh)
               for t in sh.values())


def _padded_x(x, num_cols: int, target: int, dev) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    if x.shape[0] != num_cols:
        raise ValueError(
            f"x has {x.shape[0]} entries, matrix has {num_cols} columns"
        )
    if target > x.shape[0]:
        x = torch.nn.functional.pad(x, (0, target - x.shape[0]))
    return x


def _x_per_device(x, mesh: AnyMesh, x_mode: str, per_dev: int) -> list:
    """Full x on the device of each shard this process runs: as it is
    ("replicated"), or cut into one ``per_dev`` slice per shard and
    all-gathered ("gather"); across ranks by ``all_gather_into_tensor``."""
    if x_mode not in ("replicated", "gather"):
        raise ValueError(f"unknown x_mode {x_mode!r}")
    if isinstance(mesh, ProcessMesh):
        if x_mode == "replicated":
            return [x]
        r = mesh.rank
        full = torch.empty(mesh.size * per_dev, dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(full, x[r * per_dev:(r + 1) * per_dev],
                                    group=mesh.group)
        return [full]
    if x_mode == "replicated":
        return [x.to(dev) for dev in mesh.devices]
    shards = [x[d * per_dev:(d + 1) * per_dev].to(dev)
              for d, dev in enumerate(mesh.devices)]
    return [torch.cat([s.to(dev) for s in shards]) for dev in mesh.devices]


def _gather_y(ys: list, splan, mesh: AnyMesh) -> torch.Tensor:
    """Shard d's first nrb_per_dev[d] row-blocks, concatenated and cut to
    the matrix's rows: on the mesh's first device for a Mesh, on every
    rank's device for a ProcessMesh, whose ranks all-gather their padded
    ``nrb_max`` row-blocks first (every rank joins, an empty shard too)."""
    bh = splan.block_h
    if isinstance(mesh, ProcessMesh):
        (y,) = ys
        full = torch.empty(mesh.size * splan.nrb_max * bh, dtype=y.dtype,
                           device=y.device)
        dist.all_gather_into_tensor(full, y.reshape(-1), group=mesh.group)
        ys = full.view(mesh.size, -1)
    home = _home(mesh)
    pieces = [y.reshape(-1)[: splan.nrb_per_dev[d] * bh].to(home)
              for d, y in enumerate(ys)]
    return torch.cat(pieces)[: splan.shape[0]]


def spmv_sharded(splan: ShardedBlockPlan, x, mesh: AnyMesh, *,
                 x_mode: str = "replicated") -> torch.Tensor:
    """Distributed ``y = A @ x`` through B5 on each shard; returns the full
    y on ``mesh.devices[0]`` (a Mesh) or on every rank's device (a
    ProcessMesh, where each rank is given the full x).

    ``x_mode="gather"`` shards x over the mesh and all-gathers it on every
    device (``"replicated"`` copies the whole x to each)."""
    D = splan.num_devices
    Cp = splan.num_col_blocks * LANES
    per_dev = -(-Cp // (D * LANES)) * LANES
    shards = to_device(splan, mesh)
    x = _padded_x(x, splan.shape[1], per_dev * D, _home(mesh))
    ys = []
    for sh, xg in zip(shards, _x_per_device(x, mesh, x_mode, per_dev)):
        ys.append(spmv_block_stream(
            sh["data"], sh["rows"], sh["cols"], sh["firsts"], sh["lasts"],
            xg[:Cp].reshape(-1, 1, LANES), splan.nrb_max,
            starts=sh["starts"],
        ))
    return _gather_y(ys, splan, mesh)


def spmv_sharded_window(splan: ShardedWindowPlan, x, mesh: AnyMesh, *,
                        x_mode: str = "replicated") -> torch.Tensor:
    """Distributed windowed SpMV through B7 on each shard; the same
    communication as :func:`spmv_sharded`."""
    D = splan.num_devices
    Cp = splan.num_windows * SEGS * LANES
    per_dev = -(-Cp // (D * LANES)) * LANES
    chunk = _window_chunk(splan)
    shards = to_device(splan, mesh)
    x = _padded_x(x, splan.shape[1], per_dev * D, _home(mesh))
    ys = []
    for sh, xg in zip(shards, _x_per_device(x, mesh, x_mode, per_dev)):
        ys.append(spmv_windowed(
            sh["data"], sh["subidx"], sh["meta"],
            xg[:Cp].reshape(-1, LANES), splan.nrb_max, splan.block_h, chunk,
        ))
    return _gather_y(ys, splan, mesh)


def _copy_streams(side: list, devs: tuple, p: int, q: int):
    """Streams current for the copy from position p to q: PyTorch runs a
    copy between two cards on the source's current stream, fenced with the
    destination's, so both are set to their side streams."""
    ctx = contextlib.ExitStack()
    if devs[p] != devs[q]:
        ctx.enter_context(torch.cuda.stream(side[p]))
    ctx.enter_context(torch.cuda.stream(side[q]))
    return ctx


def _ring_cuda(x_shards: list, mesh: Mesh, step) -> None:
    """The x ring on CUDA devices.  Before step t's kernels, each position
    p's shard is copied to position (p+1) mod D on a side stream, into the
    second of two buffers, so the copy overlaps the kernels; events order
    each copy after the copy that filled its source and after the kernel
    and the copy that last read its target, and each kernel after the copy
    that filled its x."""
    devs = mesh.devices
    D = len(devs)
    compute = [torch.cuda.current_stream(dev) for dev in devs]
    # one copy stream per position, on its device (PyTorch's stream pool)
    side = [torch.cuda.Stream(device=dev) for dev in devs]
    cur = x_shards
    nxt = [torch.empty_like(c) for c in cur]

    def record(stream):
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    arrived = [record(compute[p]) for p in range(D)]  # cur[p] is complete
    for q in range(D):
        side[q].wait_stream(compute[q])  # nxt[q] was allocated there
    read = [None] * D  # kernel that last read the buffer now in nxt[p]
    sent = [None] * D  # copy that last read the buffer now in nxt[p]
    for t in range(D):
        if t < D - 1:
            new_arrived, new_sent = [None] * D, [None] * D
            for p in range(D):
                q = (p + 1) % D
                side[q].wait_event(arrived[p])
                for ev in (read[q], sent[q]):
                    if ev is not None:
                        side[q].wait_event(ev)
                with _copy_streams(side, devs, p, q):
                    nxt[q].copy_(cur[p], non_blocking=True)
                new_arrived[q] = new_sent[p] = record(side[q])
                spmv_sharded_chunked.rotations += 1
        for p in range(D):
            compute[p].wait_event(arrived[p])
            step(p, t, cur[p])
            read[p] = record(compute[p])
        if t < D - 1:
            cur, nxt = nxt, cur
            arrived, sent = new_arrived, new_sent
    for p in range(D):  # the buffers go back to the compute streams
        compute[p].wait_stream(side[p])


def _ring_ranks(x_own: torch.Tensor, mesh: ProcessMesh, step) -> None:
    """The x ring over ranks.  Before step t's kernel, the rank posts the
    send of the shard it holds to rank r+1 and the receive from rank r-1
    into its second buffer, in one ``batch_isend_irecv``, so the exchange
    overlaps the kernel; it waits on both before step t+1 reads the
    received shard.  Waiting orders NCCL's stream before the current one,
    and NCCL's stream waits for the kernels already queued (step t-1's read
    of the buffer the receive lands in) before it starts."""
    D, r = mesh.size, mesh.rank
    cur, nxt = x_own, torch.empty_like(x_own)
    for t in range(D):
        if t < D - 1:
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cur, (r + 1) % D, mesh.group),
                dist.P2POp(dist.irecv, nxt, (r - 1) % D, mesh.group),
            ])
            spmv_sharded_chunked.rotations += 1
        step(0, t, cur)
        if t < D - 1:
            for req in reqs:
                req.wait()
            cur, nxt = nxt, cur


def spmv_sharded_chunked(splan: ShardedChunkedPlan, x, mesh: AnyMesh, *,
                         x_mode: str = "ring") -> torch.Tensor:
    """Distributed chunked SpMV through B3, one launch per shard and ring
    step (all panel ids zero: the x panel is the shard the device holds);
    returns the full y on ``mesh.devices[0]`` (a Mesh) or on every rank's
    device (a ProcessMesh).

    ``x_mode="ring"``: x column-sharded; D ring steps, each computing the
    segment of the x shard the device currently holds while the shards
    rotate to the next device (counted in ``spmv_sharded_chunked.rotations``:
    D - 1 rounds of D copies in one process, D - 1 sends a rank).
    ``"replicated"``: every device holds the full x and runs its D segments
    back to back (no exchange)."""
    D = splan.num_devices
    bh, chunk, nrb_max = splan.block_h, splan.chunk, splan.nrb_max
    ncb_per = splan.ncb_per_shard
    per = ncb_per * LANES
    local = _local(mesh)
    shards = to_device(splan, mesh)
    x = _padded_x(x, splan.shape[1], D * per, _home(mesh))
    ys = [torch.zeros((nrb_max, bh), dtype=torch.float32, device=dev)
          for _, dev in local]

    def step(i, t, x_shard):
        """Ring step t of the i-th shard this process runs: the segment of
        x shard (d - t) mod D, d that shard's position."""
        sh = shards[i]
        spmv_chunked_paneled(sh["data"][t], sh["meta"][t], sh["panels"],
                             x_shard.reshape(ncb_per, LANES), nrb_max, bh,
                             chunk, ncb_per, out=ys[i])

    if x_mode == "ring":
        # each shard starts with its own x slice, in a buffer of its own
        x_shards = [x[d * per:(d + 1) * per].to(dev, copy=True)
                    for d, dev in local]
        if isinstance(mesh, ProcessMesh):
            _ring_ranks(x_shards[0], mesh, step)
        elif mesh.devices[0].type == "cuda":
            _ring_cuda(x_shards, mesh, step)
        else:
            nxt = [torch.empty_like(s) for s in x_shards]
            for t in range(D):
                if t < D - 1:
                    for p in range(D):
                        nxt[(p + 1) % D].copy_(x_shards[p])
                        spmv_sharded_chunked.rotations += 1
                for p in range(D):
                    step(p, t, x_shards[p])
                if t < D - 1:
                    x_shards, nxt = nxt, x_shards
    elif x_mode == "replicated":
        for i, (d, dev) in enumerate(local):
            xd = x.to(dev)
            for t in range(D):
                s = (d - t) % D  # step t of the ring uses shard (d - t) mod D
                step(i, t, xd[s * per:(s + 1) * per])
    else:
        raise ValueError(f"unknown x_mode {x_mode!r}")
    return _gather_y(ys, splan, mesh)


spmv_sharded_chunked.rotations = 0  # x shard copies (sends) of the ring
