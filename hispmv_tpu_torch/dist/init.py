"""Multi-process initialization helpers.

Port of ``hispmv_tpu/dist/init.py`` onto ``torch.distributed``: it wraps
``init_process_group`` with the environment the common launchers set
(torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
``RANK``), is safe to call in single-process runs (no-op) and repeatedly
(idempotent), and uses NCCL when there is a card, gloo otherwise.

Usage at the top of a multi-process program, one process a card::

    from hispmv_tpu_torch.dist import (init_distributed, make_process_mesh,
                                       spmv_sharded)
    init_distributed()                                  # torchrun's variables
    init_distributed("tcp://host0:29500", 4, 0)         # explicit address
    mesh = make_process_mesh()          # this rank on cuda:$LOCAL_RANK
    y = spmv_sharded(plan, x, mesh, x_mode="gather")    # full y on each rank

then the sharded executors of ``dist/shard.py`` run over every process's
device, as the JAX package's run over a mesh that spans processes.  A
``Mesh`` of devices in one process needs none of this.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Initialize ``torch.distributed`` when running multi-process.

    Returns True when a process group of more than one process is active
    (after this call), False for plain single-process runs.  Arguments fall
    back to torchrun's environment: ``tcp://$MASTER_ADDR:$MASTER_PORT``,
    ``$WORLD_SIZE`` and ``$RANK``.  When an address is given, by the caller
    or the environment, a failure to join raises.  ``backend`` defaults to
    NCCL when there is a card and gloo otherwise (the backend of a process
    mesh on the CPU).  A rank that waits ``timeout`` on a peer in any
    collective of the group raises instead of hanging."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if init_method is None:
        return False  # single-process: nothing to initialize
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    return dist.get_world_size() > 1


def local_device(device=None):
    """This process's device: ``cuda:$LOCAL_RANK`` (torchrun's variable, 0
    when unset), made the current card, unless the caller names a device.
    Goes through ``resolve_device``, so a card named without one raises;
    ``"cpu"`` is returned as it is."""
    import torch

    from hispmv_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    return dev
