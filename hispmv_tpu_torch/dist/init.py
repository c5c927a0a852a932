"""Multi-process initialization helper.

Port of ``hispmv_tpu/dist/init.py`` onto ``torch.distributed``: it wraps
``init_process_group`` with the environment the common launchers set
(torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
``RANK``), is safe to call in single-process runs (no-op) and repeatedly
(idempotent), and uses NCCL when there is a card, gloo otherwise.

Usage at the top of a multi-process program::

    from hispmv_tpu_torch.dist import init_distributed
    init_distributed()                                  # torchrun's variables
    init_distributed("tcp://host0:29500", 4, 0)         # explicit address

The sharded executors of ``dist/shard.py`` are single-process (one program
over a list of devices) and need none of this.
"""

from __future__ import annotations

import os
from typing import Optional


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> bool:
    """Initialize ``torch.distributed`` when running multi-process.

    Returns True when a process group of more than one process is active
    (after this call), False for plain single-process runs.  Arguments fall
    back to torchrun's environment: ``tcp://$MASTER_ADDR:$MASTER_PORT``,
    ``$WORLD_SIZE`` and ``$RANK``.  When an address is given, by the caller
    or the environment, a failure to join raises."""
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
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dist.get_world_size() > 1
