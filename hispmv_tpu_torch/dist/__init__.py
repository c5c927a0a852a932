from hispmv_tpu_torch.dist.init import (  # noqa: F401
    init_distributed,
    local_device,
)
from hispmv_tpu_torch.dist.shard import (  # noqa: F401
    Mesh,
    ProcessMesh,
    ShardedBlockPlan,
    ShardedChunkedPlan,
    ShardedWindowPlan,
    build_sharded_block_plan,
    build_sharded_chunked_plan,
    build_sharded_window_plan,
    make_mesh,
    make_process_mesh,
    spmv_sharded,
    spmv_sharded_chunked,
    spmv_sharded_window,
    to_device,
)
