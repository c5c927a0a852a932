from hispmv_tpu_torch.dist.init import init_distributed  # noqa: F401
from hispmv_tpu_torch.dist.shard import (  # noqa: F401
    Mesh,
    ShardedBlockPlan,
    ShardedChunkedPlan,
    ShardedWindowPlan,
    build_sharded_block_plan,
    build_sharded_chunked_plan,
    build_sharded_window_plan,
    make_mesh,
    spmv_sharded,
    spmv_sharded_chunked,
    spmv_sharded_window,
    to_device,
)
