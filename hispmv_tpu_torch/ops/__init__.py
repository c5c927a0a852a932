"""The port's operators; the same public names as ``hispmv_tpu.ops``
under the port's names.  Importing builds no kernel (``cuda_build`` does
that at the first launch)."""

from hispmv_tpu_torch.ops.gemv import gemv  # noqa: F401
from hispmv_tpu_torch.ops.spmv_block import (  # noqa: F401
    spmv_block,
    spmv_block_batched,
    spmv_block_stream,
)
from hispmv_tpu_torch.ops.spmv_ref import finalize_ref, spmv_ref  # noqa: F401
