"""hispmv_tpu_torch — the sparse/dense matrix-vector framework on PyTorch
and CUDA (NVIDIA Hopper).

Port of ``hispmv_tpu`` (JAX/XLA/Pallas on a TPU), which stays beside it as
the reference.  The layout mirrors the JAX package module for module:

- ``formats`` — COO container, MatrixMarket IO (numpy), synthetic suite;
- ``plan``    — block-ELL, windowed and lane-stream planners (numpy, plans
                identical to the JAX package's) and ``convert`` for plans
                prepared by the JAX package;
- ``ops``     — the block-stream kernels B1 (``spmv_chunked``) and B7
                (``spmv_windowed``), hand-written in CUDA C++ under
                ``csrc/`` with a plain PyTorch version beside each, plus
                ELLX, the stream reference and dense GeMV in plain PyTorch;
- ``api``     — ``SpmvHandle`` / ``prepare`` / ``Accelerator``;
- ``utils``   — error statistics.

This package imports torch, numpy and the standard library only; it never
imports jax or hispmv_tpu.
"""

from hispmv_tpu_torch.api.handle import (  # noqa: F401
    Accelerator,
    SpmvHandle,
    choose_format,
    prepare,
)
from hispmv_tpu_torch.config import SpmvConfig  # noqa: F401
from hispmv_tpu_torch.formats.matrix import COOMatrix  # noqa: F401
