"""hispmv_tpu_torch — the sparse/dense matrix-vector framework on PyTorch
and CUDA (NVIDIA Hopper).

Port of ``hispmv_tpu`` (JAX/XLA/Pallas on a TPU), which stays beside it as
the reference.  The layout mirrors the JAX package module for module:

- ``formats`` — COO container, MatrixMarket IO (numpy), synthetic suite;
- ``plan``    — block-ELL, windowed and lane-stream planners (numpy, plans
                identical to the JAX package's) and ``convert`` for plans
                prepared by the JAX package;
- ``ops``     — the kernels hand-written in CUDA C++ under ``csrc/``, each
                with a plain PyTorch version beside it: the block streams
                B1 and B2 (``spmv_chunked``, one vector and a batch), the
                windowed streams B7 and B8 (``spmv_windowed``), the routed
                streams B9 and B10 (``spmv_routed``) and the window
                permutation B11 (``permute``); plus ELLX, the stream
                reference and dense GeMV in plain PyTorch;
- ``api``     — ``SpmvHandle`` / ``prepare`` / ``Accelerator``, with
                ``run`` and the batched ``linear``, in every format of the
                JAX package (``split`` included);
- ``tune``    — the cost-model tuner (``tune``, ``DSE``): the JAX
                package's model with its TPU v5e profile kept as the
                default, so the model-only pick equals the JAX tuner's,
                and measured tuning that times the shortlist on the card;
                reachable as ``hispmv_tpu_torch.tune``;
- ``models``  — ``SparseLinear``, ``ThreeLayerFCModel`` (torch.nn), the
                layer swap onto an ``Accelerator`` and the demo CLI;
- ``utils``   — error statistics, CUDA-event timing (``timing``) and the
                metrics CSV (``metrics``);
- ``cli``     — ``python -m hispmv_tpu_torch MATRIX | ROWS COLS |
                @suite[:scale] [--format tune --measure N] [--device cpu]``.

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


def __getattr__(name):
    # the tuner is loaded at first use, as in the JAX package
    if name == "tune":
        from hispmv_tpu_torch.tune import tune as _tune

        return _tune
    raise AttributeError(name)
