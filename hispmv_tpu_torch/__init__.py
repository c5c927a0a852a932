"""hispmv_tpu_torch — the sparse/dense matrix-vector framework on PyTorch
and CUDA (NVIDIA Hopper).

Port of ``hispmv_tpu`` (JAX/XLA/Pallas on a TPU), which stays beside it as
the reference.  The layout mirrors the JAX package module for module:

- ``formats`` — COO container, MatrixMarket IO (the body parsed by the
                native parser, the numpy branch beside it), synthetic
                suite and ``fetch_suite`` for the reference's 20 SuiteSparse
                matrices;
- ``plan``    — block-ELL, windowed and lane-stream planners (numpy, plans
                identical to the JAX package's; the block packer in C++),
                ``serialize`` (``save_plan`` / ``load_plan``: every plan
                type to and from ``.npz``, in the JAX package's file
                layout, so either package loads the other's files) and
                ``convert`` for plans prepared by the JAX package;
- ``native``  — the C++ routines of the prepare path (MatrixMarket body
                parser, block packer, the routed and permutation
                planners' loops), built with ``g++`` at first use;
- ``ops``     — the thirteen kernels hand-written in CUDA C++ under
                ``csrc/``, each with a plain PyTorch version beside it:
                the block streams B1-B4 (``spmv_chunked``: one vector, a
                batch, x-paneled, x- and y-paneled), B5 and B6
                (``spmv_block``), the windowed streams B7 and B8
                (``spmv_windowed``), the routed streams B9 and B10
                (``spmv_routed``), the window permutation B11
                (``permute``) and the gathered side-plan's B12 and B13
                (``spmv_gathered``); plus ELLX, the stream reference and
                dense GeMV in plain PyTorch;
- ``api``     — ``SpmvHandle`` / ``prepare`` / ``Accelerator``, with
                ``run`` and the batched ``linear``, in every format of the
                JAX package (``split`` included);
- ``tune``    — the cost-model tuner (``tune``, ``DSE``): the JAX
                package's model under the device's profile, and measured
                tuning that times the shortlist on the card; reachable as
                ``hispmv_tpu_torch.tune``;
- ``profiles``— ``DeviceProfile``: every number that steers a choice
                (``V5E``, the JAX package's values, on the CPU; ``H100``,
                measured on the card, on a CUDA device:
                ``device_profile``);
- ``dist``    — row-sharded plans and the three sharded executors (B5,
                B7, B3 with the x ring) over a ``Mesh`` of devices in one
                process or a ``ProcessMesh`` of ranks under
                ``torch.distributed`` (``make_process_mesh``,
                ``local_device``; ``python -m hispmv_tpu_torch.dist.dryrun``
                under torchrun);
- ``models``  — ``SparseLinear``, ``ThreeLayerFCModel`` (torch.nn), the
                layer swap onto an ``Accelerator`` and the demo CLI;
- ``utils``   — error statistics, CUDA-event timing (``timing``), the
                metrics CSV (``metrics``) and ``trace`` (``Tracer``,
                ``profile_trace`` around ``torch.profiler``, and
                ``PowerMonitor`` reading the card's power by
                ``nvidia-smi``);
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
from hispmv_tpu_torch.dist import (  # noqa: F401
    ProcessMesh,
    local_device,
    make_process_mesh,
)
from hispmv_tpu_torch.formats.matrix import COOMatrix  # noqa: F401


def __getattr__(name):
    # the tuner is loaded at first use, as in the JAX package
    if name == "tune":
        from hispmv_tpu_torch.tune import tune as _tune

        return _tune
    raise AttributeError(name)
