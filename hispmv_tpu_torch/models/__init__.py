"""The model layer: sparse linear layers, the demo MLP and the layer swap
onto an ``Accelerator`` (port of ``hispmv_tpu/models``)."""

from hispmv_tpu_torch.models.mlp import (  # noqa: F401
    AcceleratedModel,
    SparseLinear,
    ThreeLayerFCModel,
    compare_model_outputs,
    extract_linears,
    load_flax_variables,
)
from hispmv_tpu_torch.models.manager import (  # noqa: F401
    AcceleratorLayerManager,
)
