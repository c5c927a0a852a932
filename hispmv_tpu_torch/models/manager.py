"""Layer manager: swap a model's linear layers onto the accelerator.

Port of ``hispmv_tpu/models/manager.py``: each layer's weight becomes a
dense handle above ``density_threshold`` and a sparse handle (format
``auto``) below it, and the result is an :class:`AcceleratedModel` that
runs every layer through ``SpmvHandle.linear`` on the accelerator's
device.  The walk is ``extract_linears``' ``named_modules`` walk.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from hispmv_tpu_torch.api.handle import Accelerator
from hispmv_tpu_torch.formats.matrix import coo_from_dense
from hispmv_tpu_torch.models.mlp import AcceleratedModel, extract_linears


class AcceleratorLayerManager:
    """Builds accelerated models on ``accelerator`` (which carries the
    device and the profile; a default ``Accelerator(profile=profile)`` is
    on the card, under ``profile`` or, None, the card's)."""

    def __init__(self, accelerator: Optional[Accelerator] = None,
                 density_threshold: float = 0.5, profile=None):
        self.accel = accelerator or Accelerator(profile=profile)
        self.density_threshold = density_threshold
        self.layer_names: List[str] = []

    def process_weights(self, weight: np.ndarray) -> int:
        """One layer's weight [out, in] -> matrix id on the accelerator.
        Raises MemoryError when the accelerator's budget is exhausted."""
        density = np.count_nonzero(weight) / max(weight.size, 1)
        if density > self.density_threshold:
            mid = self.accel.create_dense_handle(weight)
        else:
            mid = self.accel.create_sparse_handle(coo_from_dense(weight))
        if mid == -1:
            raise MemoryError(
                "accelerator memory budget exhausted while loading layers"
            )
        return mid

    def replace_layers(
        self,
        model: nn.Module,
        activations: Optional[Sequence[Optional[Callable]]] = None,
    ) -> AcceleratedModel:
        """Prepare every linear layer of ``model`` and return the
        accelerated model.  ``activations[i]`` runs after layer i (None =
        identity); the default is ReLU between layers and none at the end,
        as in ThreeLayerFCModel."""
        linears = extract_linears(model)
        if not linears:
            raise ValueError("no linear layers found in the model")
        if activations is None:
            activations = [torch.relu] * (len(linears) - 1) + [None]
        layers = []
        self.layer_names = []
        for name, w, b in linears:
            mid = self.process_weights(w)
            layers.append((self.accel.handle(mid), b))
            self.layer_names.append(name)
        self.accel.load_matrices()
        return AcceleratedModel(layers, activations)
