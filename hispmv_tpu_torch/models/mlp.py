"""NN model layer: sparse linear layers and the demo model, in torch.nn.

Port of ``hispmv_tpu/models/mlp.py``:

- :class:`SparseLinear`: a linear layer whose weight is masked to a target
  density by a mask drawn once at construction (a buffer, so it stays fixed
  under training).
- :class:`ThreeLayerFCModel`: dense -> ReLU -> sparse -> ReLU -> sparse.
  Its forward is fp32 matmuls with TF32 off.
- :func:`extract_linears` / :class:`AcceleratedModel`: pull the layer
  weights out of a module and run them through prepared ``SpmvHandle``
  objects (the layer swap is in ``models/manager.py``).
- :func:`load_flax_variables`: copy the JAX package's ``model.init`` tree
  (numpy leaves) into the port's model, so both compute the same function.
- :func:`compare_model_outputs`: whole-model error statistics.

Weights are drawn from an explicit ``torch.Generator`` on the device that
holds them, in the shape of flax's init: ``lecun_normal`` (a normal limited
to two standard deviations, here folded by ``fmod`` where flax truncates,
scaled to variance 1/fan_in) and zero biases.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from hispmv_tpu_torch.ops.gemv import full_fp32
from hispmv_tpu_torch.utils.errors import ErrorStats, error_stats

# std of a unit normal truncated to [-2, 2]: lecun_normal divides by it
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, generator) -> torch.Tensor:
    """flax's ``lecun_normal`` for a [out, in] weight: a standard normal
    folded into (-2, 2) by ``fmod``, scaled to variance 1/in."""
    w = torch.randn(weight.shape, generator=generator, device=weight.device)
    std = (1.0 / weight.shape[1]) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        weight.copy_(torch.fmod(w, 2.0) * std)
    return weight


class SparseLinear(nn.Module):
    """Linear layer with a random sparsity mask on its weight.

    ``density`` is the fraction of nonzero weights.  ``weight`` is
    [out, in] (torch's convention); ``mask`` is a float32 0/1 buffer of the
    same shape, drawn once from ``generator``."""

    def __init__(self, in_features: int, out_features: int,
                 density: float = 0.1, bias: bool = True, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.density = density
        self.weight = nn.Parameter(
            torch.empty((out_features, in_features), device=device))
        _lecun_normal_(self.weight, generator)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)
        mask = torch.rand((out_features, in_features), generator=generator,
                          device=device) < density
        self.register_buffer("mask", mask.float())

    def masked_weight(self) -> torch.Tensor:
        return self.weight * self.mask

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with full_fp32():
            return nn.functional.linear(x, self.masked_weight(), self.bias)


class ThreeLayerFCModel(nn.Module):
    """fc1 dense -> ReLU -> fc2 sparse -> ReLU -> fc3 sparse."""

    def __init__(self, in_features: int, hidden: int = 1024, out: int = 64,
                 density: float = 0.1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden, device=device)
        _lecun_normal_(self.fc1.weight, generator)
        nn.init.zeros_(self.fc1.bias)
        self.fc2 = SparseLinear(hidden, hidden, density,
                                generator=generator, device=device)
        self.fc3 = SparseLinear(hidden, out, density, generator=generator,
                                device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with full_fp32():
            x = torch.relu(self.fc1(x))
            x = torch.relu(self.fc2(x))
            return self.fc3(x)


def extract_linears(
    model: nn.Module,
) -> List[Tuple[str, np.ndarray, Optional[np.ndarray]]]:
    """``(name, W[out, in], bias)`` as float32 numpy for every
    ``nn.Linear`` / :class:`SparseLinear` of ``model``, masks applied, in
    registration order (the JAX package's order for the demo model)."""
    out = []
    for name, mod in model.named_modules():
        if isinstance(mod, SparseLinear):
            w = mod.masked_weight()
        elif isinstance(mod, nn.Linear):
            w = mod.weight
        else:
            continue
        bias = None
        if mod.bias is not None:
            bias = mod.bias.detach().float().cpu().numpy()
        out.append((name, w.detach().float().cpu().numpy(), bias))
    return out


# the flax names of ThreeLayerFCModel's layers (nn.compact numbering)
_FLAX_LAYERS = {"fc1": "Dense_0", "fc2": "SparseLinear_0",
                "fc3": "SparseLinear_1"}


def load_flax_variables(model: ThreeLayerFCModel, variables) -> None:
    """Copy the JAX package's ``ThreeLayerFCModel.init`` tree into
    ``model``: ``params/<layer>/kernel`` [in, out] (transposed to
    [out, in]), ``params/<layer>/bias`` and ``constants/<layer>/mask``
    [in, out].  Leaves may be numpy or anything ``np.asarray`` takes."""
    params = variables["params"]
    constants = variables.get("constants", {})
    with torch.no_grad():
        for attr, flax_name in _FLAX_LAYERS.items():
            mod = getattr(model, attr)
            p = params[flax_name]
            kernel = np.array(p["kernel"], np.float32).T
            if tuple(kernel.shape) != tuple(mod.weight.shape):
                raise ValueError(f"{flax_name}: kernel of shape "
                                 f"{kernel.shape[::-1]} for {attr} of "
                                 f"weight shape {tuple(mod.weight.shape)}")
            mod.weight.copy_(torch.tensor(kernel))
            mod.bias.copy_(torch.tensor(np.array(p["bias"], np.float32)))
            if isinstance(mod, SparseLinear):
                mask = np.array(constants[flax_name]["mask"], np.float32)
                mod.mask.copy_(torch.tensor(mask.T))


class AcceleratedModel:
    """Eager layer-by-layer executor backed by prepared handles: each
    layer's forward is ``handle.linear(y, bias)``, followed by its
    activation (``None`` = identity)."""

    def __init__(
        self,
        layers: Sequence[Tuple[object, Optional[np.ndarray]]],
        activations: Sequence[Optional[Callable]],
    ):
        if len(layers) != len(activations):
            raise ValueError(f"{len(layers)} layers but {len(activations)} "
                             "activations")
        # biases are uploaded once, beside their handles
        self.layers = [
            (h, None if b is None else torch.as_tensor(
                b, dtype=torch.float32, device=h.device))
            for h, b in layers
        ]
        self.activations = list(activations)

    def __call__(self, x_batch) -> torch.Tensor:
        y = x_batch
        for (handle, bias), act in zip(self.layers, self.activations):
            y = handle.linear(y, bias)
            if act is not None:
                y = act(y)
        return y


def compare_model_outputs(got, want, rtol: float = 1e-3,
                          atol: float = 1e-4) -> ErrorStats:
    """Whole-model output comparison (tensors or arrays)."""
    def host(a):
        if isinstance(a, torch.Tensor):
            return a.detach().float().cpu().numpy()
        return np.asarray(a)

    return error_stats(host(got), host(want), rtol=rtol, atol=atol)
