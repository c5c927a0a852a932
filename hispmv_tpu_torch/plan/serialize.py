"""Plan serialization: keep a prepared plan on disk as ``.npz``.

Preparing a large matrix costs seconds (sort and pack over every nonzero,
the routed planner's colourings); a saved plan reloads into a handle with
``SpmvHandle.from_plan`` without touching the matrix again.  Every plan
type of the port is covered, nested ones included (``EllxPlan`` holds an
overflow ``BlockPlan``, ``SplitPlan`` an ELLX or routed body,
``RoutedPlan`` its streams and gathered side-plan, ``BandedRoutedPlan``
its cells).

The file layout is the JAX package's (``hispmv_tpu/plan/serialize.py``):
the same ``__plan_type__`` names, nested fields flattened under
``prefix..field`` keys, lists of arrays and of plans under ``__alN`` /
``__plN`` keys counted by ``__arraylist__`` / ``__planlist__``, a
``SpmvConfig`` as ``__config__``, ``None`` as ``("__none__",)``, and every
non-array field in one JSON object stored as the uint8 array ``__meta__``.
Both packages' plan dataclasses have the same fields in the same order, so
a file saved by either package loads in the other.

Only the plan is stored: what the handle derives from it at upload (B4's
sector mask, B9's stream tables, the permutation stages of rank space and
of the gathered side-plan) is rebuilt by ``from_plan``.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from hispmv_tpu_torch.config import SpmvConfig
from hispmv_tpu_torch.ops.spmv_ellx import EllxPlan
from hispmv_tpu_torch.plan.blocks import BlockPlan
from hispmv_tpu_torch.plan.gathered import GatheredPlan
from hispmv_tpu_torch.plan.partition import StreamPlan
from hispmv_tpu_torch.plan.routed import (
    BandedRoutedPlan,
    RoutedCell,
    RoutedPlan,
    RoutedStream,
)
from hispmv_tpu_torch.plan.split import SplitPlan
from hispmv_tpu_torch.plan.windows import WindowPlan

_PLAN_TYPES = {
    "block": BlockPlan,
    "window": WindowPlan,
    "stream": StreamPlan,
    "ellx": EllxPlan,
    "split": SplitPlan,
    "routed": RoutedPlan,
    "routedstream": RoutedStream,
    "bandedrouted": BandedRoutedPlan,
    "routedcell": RoutedCell,
    "gathered": GatheredPlan,
}
_SEP = ".."
_NONE = ("__none__",)


def _type_name(plan) -> str:
    for name, cls in _PLAN_TYPES.items():
        if isinstance(plan, cls):
            return name
    raise TypeError(f"unknown plan type: {type(plan)}")


def _json_value(v):
    """``v`` with numpy scalars made Python numbers (recursively through
    tuples, lists and dicts), so that JSON writes them as numbers."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (tuple, list)):
        return [_json_value(a) for a in v]
    if isinstance(v, dict):
        return {k: _json_value(a) for k, a in v.items()}
    return v


def _is_plan(v) -> bool:
    return dataclasses.is_dataclass(v) and not isinstance(v, type)


def _flatten(plan, prefix, fields, meta):
    meta[prefix + "__plan_type__"] = _type_name(plan)
    for f in dataclasses.fields(plan):
        key = prefix + f.name
        v = getattr(plan, f.name)
        if isinstance(v, np.ndarray):
            fields[key] = v
        elif isinstance(v, list) and v and all(
                isinstance(a, np.ndarray) for a in v):
            # rank-space panel permutations: one array each
            meta[key + "__arraylist__"] = len(v)
            for i, a in enumerate(v):
                fields[key + f"__al{i}"] = a
        elif isinstance(v, list) and v and all(_is_plan(a) for a in v):
            # banded routed cells: one sub-tree each
            meta[key + "__planlist__"] = len(v)
            for i, a in enumerate(v):
                _flatten(a, key + f"__pl{i}" + _SEP, fields, meta)
        elif isinstance(v, SpmvConfig):
            meta[key + "__config__"] = _json_value(dataclasses.asdict(v))
        elif _is_plan(v):
            _flatten(v, key + _SEP, fields, meta)
        elif v is None:
            meta[key] = _NONE
        else:
            meta[key] = _json_value(v)


def _unflatten(prefix, z, meta):
    cls = _PLAN_TYPES[meta[prefix + "__plan_type__"]]
    kwargs = {}
    for f in dataclasses.fields(cls):
        key = prefix + f.name
        if key in z.files:
            kwargs[f.name] = z[key]
        elif key + "__arraylist__" in meta:
            kwargs[f.name] = [z[key + f"__al{i}"]
                              for i in range(meta[key + "__arraylist__"])]
        elif key + "__planlist__" in meta:
            kwargs[f.name] = [_unflatten(key + f"__pl{i}" + _SEP, z, meta)
                              for i in range(meta[key + "__planlist__"])]
        elif key + "__config__" in meta:
            kwargs[f.name] = SpmvConfig(**meta[key + "__config__"])
        elif key + _SEP + "__plan_type__" in meta:
            kwargs[f.name] = _unflatten(key + _SEP, z, meta)
        elif key in meta:
            v = meta[key]
            if v == list(_NONE):
                v = None
            elif isinstance(v, list):  # shape, panel_tiles
                v = tuple(v)
            kwargs[f.name] = v
    return cls(**kwargs)


def save_plan(path: str, plan, *, compress: bool = True) -> None:
    """Write ``plan`` (any plan type of the port, nested plans included) to
    ``path`` as ``.npz``.  ``compress=False`` trades disk for time: zlib
    over a plan of a gigabyte costs tens of seconds."""
    fields, meta = {}, {}
    _flatten(plan, "", fields, meta)
    fields["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    (np.savez_compressed if compress else np.savez)(path, **fields)


def load_plan(path: str):
    """The plan saved at ``path`` by :func:`save_plan` (of either
    package)."""
    with np.load(path) as z:
        meta = json.loads(z["__meta__"].tobytes().decode())
        return _unflatten("", z, meta)
