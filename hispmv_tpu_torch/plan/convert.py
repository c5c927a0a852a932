"""Carry a plan prepared by the JAX package over to the port.

:func:`plan_from_reference` reads a ``hispmv_tpu`` plan object
(``BlockPlan``, ``WindowPlan``, ``EllxPlan``, ``StreamPlan``,
``RoutedPlan`` or ``BandedRoutedPlan``) field by field, duck-typed, and returns the port's plan of the same kind.  With
``SpmvHandle.from_plan`` both packages then run the same prepared matrix.
Nothing here imports ``hispmv_tpu``: the object only has to carry the
fields by name.
"""

from __future__ import annotations

import dataclasses

from hispmv_tpu_torch.config import SpmvConfig
from hispmv_tpu_torch.ops.spmv_ellx import EllxPlan
from hispmv_tpu_torch.plan.blocks import BlockPlan
from hispmv_tpu_torch.plan.partition import StreamPlan
from hispmv_tpu_torch.plan.routed import (
    BandedRoutedPlan,
    RoutedCell,
    RoutedPlan,
    RoutedStream,
)
from hispmv_tpu_torch.plan.windows import WindowPlan


def _copy(cls, obj, **override):
    return cls(**{
        f.name: override[f.name] if f.name in override
        else getattr(obj, f.name)
        for f in dataclasses.fields(cls)
    })


def _routed(obj):
    if obj.gathered is not None:
        raise NotImplementedError(
            "the plan carries a gathered side-plan, which is not ported "
            "(ROADMAP.md queue A item 9)")
    streams = {f"s{i}": None if getattr(obj, f"s{i}") is None
               else _copy(RoutedStream, getattr(obj, f"s{i}"))
               for i in range(RoutedPlan.MAX_STREAMS)}
    return _copy(RoutedPlan, obj, **streams)


def plan_from_reference(obj):
    """The port's plan holding the same arrays as ``obj``."""
    if hasattr(obj, "cells"):
        return _copy(BandedRoutedPlan, obj, cells=[
            _copy(RoutedCell, c, plan=_routed(c.plan)) for c in obj.cells
        ])
    if hasattr(obj, "num_ytiles"):
        return _routed(obj)
    if hasattr(obj, "k_base"):
        overflow = obj.overflow
        return _copy(
            EllxPlan, obj,
            overflow=None if overflow is None else _copy(BlockPlan, overflow),
        )
    if hasattr(obj, "block_wins"):
        return _copy(WindowPlan, obj)
    if hasattr(obj, "block_cols"):
        return _copy(BlockPlan, obj)
    if hasattr(obj, "round_starts"):
        return _copy(StreamPlan, obj, config=_copy(SpmvConfig, obj.config))
    raise TypeError(
        f"no port of plan type {type(obj).__name__} (block, window, ellx, "
        "stream and routed plans are ported)"
    )
