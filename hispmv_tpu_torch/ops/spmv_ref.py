"""Plain PyTorch SpMV over a :class:`StreamPlan` — the stream format.

Port of ``hispmv_tpu/ops/spmv_ref.py`` (``spmv_xla``, ``finalize_xla``):
gather x, multiply, per-round segment sums (``index_add_``, the
``segment_sum`` counterpart), then a scatter-add of the per-(round, pe)
partials to rows and the axpby epilogue.  No kernel of its own.
"""

from __future__ import annotations

import torch


def spmv_ref(vals, cols, round_ids, seg_rows, num_rounds, num_rows, x,
             y_in=None, alpha=1.0, beta=0.0):
    """``vals`` f32 [T, P], ``cols`` i32 [T, P], ``round_ids`` i32 [T]
    (non-decreasing), ``seg_rows`` i32 [E*P], ``x`` f32 [C] -> y f32 [R]."""
    prod = vals * x[cols]  # [T, P]
    acc = torch.zeros(
        (num_rounds, vals.shape[1]), dtype=prod.dtype, device=prod.device
    ).index_add_(0, round_ids, prod)  # [E, P]
    return finalize_ref(acc, seg_rows, num_rows, y_in, alpha, beta)


def finalize_ref(acc, seg_rows, num_rows, y_in, alpha, beta):
    """Recombine split-row partials into y (padding lands on the dummy row
    ``num_rows``) and apply the axpby epilogue."""
    y = torch.zeros(num_rows + 1, dtype=acc.dtype, device=acc.device)
    y = y.index_add_(0, seg_rows, acc.reshape(-1))[:num_rows]
    y = alpha * y
    if y_in is not None:
        y = y + beta * y_in
    return y
