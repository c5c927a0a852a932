"""Plain PyTorch SpMV over a :class:`StreamPlan` — the stream format.

Port of ``hispmv_tpu/ops/spmv_ref.py`` (``spmv_xla``, ``finalize_xla``):
gather x, multiply, per-round segment sums (``index_add_``, the
``segment_sum`` counterpart), then a scatter-add of the per-(round, pe)
partials to rows and the axpby epilogue.  A batch of vectors is a leading
dimension written out (the JAX package maps the single-vector form over
the batch with ``vmap``).  No kernel of its own.
"""

from __future__ import annotations

import torch


def spmv_ref(vals, cols, round_ids, seg_rows, num_rounds, num_rows, x,
             y_in=None, alpha=1.0, beta=0.0):
    """``vals`` f32 [T, P], ``cols`` i32 [T, P], ``round_ids`` i32 [T]
    (non-decreasing), ``seg_rows`` i32 [E*P], ``x`` f32 [C] -> y f32 [R],
    or ``x`` [B, C] -> y [B, R]."""
    prod = vals * x[..., cols]  # [..., T, P]
    acc = torch.zeros(
        x.shape[:-1] + (num_rounds, vals.shape[1]), dtype=prod.dtype,
        device=prod.device,
    ).index_add_(x.ndim - 1, round_ids, prod)  # [..., E, P]
    return finalize_ref(acc, seg_rows, num_rows, y_in, alpha, beta)


def finalize_ref(acc, seg_rows, num_rows, y_in, alpha, beta):
    """Recombine split-row partials into y (padding lands on the dummy row
    ``num_rows``) and apply the axpby epilogue; ``acc`` [..., E, P]."""
    lead = acc.shape[:-2]
    y = torch.zeros(lead + (num_rows + 1,), dtype=acc.dtype,
                    device=acc.device)
    y = y.index_add_(len(lead), seg_rows,
                     acc.reshape(lead + (-1,)))[..., :num_rows]
    y = alpha * y
    if y_in is not None:
        y = y + beta * y_in
    return y
