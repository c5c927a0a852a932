"""The plain reference of the benchmark, and the number that decides
``correct``.

``A @ x`` in float64 from the generated COO (sorted by row, no duplicates)
as a PyTorch CSR product, and a lower-precision stand-in of the program
(values and vectors rounded to bfloat16, float32 accumulation) that serves
as the control of a format that has no low-precision path of its own.
This module imports nothing of the program.
"""

from __future__ import annotations

import warnings

import torch


class CsrReference:
    """``A`` as CSR on ``device`` in ``dtype``, from sorted unique COO."""

    def __init__(self, shape, rows, cols, values, device,
                 dtype=torch.float64):
        self.shape = (int(shape[0]), int(shape[1]))
        rows = torch.as_tensor(rows, device=device).long()
        cols = torch.as_tensor(cols, device=device).long()
        values = torch.as_tensor(values, device=device)
        counts = torch.bincount(rows, minlength=self.shape[0])
        crow = torch.zeros(self.shape[0] + 1, dtype=torch.int64,
                           device=device)
        crow[1:] = torch.cumsum(counts, 0)
        self.dtype = dtype
        values = values.to(dtype)
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            self.a = torch.sparse_csr_tensor(crow, cols, values,
                                             size=self.shape,
                                             check_invariants=False)
            self.abs_a = torch.sparse_csr_tensor(crow, cols, values.abs(),
                                                 size=self.shape,
                                                 check_invariants=False)

    def matmat(self, x: torch.Tensor, absolute: bool = False):
        """``A @ x.T`` for ``x`` [B, C] (or ``A @ x`` for [C]), in the
        reference's dtype: [B, R] (or [R])."""
        a = self.abs_a if absolute else self.a
        xx = x.to(self.dtype)
        if absolute:
            xx = xx.abs()
        if xx.ndim == 1:
            return (a @ xx[:, None])[:, 0]
        return (a @ xx.T).T


class Bf16Stand:
    """The control in the program's place: ``run`` and ``linear`` of
    the handle's signature, with the values and each vector rounded to
    bfloat16 and the products summed in float32."""

    def __init__(self, shape, rows, cols, values, device):
        v = torch.as_tensor(values, device=device).to(torch.bfloat16)
        self.ref = CsrReference(shape, rows, cols, v.float(), device,
                                dtype=torch.float32)

    def _rounded(self, x):
        return x.to(torch.bfloat16).float()

    def run(self, x, y_in=None, alpha=1.0, beta=0.0):
        y = alpha * self.ref.matmat(self._rounded(x))
        if y_in is None:
            return y
        return y + beta * self._rounded(y_in)

    def linear(self, x_batch, bias=None):
        y = self.ref.matmat(self._rounded(x_batch))
        return y if bias is None else y + bias


def rel_errors(ref: CsrReference, x, y, y_in=None, alpha=1.0, beta=0.0):
    """The gaps of ``y`` (the program's ``alpha * A @ x + beta * y_in``,
    one vector or a batch) from the float64 reference, each over the row
    scale ``s = |alpha| |A| |x| + |beta| |y_in|`` of the same vector, the
    worst vector of a batch:

    - ``norm_rel_err``: the widest gap over the largest ``s``.  Normwise,
      since a kernel that takes each row as the difference of two prefix
      sums errs by the prefix, not by the row;
    - ``l1_rel_err``: the summed gaps over the summed ``s``, which weighs
      the bulk of the rows: where a few rows hold most of the scale (a
      PageRank's restart, its hubs), a fault confined to the many small
      rows moves it and not the widest gap.

    Non-finite answers, and a gap where the scale is 0, read ``inf``."""
    want = alpha * ref.matmat(x)
    scale = abs(alpha) * ref.matmat(x, absolute=True)
    if y_in is not None and beta != 0.0:
        want = want + beta * y_in.to(ref.dtype)
        scale = scale + abs(beta) * y_in.to(ref.dtype).abs()
    gap = (y.to(ref.dtype) - want).abs()
    inf = {"norm_rel_err": float("inf"), "l1_rel_err": float("inf")}
    if not bool(torch.isfinite(gap).all()):
        return inf
    if gap.ndim == 1:
        gap, scale = gap[None], scale[None]
    top_gap, top_scale = gap.max(dim=1).values, scale.max(dim=1).values
    if bool(((top_scale == 0) & (top_gap > 0)).any()):
        return inf
    sum_gap, sum_scale = gap.sum(dim=1), scale.sum(dim=1)
    return {
        "norm_rel_err": float((top_gap / top_scale.clamp_min(1e-300)).max()),
        "l1_rel_err": float((sum_gap / sum_scale.clamp_min(1e-300)).max()),
    }
