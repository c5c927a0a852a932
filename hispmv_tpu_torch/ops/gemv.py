"""Dense overlay: GeMV and batched GeMM in full fp32.

Port of ``hispmv_tpu/ops/gemv.py``.  The JAX version asks for
``Precision.HIGHEST`` on every dot, because anything less misses the
reference's rtol=1e-3 fp32 acceptance.  The counterpart here is a float32
matmul with TF32 off: :func:`full_fp32` turns it off for the duration of a
call and restores the caller's setting afterwards.  A large dense product
is left to ``torch.matmul``, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """Run float32 matmuls (and einsums lowered to them) without TF32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gemv(a, x, y_in=None, alpha=1.0, beta=0.0):
    """y = alpha * A @ x + beta * y_in; batched when x is 2-D:
    [B, C] -> [B, R] as ``x @ A.T`` (the ``linear()`` form)."""
    with full_fp32():
        y = torch.mv(a, x) if x.ndim == 1 else x @ a.T
    y = alpha * y
    if y_in is not None:
        y = y + beta * y_in
    return y
