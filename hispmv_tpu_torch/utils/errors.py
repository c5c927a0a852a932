"""Relative-error reporting.

Carried over unchanged from ``hispmv_tpu/utils/errors.py`` (numpy and the standard library
only), so that both packages build identical plans.  Original notes follow.

Analog of the reference's ``printErrorStats`` (common/src/spmv-helper.cpp:
835-895): compute elementwise relative error vs a golden result; if there are
few mismatches list them, otherwise print a 10-bin histogram of the error
distribution.  Acceptance threshold matches the reference's Python tests:
``np.allclose(rtol=1e-3)`` (apps/general_test.py:104-116).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ErrorStats:
    num_elements: int
    num_mismatches: int
    max_rel_error: float
    max_abs_error: float
    mismatch_indices: np.ndarray  # first <=10 mismatching indices
    hist_counts: np.ndarray  # 10-bin histogram of rel error (log bins)
    hist_edges: np.ndarray
    rtol: float
    atol: float

    @property
    def ok(self) -> bool:
        return self.num_mismatches == 0


def error_stats(
    got: np.ndarray,
    want: np.ndarray,
    rtol: float = 1e-3,
    atol: float = 1e-5,
) -> ErrorStats:
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    if got.shape != want.shape:
        raise ValueError(f"shape mismatch: {got.shape} vs {want.shape}")
    abs_err = np.abs(got - want)
    denom = np.maximum(np.abs(want), 1e-30)
    rel_err = abs_err / denom
    bad = abs_err > (atol + rtol * np.abs(want))
    idx = np.nonzero(bad)[0][:10]
    # Log-spaced histogram of relative error over all elements.
    safe = np.maximum(rel_err, 1e-16)
    edges = np.logspace(-16, 1, 11)
    counts, _ = np.histogram(safe, bins=edges)
    return ErrorStats(
        num_elements=int(got.size),
        num_mismatches=int(bad.sum()),
        max_rel_error=float(rel_err.max(initial=0.0)),
        max_abs_error=float(abs_err.max(initial=0.0)),
        mismatch_indices=idx,
        hist_counts=counts,
        hist_edges=edges,
        rtol=rtol,
        atol=atol,
    )


def print_error_stats(stats: ErrorStats, name: str = "result") -> None:
    if stats.ok:
        print(
            f"[{name}] PASS: {stats.num_elements} elements, "
            f"max rel err {stats.max_rel_error:.2e} "
            f"(rtol={stats.rtol}, atol={stats.atol})"
        )
        return
    print(
        f"[{name}] FAIL: {stats.num_mismatches}/{stats.num_elements} "
        f"mismatches, max rel err {stats.max_rel_error:.2e}"
    )
    if stats.num_mismatches <= 10:
        print(f"  mismatch indices: {stats.mismatch_indices.tolist()}")
    else:
        print("  relative-error histogram:")
        for lo, hi, n in zip(
            stats.hist_edges[:-1], stats.hist_edges[1:], stats.hist_counts
        ):
            if n:
                print(f"    [{lo:.0e}, {hi:.0e}): {n}")
