"""Operations, bytes and the chip's peaks, for roofline shares.

A call's bytes are what its inputs need, whatever format implements them:
8 B a nonzero (a float32 value and an int32 column), a 4 B row pointer a
row, and each vector read or written once (x, y, and y_in only where
``beta`` is not 0), B times for a batch of B.  Its operations are the
repo's own count, 2 (nnz + rows) a vector.
"""

from __future__ import annotations

# Published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W): HBM3
# bandwidth and float32 outside the tensor cores.
PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12},
}


def peaks_for(device_name: str):
    """The peaks of the card named ``device_name``, or None."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None


def call_flops(rows: int, nnz: int, batch: int = 1) -> float:
    return 2.0 * batch * (nnz + rows)


def call_bytes(rows: int, cols: int, nnz: int, batch: int = 1,
               y_in: bool = False) -> float:
    vectors = cols + rows + (rows if y_in else 0)
    return 8.0 * nnz + 4.0 * rows + 4.0 * batch * vectors


def least_seconds(peaks, rows, cols, nnz, batch=1, y_in=False) -> float:
    """The larger of bytes over bandwidth and operations over the float32
    rate: the least time the chip could take for one call."""
    return max(call_bytes(rows, cols, nnz, batch, y_in)
               / peaks["hbm_bytes_per_s"],
               call_flops(rows, nnz, batch) / peaks["fp32_flops_per_s"])
