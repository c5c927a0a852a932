"""Host-side sparse matrix containers.

Carried over unchanged from ``hispmv_tpu/formats/matrix.py`` (numpy and the standard library
only), so that both packages build identical plans.  Original notes follow.

TPU-native analog of the reference's ``COOMatrix_t`` / ``CSRMatrix_t``
(reference common/include/spmv-helper.h:33-60).  The reference additionally
defines a 64-bit packed nnz encoding for its FPGA streams; our equivalent
"encoding" is the planner's packed lane-stream arrays (hispmv_tpu/plan)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class COOMatrix:
    """Coordinate-format sparse matrix (fp32 values, int32 indices)."""

    shape: tuple  # (rows, cols)
    rows: np.ndarray  # int32 [nnz]
    cols: np.ndarray  # int32 [nnz]
    values: np.ndarray  # float32 [nnz]

    def __post_init__(self):
        self.rows = np.ascontiguousarray(self.rows, dtype=np.int32)
        self.cols = np.ascontiguousarray(self.cols, dtype=np.int32)
        self.values = np.ascontiguousarray(self.values, dtype=np.float32)
        if not (len(self.rows) == len(self.cols) == len(self.values)):
            raise ValueError("rows/cols/values length mismatch")

    @property
    def nnz(self) -> int:
        return int(len(self.values))

    @property
    def num_rows(self) -> int:
        return int(self.shape[0])

    @property
    def num_cols(self) -> int:
        return int(self.shape[1])

    def row_lengths(self) -> np.ndarray:
        """nnz count per row (int64 [num_rows])."""
        return np.bincount(self.rows, minlength=self.num_rows).astype(np.int64)

    def sorted_by_row(self) -> "COOMatrix":
        """Stable sort entries by (row, col)."""
        order = np.lexsort((self.cols, self.rows))
        return COOMatrix(
            self.shape, self.rows[order], self.cols[order], self.values[order]
        )

    def to_dense(self) -> np.ndarray:
        dense = np.zeros(self.shape, dtype=np.float32)
        # np.add.at handles duplicate coordinates by accumulation, matching
        # the semantics of every downstream compute path.
        np.add.at(dense, (self.rows, self.cols), self.values)
        return dense

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.coo_matrix(
            (self.values, (self.rows, self.cols)), shape=self.shape
        )

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Golden single-threaded y = A @ x, the ``cpuSequential`` analog
        (reference common/src/spmv-helper.cpp:812-833)."""
        y = np.zeros(self.num_rows, dtype=np.float64)
        np.add.at(y, self.rows, self.values.astype(np.float64) * x[self.cols])
        return y.astype(np.float32)


def coo_from_dense(dense: np.ndarray) -> COOMatrix:
    dense = np.asarray(dense, dtype=np.float32)
    rows, cols = np.nonzero(dense)
    return COOMatrix(dense.shape, rows, cols, dense[rows, cols])


def coo_from_scipy(mat) -> COOMatrix:
    coo = mat.tocoo()
    return COOMatrix(coo.shape, coo.row, coo.col, coo.data)
