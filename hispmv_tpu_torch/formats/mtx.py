"""MatrixMarket loader/writer.

Behavioral contract matches the reference loader
(common/src/spmv-helper.cpp:34-136):

- ``coordinate`` format with data type ``real`` | ``integer`` | ``pattern``
  and symmetry ``general`` | ``symmetric`` | ``skew-symmetric``.
- 1-based indices converted to 0-based.
- ``pattern`` entries get value 1.0.
- Explicit zeros are dropped.
- Symmetric / skew-symmetric matrices are expanded: the mirror entry (c, r)
  is added for off-diagonal entries (negated for skew).

Implementation is vectorized numpy rather than a per-line parse loop.  The
C++ fast path of ``hispmv_tpu/native`` is ported later; this is the numpy
branch of ``hispmv_tpu/formats/mtx.py``.
"""

from __future__ import annotations

import io
from typing import Union

import numpy as np

from hispmv_tpu_torch.formats.matrix import COOMatrix

_BANNER = "%%MatrixMarket"
_SUPPORTED_FIELDS = ("real", "integer", "pattern")
_SUPPORTED_SYMMETRY = ("general", "symmetric", "skew-symmetric")


def _parse_header(line: str):
    parts = line.strip().split()
    if len(parts) != 5 or parts[0] != _BANNER or parts[1] != "matrix":
        raise ValueError("Not a valid Matrix Market file")
    fmt, field, symmetry = parts[2].lower(), parts[3].lower(), parts[4].lower()
    if fmt != "coordinate":
        raise ValueError(
            "Only sparse matrices in 'coordinate' format are supported"
        )
    if field not in _SUPPORTED_FIELDS:
        raise ValueError(f"Unsupported data type: {field}")
    if symmetry not in _SUPPORTED_SYMMETRY:
        raise ValueError(
            "Unsupported symmetry type; only 'general', 'symmetric' and "
            "'skew-symmetric' are supported"
        )
    return fmt, field, symmetry


def load_mtx(path_or_file: Union[str, io.IOBase]) -> COOMatrix:
    """Load a MatrixMarket coordinate file into a :class:`COOMatrix`."""
    if isinstance(path_or_file, str):
        with open(path_or_file, "r") as f:
            return load_mtx(f)
    f = path_or_file

    header = f.readline()
    _, field, symmetry = _parse_header(header)

    # Skip comment lines; the first non-comment line carries the sizes.
    line = f.readline()
    while line.startswith("%") or not line.strip():
        line = f.readline()
    rows, cols, nnz = (int(tok) for tok in line.split()[:3])

    body = f.read()
    ncols_file = 2 if field == "pattern" else 3

    data = np.array(body.split(), dtype=np.float64)
    if nnz == 0:
        data = data.reshape(0, ncols_file)
    else:
        if data.size % nnz != 0:
            raise ValueError("Malformed MatrixMarket body")
        per_entry = data.size // nnz
        if per_entry < ncols_file:
            raise ValueError("Malformed MatrixMarket body")
        data = data.reshape(nnz, per_entry)[:, :ncols_file]

    r = data[:, 0].astype(np.int64) - 1
    c = data[:, 1].astype(np.int64) - 1
    if field == "pattern":
        v = np.ones(len(r), dtype=np.float32)
    else:
        v = data[:, 2].astype(np.float32)

    # Drop explicit zeros (spmv-helper.cpp:105-107).
    keep = v != 0.0
    r, c, v = r[keep], c[keep], v[keep]

    if symmetry in ("symmetric", "skew-symmetric"):
        off_diag = r != c
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        r, c, v = (
            np.concatenate([r, c[off_diag]]),
            np.concatenate([c, r[off_diag]]),
            np.concatenate([v, sign * v[off_diag]]),
        )

    return COOMatrix(
        (rows, cols),
        r.astype(np.int32),
        c.astype(np.int32),
        v,
    )


def save_mtx(path: str, mtx: COOMatrix, field: str = "real") -> None:
    """Write a COOMatrix as a general coordinate MatrixMarket file."""
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        f.write("% written by hispmv_tpu_torch\n")
        f.write(f"{mtx.num_rows} {mtx.num_cols} {mtx.nnz}\n")
        if field == "pattern":
            cols_out = np.stack([mtx.rows + 1, mtx.cols + 1], axis=1)
            np.savetxt(f, cols_out, fmt="%d %d")
        else:
            for r, c, v in zip(mtx.rows, mtx.cols, mtx.values):
                f.write(f"{r + 1} {c + 1} {v:.9g}\n")
