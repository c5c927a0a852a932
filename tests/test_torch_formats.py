"""The port's formats layer against the JAX package's: synthetic generators
and suite stand-ins give identical COO arrays for the same seed, and the
MatrixMarket loader and COO helpers agree."""

import io

import numpy as np
import pytest
import scipy.sparse as sp

from hispmv_tpu.formats import matrix as jmatrix
from hispmv_tpu.formats import mtx as jmtx
from hispmv_tpu.formats import synth as jsynth
from hispmv_tpu_torch.formats import matrix as tmatrix
from hispmv_tpu_torch.formats import mtx as tmtx
from hispmv_tpu_torch.formats import synth as tsynth


def assert_same_coo(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    for f in ("rows", "cols", "values"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


GENERATORS = {
    "random": (400, 300, 3000, {}),
    "banded": (500, 500, 6000, {}),
    "blocked": (512, 512, 8000, {"spread_frac": 0.4}),
    "powerlaw": (400, 400, 5000, {}),
    "rmat": (600, 600, 5000, {"mix_uniform": 0.5, "pattern": 1}),
    "arrowhead": (700, 700, 6000, {}),
}


@pytest.mark.parametrize("kind", list(GENERATORS))
@pytest.mark.parametrize("seed", [0, 5])
def test_generators_bit_identical(kind, seed):
    rows, cols, nnz, kw = GENERATORS[kind]
    a = jsynth._GENERATORS[kind](rows, cols, nnz, seed=seed, **kw)
    b = tsynth._GENERATORS[kind](rows, cols, nnz, seed=seed, **kw)
    assert_same_coo(a, b)


@pytest.mark.parametrize(
    "name", ["crystk03", "trans5", "TSOPF_RS_b2383", "soc-Pokec", "ford2"]
)
def test_suite_matrix_bit_identical(name):
    a = jsynth.suite_matrix(name, 0.01, seed=3, cache_dir=None)
    b = tsynth.suite_matrix(name, 0.01, seed=3)
    assert_same_coo(a, b)


def test_suite_profiles_identical():
    assert list(tsynth.SUITE_PROFILES) == list(jsynth.SUITE_PROFILES)
    for name, p in jsynth.SUITE_PROFILES.items():
        assert dataclass_tuple(tsynth.SUITE_PROFILES[name]) == (
            dataclass_tuple(p)
        )


def dataclass_tuple(p):
    return (p.name, p.rows, p.cols, p.nnz, p.kind, p.params)


MTX = """%%MatrixMarket matrix coordinate real symmetric
% comment
4 4 5
1 1 2.5
2 1 -1.0
3 3 0.0
4 2 7
4 4 1e-3
"""


@pytest.mark.parametrize("text", [
    MTX,
    MTX.replace("real symmetric", "real skew-symmetric"),
    "%%MatrixMarket matrix coordinate pattern general\n3 5 3\n1 1\n2 5\n3 2\n",
    "%%MatrixMarket matrix coordinate integer general\n2 2 2\n1 2 3\n2 1 -4\n",
])
def test_load_mtx_matches_jax(text):
    assert_same_coo(
        jmtx.load_mtx(io.StringIO(text)), tmtx.load_mtx(io.StringIO(text))
    )


def test_save_load_roundtrip_matches_jax(tmp_path):
    coo = tsynth.random_coo(50, 70, 400, seed=9)
    path = str(tmp_path / "m.mtx")
    tmtx.save_mtx(path, coo)
    assert_same_coo(jmtx.load_mtx(path), tmtx.load_mtx(path))
    assert_same_coo(tmtx.load_mtx(path), coo)


def test_coo_helpers_match_jax():
    dense = np.random.default_rng(4).standard_normal((9, 13))
    dense[dense < 0.5] = 0
    assert_same_coo(jmatrix.coo_from_dense(dense),
                    tmatrix.coo_from_dense(dense))
    m = sp.random(30, 20, density=0.2, random_state=1, format="csr")
    assert_same_coo(jmatrix.coo_from_scipy(m), tmatrix.coo_from_scipy(m))
    coo = tmatrix.coo_from_scipy(m)
    x = np.linspace(-1, 1, 20)
    np.testing.assert_array_equal(
        coo.matvec(x), jmatrix.coo_from_scipy(m).matvec(x)
    )
    np.testing.assert_array_equal(coo.to_dense(), m.toarray().astype(np.float32))
