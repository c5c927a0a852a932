"""The benchmark's generators: shape, exact nonzeros, order, seeds."""

import pytest
import torch

from spmvbench import gen

HEX = dict(grid=(8, 12, 7), periodic=(True, False, False), dof=3)
HEX_ROWS = 3 * 8 * 12 * 7


def _hex(seed, nnz=HEX_ROWS * 66):
    return gen.hex_fem(HEX_ROWS, HEX_ROWS, nnz,
                       gen.make_generator(seed, "cpu"), **HEX)


def _rmat(seed):
    return gen.rmat(4000, 4000, 40_000, gen.make_generator(seed, "cpu"),
                    mix_uniform=0.85)


@pytest.mark.parametrize("make,rows,nnz", [(_hex, HEX_ROWS, HEX_ROWS * 66),
                                           (_rmat, 4000, 40_000)])
def test_exact_nnz_sorted_unique_in_range(make, rows, nnz):
    r, c, v = make(2**31 + 17)
    assert r.numel() == c.numel() == v.numel() == nnz
    assert v.dtype == torch.float32 and bool(torch.isfinite(v).all())
    assert int(r.min()) >= 0 and int(c.min()) >= 0
    assert int(r.max()) < rows and int(c.max()) < rows
    keys = r * rows + c
    assert bool((keys[1:] > keys[:-1]).all())  # sorted by (row, col), unique
    assert bool((v != 0).all())


@pytest.mark.parametrize("make", [_hex, _rmat])
def test_same_seed_same_matrix(make):
    a, b, other = make(5), make(5), make(6)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[2], other[2])


def _dense(r, c, v, n):
    a = torch.zeros(n, n, dtype=torch.float64)
    a[r, c] = v.double()
    return a


def test_hex_fem_is_symmetric_positive_definite():
    r, c, v = _hex(3)
    a = _dense(r, c, v, HEX_ROWS)
    assert torch.equal(a, a.T)
    off = a - torch.diag(torch.diagonal(a))
    assert bool((torch.diagonal(a) > off.abs().sum(dim=1)).all())
    assert float(torch.linalg.eigvalsh(a).min()) > 0


def test_hex_fem_couples_the_nodes_of_one_hexahedron():
    n0, n1, n2 = HEX["grid"]
    full = 9 * (3 * n0) * (3 * n1 - 2) * (3 * n2 - 2)  # ring around
    r, c, _ = _hex(4, nnz=full)
    assert r.numel() == full  # nothing left out: every coupling is there

    def at(node):
        return node // (n1 * n2), (node // n2) % n1, node % n2

    (a0, a1, a2), (b0, b1, b2) = at(r // 3), at(c // 3)
    around = (a0 - b0).abs()
    assert int(torch.minimum(around, n0 - around).max()) == 1  # closes
    assert int((a1 - b1).abs().max()) == 1
    assert int((a2 - b2).abs().max()) == 1
    # the interior nodes couple with 27 nodes, three rows each
    per_row = torch.bincount(r, minlength=HEX_ROWS)
    assert int(per_row.max()) == 81


def test_hex_fem_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        _hex(1, nnz=HEX_ROWS * 66 + 1)  # no symmetric pattern has it
    with pytest.raises(ValueError):
        _hex(1, nnz=HEX_ROWS * 90)  # more than the grid couples
    with pytest.raises(ValueError):
        gen.hex_fem(HEX_ROWS + 3, HEX_ROWS + 3, 1000,
                    gen.make_generator(1, "cpu"), **HEX)


def test_rmat_values_are_column_stochastic():
    r, c, v = _rmat(3)
    sums = torch.zeros(4000, dtype=torch.float64).index_add_(0, c, v.double())
    live = torch.bincount(c, minlength=4000) > 0
    assert torch.allclose(sums[live], torch.ones_like(sums[live]), atol=1e-6)
    assert bool((sums[~live] == 0).all())


def test_generate_by_config():
    cfg = {"generator": "hex_fem", "rows": HEX_ROWS, "cols": HEX_ROWS,
           "nnz": HEX_ROWS * 60, "params": HEX}
    r, _, _ = gen.generate(cfg, 9, "cpu")
    assert r.numel() == HEX_ROWS * 60
    cfg = {"generator": "rmat", "rows": 1000, "cols": 1000, "nnz": 9000,
           "params": {"mix_uniform": 0.85}}
    assert gen.generate(cfg, 9, "cpu")[0].numel() == 9000


def test_rmat_too_dense_is_refused():
    with pytest.raises(ValueError):
        gen.rmat(80, 80, 3300, gen.make_generator(1, "cpu"))
