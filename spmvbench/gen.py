"""Matrix generators of the benchmark, run on the device from a seed.

- ``hex_fem``: the pattern of a 3-D finite-element model on a structured
  hexahedral grid, a dense block of ``dof`` x ``dof`` between every two
  nodes of one hexahedron, symmetric positive definite values;
- ``rmat``: a torch rewrite of the program's ``formats/synth.py::
  rmat_coo``, kept here so that the yardstick cannot move with the
  program; deduplicated after its uniform mix and topped up to the
  published number of nonzeros, with values ``1/outdegree`` of the source
  column (column stochastic, as PageRank needs).

Each generator returns ``(rows, cols, values)`` on ``gen.device``: int64
row and column indices sorted by (row, column) without duplicates, and
float32 values.  The same seed on the same kind of device gives the same
matrix.
"""

from __future__ import annotations

import math

import torch

ROUNDS = 64  # rounds of draws before a generator gives up


def make_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` (any integer that
    fits 64 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _trim(keys: torch.Tensor, nnz: int, gen: torch.Generator) -> torch.Tensor:
    """A random subset of ``nnz`` of the sorted unique ``keys``, sorted."""
    if keys.numel() <= nnz:
        return keys
    pick = torch.randperm(keys.numel(), generator=gen,
                          device=keys.device)[:nnz]
    return torch.sort(keys[pick]).values


def _node_pairs(grid, periodic, dev):
    """Every pair (n, m), n < m, of distinct nodes of one hexahedron of
    the grid ``grid`` (node counts along each axis, the last fastest in
    the numbering); an axis marked ``periodic`` closes on itself."""
    n0, n1, n2 = (int(g) for g in grid)
    node = torch.arange(n0 * n1 * n2, device=dev)
    at = (node // (n1 * n2), (node // n2) % n1, node % n2)
    first, second = [], []
    for d0 in (-1, 0, 1):
        for d1 in (-1, 0, 1):
            for d2 in (-1, 0, 1):
                ok = torch.ones_like(node, dtype=torch.bool)
                to = []
                for i, d, n, ring in zip(at, (d0, d1, d2), (n0, n1, n2),
                                         periodic):
                    j = i + d
                    if ring:
                        j = j % n
                    else:
                        ok &= (j >= 0) & (j < n)
                    to.append(j)
                m = (to[0] * n1 + to[1]) * n2 + to[2]
                ok &= m > node
                first.append(node[ok])
                second.append(m[ok])
    return torch.cat(first), torch.cat(second)


def hex_fem(rows: int, cols: int, nnz: int, gen: torch.Generator,
            grid, periodic, dof: int = 3):
    """A finite-element stiffness pattern: ``dof`` rows a node (node ``n``
    owns rows ``dof * n`` ...), nodes on the hexahedral grid ``grid``
    numbered with its last axis fastest, and a dense ``dof`` x ``dof``
    block between every two nodes of one hexahedron and on each node.
    Symmetric pairs of off-diagonal entries, drawn from the seed, are
    left out as exact zeros until ``nnz`` remain.  Off-diagonal values
    are standard normal and symmetric; each diagonal value is 1 plus the
    sum of its row's off-diagonal magnitudes, so the matrix is strictly
    diagonally dominant and positive definite."""
    dev = gen.device
    nodes = math.prod(int(g) for g in grid)
    if rows != cols or rows != dof * nodes:
        raise ValueError(f"hex_fem: {rows} x {cols} is not {dof} rows a "
                         f"node of a {grid} grid")
    if any(ring and int(n) < 3 for n, ring in zip(grid, periodic)):
        raise ValueError("hex_fem: a periodic axis needs 3 nodes or more")
    a, b = _node_pairs(grid, periodic, dev)
    i = torch.arange(dof, device=dev)
    da, db = i.repeat_interleave(dof), i.repeat(dof)
    up_r = torch.cat([(a[:, None] * dof + da).reshape(-1),
                      (torch.arange(nodes, device=dev)[:, None] * dof
                       + da[da < db]).reshape(-1)])
    up_c = torch.cat([(b[:, None] * dof + db).reshape(-1),
                      (torch.arange(nodes, device=dev)[:, None] * dof
                       + db[da < db]).reshape(-1)])
    del a, b
    drop = up_r.numel() + rows // 2 - nnz // 2
    if nnz % 2 != rows % 2 or drop < 0 or drop > up_r.numel():
        raise ValueError(f"hex_fem: {nnz} nonzeros do not fit the grid's "
                         f"{2 * up_r.numel() + rows} symmetric entries")
    keep = torch.randperm(up_r.numel(), generator=gen,
                          device=dev)[drop:]
    up_r, up_c = up_r[keep], up_c[keep]
    del keep
    v = torch.randn(up_r.numel(), generator=gen, device=dev,
                    dtype=torch.float32)
    v[v == 0] = 1.0
    diag = torch.ones(rows, dtype=torch.float64, device=dev)
    mag = v.abs().double()
    diag.index_add_(0, up_r, mag).index_add_(0, up_c, mag)
    del mag
    dr = torch.arange(rows, device=dev)
    r = torch.cat([up_r, up_c, dr])
    c = torch.cat([up_c, up_r, dr])
    del up_r, up_c
    order = torch.argsort(r * cols + c)
    values = torch.cat([v, v, diag.float()])[order]
    return r[order], c[order], values


def _rmat_keys(rows, cols, need, gen, a, b, c):
    """One round of R-MAT edges as keys ``r * cols + c``, in range."""
    dev = gen.device
    levels = max(int(math.ceil(math.log2(max(rows, cols, 2)))), 1)
    draw = int(need * 1.35) + 1024
    r = torch.zeros(draw, dtype=torch.int64, device=dev)
    cc = torch.zeros(draw, dtype=torch.int64, device=dev)
    p0 = torch.tensor([a, b, c, 1.0 - a - b - c], dtype=torch.float64,
                      device=dev)
    for _ in range(levels):
        noise = torch.empty(4, dtype=torch.float64, device=dev).uniform_(
            0.95, 1.05, generator=gen)
        p = p0 * noise
        edges = torch.cumsum(p / p.sum(), 0)[:3].float()
        u = torch.rand(draw, generator=gen, device=dev)
        q = torch.bucketize(u, edges, right=True)  # quadrant 0..3
        r = (r << 1) | (q >> 1)
        cc = (cc << 1) | (q & 1)
    ok = (r < rows) & (cc < cols)
    return (r * cols + cc)[ok]


def rmat(rows: int, cols: int, nnz: int, gen: torch.Generator,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         mix_uniform: float = 0.0):
    """R-MAT power-law graph (``synth.rmat_coo``, Graph500 quadrant
    probabilities with 5% noise a level), ``nnz`` unique edges; then a
    share ``mix_uniform`` of the edges moved to uniform random places,
    deduplicated and topped up with uniform edges to ``nnz`` again.
    Each value is 1 / the nonzeros of its column (empty columns stay
    empty: a dangling node)."""
    dev = gen.device
    if nnz > 0.5 * rows * cols:
        raise ValueError("rmat: too dense for rejection sampling")
    keys = torch.empty(0, dtype=torch.int64, device=dev)
    for _ in range(ROUNDS):
        need = nnz - keys.numel()
        if need <= 0:
            break
        keys = torch.unique(torch.cat(
            [keys, _rmat_keys(rows, cols, need, gen, a, b, c)]))
    else:
        raise RuntimeError(f"rmat: {keys.numel()} of {nnz} edges after "
                           f"{ROUNDS} rounds")
    keys = _trim(keys, nnz, gen)
    if mix_uniform:
        m = torch.rand(nnz, generator=gen, device=dev) < mix_uniform
        nm = int(m.sum())
        r = torch.randint(0, rows, (nm,), generator=gen, device=dev)
        cc = torch.randint(0, cols, (nm,), generator=gen, device=dev)
        keys = torch.unique(torch.cat([keys[~m], r * cols + cc]))
        for _ in range(ROUNDS):
            need = nnz - keys.numel()
            if need <= 0:
                break
            r = torch.randint(0, rows, (need,), generator=gen, device=dev)
            cc = torch.randint(0, cols, (need,), generator=gen, device=dev)
            keys = torch.unique(torch.cat([keys, r * cols + cc]))
        keys = _trim(keys, nnz, gen)
    r, cc = keys // cols, keys % cols
    deg = torch.bincount(cc, minlength=cols).double()
    return r, cc, (1.0 / deg[cc]).float()


GENERATORS = {"hex_fem": hex_fem, "rmat": rmat}


def generate(config: dict, seed: int, device):
    """The configuration's matrix from ``seed`` on ``device``: sorted
    unique int64 (rows, cols) and float32 values."""
    gen = make_generator(seed, device)
    fn = GENERATORS[config["generator"]]
    return fn(config["rows"], config["cols"], config["nnz"], gen,
              **config.get("params", {}))
