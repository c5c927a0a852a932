"""Synthetic sparse matrix generators + the reference benchmark fixture set.

Carried over from ``hispmv_tpu/formats/synth.py``: for the same seed every
generator gives bit-identical COO arrays in both packages, so the port and
the JAX package can be held against each other on the same fixtures.  The
stand-ins reproduce each SuiteSparse matrix's structural profile (shape,
nnz, row-length distribution family); shapes/nnz are approximate.  The
reference's 20 SuiteSparse matrices themselves are listed in
:data:`SUITE_URLS`; :func:`fetch_suite` downloads them where there is a
network.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np

from hispmv_tpu_torch.formats.matrix import COOMatrix

# Reference fixture URLs (get_tb_matrices.py:57-78), usable when the
# environment has network access.
SUITE_URLS = [
    "https://suitesparse-collection-website.herokuapp.com/MM/Precima/analytics.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/GHS_indef/boyd2.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/GHS_psdef/crankseg_2.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/GHS_psdef/ford2.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/Tromble/language.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/Belcastro/mouse_gene.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/Freescale/nxp1.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/Grund/poli_large.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/SNAP/soc-Pokec.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/IBM_EDA/trans5.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/Sandia/ASIC_680k.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/Schenk_IBMNA/c-52.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/Boeing/crystk03.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/VDOL/hangGlider_3.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/VDOL/lowThrust_7.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/ND/nd6k.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/Janna/PFlow_742.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/PARSEC/Si41Ge41H72.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/DNVS/thread.tar.gz",
    "https://suitesparse-collection-website.herokuapp.com/MM/TSOPF/TSOPF_RS_b2383.tar.gz",
]


@dataclasses.dataclass(frozen=True)
class MatrixProfile:
    """Structural profile of a benchmark matrix (approximate stats)."""

    name: str
    rows: int
    cols: int
    nnz: int  # expanded (post symmetry) nonzero count, approximate
    kind: str  # "banded" | "blocked" | "powerlaw" | "random" | "rmat" | "arrowhead"
    params: tuple = ()  # extra (key, value) generator arguments


# Approximate SuiteSparse statistics for the reference's 20-matrix suite.
# nnz counts are the *expanded* (general-form) values the reference computes
# after symmetry expansion.  Used only to build synthetic stand-ins; real
# matrices can be fetched with fetch_suite() where there is a network.
# Kinds chosen per structural family (round-2 fidelity pass — the round-1
# configuration-model "powerlaw" stand-ins misrepresented every class that
# has real-world locality):
#   FEM/stiffness      -> blocked/banded (unchanged)
#   social graph       -> rmat   (power-law WITH community locality)
#   gene network       -> rmat   (clustered correlation graph)
#   circuit / KKT opt  -> arrowhead (band + scattered dense rows/cols)
SUITE_PROFILES = {
    "TSOPF_RS_b2383": MatrixProfile(
        "TSOPF_RS_b2383", 38120, 38120, 16_171_169, "blocked",
        (("spread_frac", 0.5),),
    ),
    "mouse_gene": MatrixProfile(
        "mouse_gene", 45101, 45101, 28_967_291, "rmat",
        (("a", 0.45), ("b", 0.22), ("c", 0.22)),
    ),
    "nd6k": MatrixProfile(
        "nd6k", 18000, 18000, 6_897_316, "blocked",
        (("spread_frac", 0.5),),
    ),
    "crankseg_2": MatrixProfile(
        "crankseg_2", 63838, 63838, 14_148_858, "blocked",
        (("spread_frac", 0.4),),
    ),
    "thread": MatrixProfile(
        "thread", 29736, 29736, 4_444_880, "blocked",
        (("spread_frac", 0.4),),
    ),
    "crystk03": MatrixProfile("crystk03", 24696, 24696, 1_751_178, "banded"),
    "Si41Ge41H72": MatrixProfile(
        "Si41Ge41H72", 185639, 185639, 15_011_265, "blocked",
        (("spread_frac", 0.3),),
    ),
    "PFlow_742": MatrixProfile("PFlow_742", 742793, 742793, 37_138_461, "banded"),
    "lowThrust_7": MatrixProfile("lowThrust_7", 17378, 17378, 214_573, "banded"),
    "soc-Pokec": MatrixProfile(
        "soc-Pokec", 1632803, 1632803, 30_622_564, "rmat",
        (("mix_uniform", 0.85), ("pattern", 1)),
    ),
    "hangGlider_3": MatrixProfile("hangGlider_3", 10260, 10260, 92_703, "banded"),
    "c-52": MatrixProfile("c-52", 23948, 23948, 202_708, "arrowhead"),
    "nxp1": MatrixProfile("nxp1", 414604, 414604, 2_655_880, "arrowhead"),
    "trans5": MatrixProfile("trans5", 116835, 116835, 749_800, "arrowhead"),
    "analytics": MatrixProfile("analytics", 303813, 303813, 2_006_126, "random"),
    "ford2": MatrixProfile("ford2", 100196, 100196, 544_688, "banded"),
    "ASIC_680k": MatrixProfile(
        "ASIC_680k", 682862, 682862, 3_871_773, "arrowhead",
        (("hub_frac", 5e-5), ("hub_share", 0.3)),
    ),
    "boyd2": MatrixProfile(
        "boyd2", 466316, 466316, 1_500_397, "arrowhead",
        (("hub_frac", 5e-4), ("hub_share", 0.25)),
    ),
    "language": MatrixProfile(
        "language", 399130, 399130, 1_216_334, "rmat",
        (("mix_uniform", 0.9), ("pattern", 1)),
    ),
    "poli_large": MatrixProfile("poli_large", 15575, 15575, 33_074, "random"),
}


def random_coo(
    rows: int, cols: int, nnz: int, seed: int = 0, dedup: bool = True
) -> COOMatrix:
    """Uniformly random sparse matrix (general_test.py:36-44 analog)."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, rows, size=nnz, dtype=np.int64)
    c = rng.integers(0, cols, size=nnz, dtype=np.int64)
    if dedup:
        key = r * cols + c
        _, idx = np.unique(key, return_index=True)
        r, c = r[idx], c[idx]
    v = rng.standard_normal(len(r)).astype(np.float32)
    v[v == 0] = 1.0
    return COOMatrix((rows, cols), r, c, v)


def banded_coo(
    rows: int,
    cols: int,
    nnz: int,
    seed: int = 0,
    bandwidth: Optional[int] = None,
    run: int = 24,
) -> COOMatrix:
    """FEM-style banded matrix: each row holds a few CONTIGUOUS runs of
    nonzeros near the diagonal, and adjacent rows couple to nearly the same
    columns (element connectivity).  This matches real FEM band structure
    (crystk03, PFlow_742, ...): scattered-ban d generators misrepresent how
    block-friendly such matrices are."""
    rng = np.random.default_rng(seed)
    per_row = max(1, nnz // rows)
    nruns = max(1, per_row // run)
    run_len = max(1, per_row // nruns)
    if bandwidth is None:
        bandwidth = max(2 * per_row, 4 * run_len * nruns)
    r_idx = np.arange(rows, dtype=np.int64)
    # run base offsets shared by 8-row groups (element blocks), with small
    # per-group jitter
    group = r_idx // 8
    ngroups = int(group.max()) + 1
    jit = rng.integers(-run_len // 2, run_len // 2 + 1, size=(ngroups, nruns))
    spacing = max(bandwidth // max(nruns, 1), run_len)
    starts = (
        r_idx[:, None]
        - bandwidth // 2
        + np.arange(nruns)[None, :] * spacing
        + jit[group]
    )  # [rows, nruns]
    offs = np.arange(run_len, dtype=np.int64)
    c = (starts[:, :, None] + offs[None, None, :]).reshape(rows, -1)
    c = np.clip(c, 0, cols - 1)
    r = np.repeat(r_idx, c.shape[1])
    c = c.reshape(-1)
    key = r * cols + c
    _, idx = np.unique(key, return_index=True)
    r, c = r[idx], c[idx]
    v = rng.standard_normal(len(r)).astype(np.float32)
    v[v == 0] = 1.0
    return COOMatrix((rows, cols), r, c, v)


def blocked_coo(
    rows: int,
    cols: int,
    nnz: int,
    seed: int = 0,
    group: int = 8,
    density: float = 0.7,
    width_sigma: float = 0.0,
    spread_frac: float = 0.0,
) -> COOMatrix:
    """FEM-stiffness-style matrix (nd6k, crankseg_2, ... profile): groups of
    ``group`` consecutive rows share a contiguous column window near the
    diagonal and are ~``density`` dense inside it.  This reproduces the
    clustered structure that makes such matrices block-friendly on real
    hardware (wide contiguous runs, not isolated scattered nonzeros)."""
    rng = np.random.default_rng(seed)
    per_row = max(1, nnz // rows)
    width = max(int(per_row / density), 8)
    ngroups = -(-rows // group)
    base = np.clip(
        np.arange(ngroups, dtype=np.int64) * group
        - width // 2
        + rng.integers(-width // 4, width // 4 + 1, size=ngroups),
        0,
        max(0, cols - width),
    )
    # lognormal per-group size variation (width_sigma > 0): real FEM
    # meshes mix element types, so row-group loads vary — the uniform
    # generator under-stressed the reference balancer by ~25%
    # (benchmarks/fidelity.py)
    scale = (
        np.exp(rng.normal(0.0, width_sigma, size=ngroups))
        if width_sigma else np.ones(ngroups)
    )
    scale = scale / scale.mean()
    if spread_frac:
        # ND/dissection-style long-range coupling: a fraction of groups
        # sit at random column positions instead of near the diagonal
        # (validated against the reference cycle model: the purely banded
        # generator under-stressed its tiling by ~25-30%)
        far = rng.random(ngroups) < spread_frac
        base[far] = rng.integers(
            0, max(cols - width, 1), int(far.sum())
        )
    fills = np.maximum(
        (group * width * density * scale).astype(np.int64), 1
    )
    g = np.repeat(np.arange(ngroups, dtype=np.int64), fills)
    rr = rng.integers(0, group, size=len(g))
    cc = rng.integers(0, width, size=len(g))
    r = g * group + rr
    c = base[g] + cc
    ok = (r < rows) & (c < cols)
    r, c = r[ok], c[ok]
    key = r * cols + c
    _, idx = np.unique(key, return_index=True)
    r, c = r[idx], c[idx]
    v = rng.standard_normal(len(r)).astype(np.float32)
    v[v == 0] = 1.0
    return COOMatrix((rows, cols), r, c, v)


def powerlaw_coo(
    rows: int, cols: int, nnz: int, seed: int = 0, alpha: float = 1.0
) -> COOMatrix:
    """Scale-free matrix with Zipf-distributed row AND column degrees — the
    highly imbalanced profile (soc-Pokec et al.) that motivates the
    reference's hybrid row-distribution network.  Hub columns exist too
    (real graphs are Zipf on both axes), which is what the planner's
    degree-based column reordering exploits."""
    rng = np.random.default_rng(seed)
    # Zipf row weights, shuffled so heavy rows are scattered.
    w = 1.0 / np.arange(1, rows + 1, dtype=np.float64) ** alpha
    rng.shuffle(w)
    w /= w.sum()
    # Zipf column weights (independently shuffled).
    # Column (in-degree) tail is typically lighter: rank exponent ~0.7x.
    wc = 1.0 / np.arange(1, cols + 1, dtype=np.float64) ** (0.7 * alpha)
    rng.shuffle(wc)
    wc /= wc.sum()
    # Hub x hub pairs collide massively under independent sampling; draw in
    # rounds until the UNIQUE pair count reaches the target (real graphs
    # have distinct edges).
    keys = np.array([], np.int64)
    for _ in range(6):
        need = nnz - len(keys)
        if need <= 0:
            break
        counts = rng.multinomial(int(need * 1.5), w)
        r = np.repeat(np.arange(rows, dtype=np.int64), counts)
        c = rng.choice(cols, size=len(r), p=wc).astype(np.int64)
        keys = np.unique(np.concatenate([keys, r * cols + c]))
    if len(keys) > nnz:
        keys = rng.choice(keys, size=nnz, replace=False)
    r, c = keys // cols, keys % cols
    v = rng.standard_normal(len(r)).astype(np.float32)
    v[v == 0] = 1.0
    return COOMatrix((rows, cols), r, c, v)


def rmat_coo(
    rows: int,
    cols: int,
    nnz: int,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    row_cap: int = 0,
    mix_uniform: float = 0.0,
    pattern: int = 0,
) -> COOMatrix:
    """R-MAT / Kronecker graph generator (Graph500 defaults).

    Social graphs like soc-Pokec are NOT configuration models: their
    power-law degrees come with hierarchical community structure, which
    shows up as self-similar block density (locality).  The plain
    Zipf-x-Zipf sampler (powerlaw_coo) is the worst case for any blocked
    format and misrepresents this class (round-1 finding); R-MAT is the
    standard faithful stand-in.  Each edge picks one of four quadrants per
    bit level with probabilities (a, b, c, d), recursively."""
    rng = np.random.default_rng(seed)
    d = 1.0 - a - b - c
    assert d > 0
    levels = max(int(np.ceil(np.log2(max(rows, cols, 2)))), 1)
    # cumulative quadrant thresholds; small per-level noise defeats the
    # exact self-similarity artifacts
    keys = np.array([], np.int64)
    for _ in range(8):
        need = nnz - len(keys)
        if need <= 0:
            break
        draw = int(need * 1.35) + 1024
        r = np.zeros(draw, np.int64)
        cc = np.zeros(draw, np.int64)
        for lvl in range(levels):
            noise = rng.uniform(0.95, 1.05, size=4)
            p = np.array([a, b, c, d]) * noise
            p /= p.sum()
            q = rng.choice(4, size=draw, p=p)
            r = (r << 1) | (q >> 1)
            cc = (cc << 1) | (q & 1)
        ok = (r < rows) & (cc < cols)
        new = r[ok] * cols + cc[ok]
        keys = np.unique(np.concatenate([keys, new]))
    if len(keys) > nnz:
        keys = rng.choice(keys, size=nnz, replace=False)
    r, cc = keys // cols, keys % cols
    if mix_uniform:
        # blend in uniform edges: the pure-R-MAT BODY degree distribution
        # over-concentrates per-PE loads relative to the real matrices
        # (validated against the reference cycle model on the real
        # matrices' own predicted cycle counts, benchmarks/fidelity.py)
        m = rng.random(len(r)) < mix_uniform
        nm = int(m.sum())
        r = r.copy()
        cc = cc.copy()
        r[m] = rng.integers(0, rows, nm)
        cc[m] = rng.integers(0, cols, nm)
    if row_cap:
        # real graphs have BOUNDED max degree (the R-MAT tail overshoots
        # it): excess entries of rows above the cap are reassigned to
        # uniform random rows
        deg = np.bincount(r, minlength=rows)
        order = np.argsort(r, kind="stable")
        pos = np.empty(len(r), np.int64)
        pos[order] = np.arange(len(r)) - np.repeat(
            np.concatenate([[0], np.cumsum(deg)])[:-1], deg
        )
        over = pos >= row_cap
        r = r.copy()
        r[over] = rng.integers(0, rows, int(over.sum()))
    if pattern:
        # SuiteSparse graph matrices (soc-Pokec, language) are PATTERN
        # matrices: the reference's loader sets every value to 1.0
        # (spmv-helper.cpp loadMtx pattern contract).  All-positive row
        # sums also remove the fp32 cancellation that random values
        # fabricate on rows the real matrix never stresses.
        v = np.ones(len(r), np.float32)
    else:
        v = rng.standard_normal(len(r)).astype(np.float32)
        v[v == 0] = 1.0
    return COOMatrix((rows, cols), r, cc, v)


def arrowhead_coo(
    rows: int,
    cols: int,
    nnz: int,
    seed: int = 0,
    hub_frac: float = 0.002,
    hub_share: float = 0.35,
    band_frac: float = 0.02,
    noise_share: float = 0.05,
) -> COOMatrix:
    """Circuit/KKT-style "arrowhead" matrix: a near-diagonal band plus a few
    dense rows AND columns (power/ground rails, coupling constraints) at
    scattered indices, plus uniform background noise.

    Stand-in for trans5 / nxp1 / ASIC_680k / boyd2 / c-52: those matrices
    are predominantly banded with O(10-1000) global hub rows/cols — not
    uniform Zipf scatter.  Hubs are placed at RANDOM indices so formats
    must discover them (degree-based), not rely on position."""
    rng = np.random.default_rng(seed)
    n_hub = max(1, int(hub_frac * min(rows, cols)))
    hub_rows = rng.choice(rows, size=n_hub, replace=False).astype(np.int64)
    hub_cols = rng.choice(cols, size=n_hub, replace=False).astype(np.int64)
    n_hub_nnz = int(nnz * hub_share)
    n_noise = int(nnz * noise_share)
    n_band = max(nnz - n_hub_nnz - n_noise, 0)

    # band: per-row entries around the (scaled) diagonal with LOG-UNIFORM
    # offset magnitudes in [1, bw] — circuit/KKT couplings concentrate
    # tightly near the diagonal with a heavy tail, not uniformly across a
    # wide band (uniform-in-band was the round-1 fidelity error).
    bw = max(int(band_frac * cols), 8)
    per_row = max(1, n_band // rows)
    r_band = np.repeat(np.arange(rows, dtype=np.int64), per_row)
    diag = (r_band * cols) // rows
    mag = np.exp(
        rng.uniform(0.0, np.log(bw), size=len(r_band))
    ).astype(np.int64)
    sign = rng.integers(0, 2, size=len(r_band)) * 2 - 1
    c_band = np.clip(diag + sign * mag, 0, cols - 1)

    # hubs: half the hub nnz on dense rows (uniform cols), half on dense
    # cols (uniform rows).  Hub degrees are Zipf-distributed — real circuit
    # hubs (ground/power rails, global constraints) are a FEW massive
    # rows/cols (ASIC_680k's heaviest rows carry ~1e5 nnz), not many weak
    # ones; uniform hub weights were the round-2 fidelity error that made
    # hub detection meaningless.
    hub_w = 1.0 / np.arange(1, n_hub + 1, dtype=np.float64)
    hub_w /= hub_w.sum()
    h2 = n_hub_nnz // 2
    r_hr = rng.choice(hub_rows, size=h2, p=hub_w)
    c_hr = rng.integers(0, cols, size=h2)
    r_hc = rng.integers(0, rows, size=n_hub_nnz - h2)
    c_hc = rng.choice(hub_cols, size=n_hub_nnz - h2, p=hub_w)

    r_n = rng.integers(0, rows, size=n_noise)
    c_n = rng.integers(0, cols, size=n_noise)

    r = np.concatenate([r_band, r_hr, r_hc, r_n])
    c = np.concatenate([c_band, c_hr, c_hc, c_n])
    key = r * cols + c
    _, idx = np.unique(key, return_index=True)
    r, c = r[idx], c[idx]
    v = rng.standard_normal(len(r)).astype(np.float32)
    v[v == 0] = 1.0
    return COOMatrix((rows, cols), r, c, v)


_GENERATORS = {
    "random": random_coo,
    "banded": banded_coo,
    "blocked": blocked_coo,
    "powerlaw": powerlaw_coo,
    "rmat": rmat_coo,
    "arrowhead": arrowhead_coo,
}


def synth_from_profile(profile: MatrixProfile, seed: int = 0) -> COOMatrix:
    """Build a synthetic stand-in for a suite matrix profile."""
    return _GENERATORS[profile.kind](
        profile.rows, profile.cols, profile.nnz, seed=seed,
        **dict(profile.params),
    )


def suite_matrix(name: str, scale: float = 1.0, seed: int = 0) -> COOMatrix:
    """Synthetic stand-in for a named suite matrix, optionally size-scaled.

    Generated anew on every call (the JAX package's on-disk cache is left
    out: the port reads and writes nothing outside its caller's data)."""
    p = SUITE_PROFILES[name]
    if scale != 1.0:
        p = MatrixProfile(
            p.name,
            max(64, int(p.rows * scale)),
            max(64, int(p.cols * scale)),
            max(64, int(p.nnz * scale)),
            p.kind,
            p.params,
        )
    return synth_from_profile(p, seed=seed)


def fetch_suite(directory: str, urls: Optional[Sequence[str]] = None) -> list:
    """Download and extract the reference's 20 SuiteSparse fixtures
    (``urls`` defaults to :data:`SUITE_URLS`; any URL ``urllib`` opens,
    ``file://`` included) into ``directory``; a matrix already extracted
    there is not fetched again.  Returns the ``.mtx`` paths, in order."""
    import tarfile
    import urllib.request

    os.makedirs(directory, exist_ok=True)
    paths = []
    for url in SUITE_URLS if urls is None else urls:
        name = url.rstrip("/").split("/")[-1].replace(".tar.gz", "")
        mtx_path = os.path.join(directory, name, f"{name}.mtx")
        if not os.path.exists(mtx_path):
            tgz = os.path.join(directory, f"{name}.tar.gz")
            urllib.request.urlretrieve(url, tgz)
            with tarfile.open(tgz) as tar:
                tar.extractall(directory, filter="data")
            os.remove(tgz)
        paths.append(mtx_path)
    return paths
