"""Design-space exploration: pick the best format and config per matrix.

Port of ``hispmv_tpu/tune/dse.py`` (numpy only).  The model-only search
(``DSE.explore``) is carried over unchanged over the port's own copies of
the planners' estimators, each given the search's profile: under ``V5E``
(``DSE``'s default) its format, config and candidate ranking equal the
JAX tuner's, and its estimates are TPU figures; ``tune`` takes the
profile of its device, ``H100`` on the card, whose estimates are the
card's model.  ``tune(measure=N)`` builds the shortlisted candidates as
port handles on ``device`` under the same profile and times each with
``utils/timing.bench_spmv``: on the card, the measured winner is the
card's.  The JAX package's source-hash generations of its caches
(``family_gen``) are left out: a cache entry is keyed by the matrix
fingerprint and the profile's name and values only.

The axes: format (dense overlay | block-ELL | windowed block-ELL | ELLX |
split | routed | rank-space routed | gather stream), block height, column
reorder and payload dtype.  Every candidate is costed WITHOUT building a
plan: block counts come from unique-key counting over the coordinates,
stream lengths from a rounds-packing simulation over row lengths.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import traceback
from typing import Optional

import numpy as np

from hispmv_tpu_torch.config import SpmvConfig
from hispmv_tpu_torch.formats.matrix import COOMatrix
from hispmv_tpu_torch.ops.spmv_ellx import choose_k_base
from hispmv_tpu_torch.plan.blocks import LANES, degree_column_perm
from hispmv_tpu_torch.plan.partition import derive_split_threshold
from hispmv_tpu_torch.plan.permute import (
    degree_rank_perms,
    estimate_permute_cost_ns,
)
from hispmv_tpu_torch.plan.routed import (
    best_routed_estimate,
    estimate_banded_routed_ns,
    routed_vmem_ok,
)
from hispmv_tpu_torch.plan.split import _MAX_HUBS
from hispmv_tpu_torch.plan.windows import SEGS, WINDOW
from hispmv_tpu_torch.tune.cost import (
    V5E,
    CostModel,
    DeviceProfile,
    device_profile,
    profile_key,
)
from hispmv_tpu_torch.utils.timing import bench_spmv


@dataclasses.dataclass
class TuneResult:
    format: str
    config: SpmvConfig
    est_seconds: float
    est_gflops: float
    candidates: list  # [(label, est_seconds), ...] sorted best-first

    measured: bool = False
    # the first n_measured candidates (and est_seconds, when measured) are
    # times on the device; the rest are the profile's model estimates
    n_measured: int = 0

    def to_json(self) -> dict:
        return {
            "format": self.format,
            "config": dataclasses.asdict(self.config),
            "est_seconds": self.est_seconds,
            "est_gflops": self.est_gflops,
            "candidates": self.candidates,
            "measured": self.measured,
            "n_measured": self.n_measured,
        }

    @staticmethod
    def from_json(d: dict) -> "TuneResult":
        return TuneResult(
            format=d["format"],
            config=SpmvConfig(**d["config"]),
            est_seconds=d["est_seconds"],
            est_gflops=d["est_gflops"],
            candidates=[tuple(c) for c in d["candidates"]],
            measured=d.get("measured", False),
            n_measured=d.get("n_measured", 0),
        )


def matrix_fingerprint(coo: COOMatrix) -> str:
    """Cheap content hash: shape, nnz, and a strided coordinate sample."""
    h = hashlib.sha256()
    h.update(np.asarray([*coo.shape, coo.nnz], np.int64).tobytes())
    if coo.nnz:
        idx = np.linspace(0, coo.nnz - 1, min(coo.nnz, 4096)).astype(np.int64)
        h.update(coo.rows[idx].tobytes())
        h.update(coo.cols[idx].tobytes())
    return h.hexdigest()[:24]


def estimate_stream_steps(
    row_len: np.ndarray, num_pes: int, split_threshold: int
) -> int:
    """Predict the stream planner's total step count without building it.

    Mirrors plan/partition.py:build_plan: segment rows at the threshold,
    sort descending, rounds of ``num_pes``; steps per round = size of its
    largest segment."""
    nz = row_len[row_len > 0]
    if len(nz) == 0:
        return 0
    n_splits = -(-nz // split_threshold)
    # Segment sizes: (n_splits - 1) full chunks + remainder per row.
    full = (n_splits - 1).sum()
    rem = nz - (n_splits - 1) * split_threshold
    seg_len = np.concatenate(
        [np.full(int(full), split_threshold, np.int64), rem]
    )
    seg_len = np.sort(seg_len)[::-1]
    E = -(-len(seg_len) // num_pes)
    return int(seg_len[np.arange(E) * num_pes].sum())


def count_window_blocks(
    rows: np.ndarray,
    cols: np.ndarray,
    block_h: int,
    num_cols: int,
) -> int:
    """Exact block count for the windowed format (plan/windows.py): one
    block per (row_block, window, conflict-layer)."""
    n = len(rows)
    if n == 0:
        return 0
    nwin = max(-(-num_cols // WINDOW), 1)
    rb = rows.astype(np.int64) // block_h
    wb = cols // WINDOW
    lane = cols % LANES
    sub = (cols // LANES) % SEGS
    key = ((rb * nwin + wb) * LANES + lane) * SEGS + sub
    uniq = np.unique(key)
    group = uniq // SEGS  # (rb, wb, lane)
    first = np.zeros(len(uniq), np.int64)
    newgrp = np.nonzero(np.diff(group))[0] + 1
    first[newgrp] = newgrp
    np.maximum.accumulate(first, out=first)
    layer = np.arange(len(uniq)) - first
    block_key = (group // LANES) * SEGS + layer
    return len(np.unique(block_key))


def count_blocks(
    rows: np.ndarray,
    cols: np.ndarray,
    block_h: int,
    num_cols: int,
) -> int:
    """Exact number of distinct (row_block, col_block) keys.

    One sort over the coordinates — seconds even at 30M nnz, in line with
    the reference's preprocessing budget (0.03-18.5 s, U280_metrics.csv)."""
    n = len(rows)
    if n == 0:
        return 0
    ncb = max(-(-num_cols // LANES), 1)
    key = (rows.astype(np.int64) // block_h) * ncb + cols // LANES
    key.sort()
    return int(1 + np.count_nonzero(np.diff(key)))


def _label_format(label: str) -> str:
    """Candidate label -> handle format name."""
    stem = label.replace("-bf16", "").replace("-cr", "")
    if stem in ("dense", "stream", "split", "routed", "routed-rank"):
        return "routed" if stem == "routed-rank" else stem
    if stem.startswith("ellx"):
        return "ellx"
    if stem.startswith("win"):
        return "window"
    return "block"


class DSE:
    """Exhaustive search over the candidate grid under the cost model."""

    def __init__(self, profile: DeviceProfile = V5E):
        self.model = CostModel(profile)

    def explore(self, coo: COOMatrix, base: Optional[SpmvConfig] = None) -> TuneResult:
        base = base or SpmvConfig()
        p = self.model.p
        R, C = coo.shape
        nnz = coo.nnz
        flops = 2 * (nnz + R)
        cands = []

        # Dense overlay.
        density = nnz / max(R * C, 1)
        dense_bytes = self.model.dense_resident_bytes(R, C)
        if self.model.fits(dense_bytes) and density > 0.01:
            cands.append(
                ("dense", self.model.dense_seconds(R, C),
                 dataclasses.replace(base, dense_overlay=True))
            )

        # Block-ELL: one O(nnz) sort at block_h=8; larger heights derived
        # from the (much smaller) unique-key array.
        ncb = max(-(-C // LANES), 1)
        rb8 = coo.rows.astype(np.int64) // 8
        uk8 = np.unique(rb8 * ncb + coo.cols // LANES)
        uk_rb8, uk_cb = uk8 // ncb, uk8 % ncb
        # column-reorder axis: a degree-descending column permutation
        # concentrates hub columns into few blocks (the reference DSE
        # walks its whole config space, dse.py:48-88; this is ours).
        # Evaluated at block_h=8 via the permuted unique-key count; a
        # "-cr" candidate is emitted only when it models >= 10% fewer
        # units than the identity ordering.
        cr_perm = degree_column_perm(coo)
        cr_rank = np.empty(C, np.int64)
        cr_rank[cr_perm] = np.arange(C)
        cr_cols = cr_rank[coo.cols.astype(np.int64)]
        uk8_cr = np.unique(rb8 * ncb + cr_cols // LANES)
        cr_gain = len(uk8_cr) < 0.9 * len(uk8)
        for bh in (8, 16, 32, 64, 128):
            if bh == 8:
                nb = len(uk8)
            else:
                nb = len(np.unique((uk_rb8 // (bh // 8)) * ncb + uk_cb))
            nb = max(nb, -(-R // bh))
            if not self.model.fits(self.model.block_resident_bytes(nb, bh)):
                continue
            if self.model.block_resident_bytes(nb, bh) > 100 * max(nnz, 1):
                continue  # >100 B/nnz: pathological plan (prep/upload blow-up)
            t32 = self.model.block_seconds(nb, bh, R, C)
            cands.append(
                (f"block{bh}", t32, dataclasses.replace(base, block_h=bh))
            )
            if cr_gain and bh == 8:
                nb_cr = max(len(uk8_cr), -(-R // bh))
                cands.append((
                    "block8-cr",
                    self.model.block_seconds(nb_cr, bh, R, C),
                    dataclasses.replace(
                        base, block_h=bh, col_reorder=True
                    ),
                ))
            t16 = self.model.block_seconds_bf16(nb, bh, R, C)
            if t16 < t32 * 0.95:  # only when meaningfully DMA-bound
                cands.append(
                    (f"block{bh}-bf16", t16,
                     dataclasses.replace(
                         base, block_h=bh, value_dtype="bfloat16"))
                )

        # Windowed block-ELL: same trick — one unique over slot keys at
        # block_h=8, larger heights derived from the unique-slot array.
        nwin = max(-(-C // WINDOW), 1)
        wb = coo.cols // WINDOW
        lane = coo.cols % LANES
        sub = (coo.cols // LANES) % SEGS
        us8 = np.unique(
            ((rb8 * nwin + wb) * LANES + lane) * SEGS + sub
        )
        us_rb8 = us8 // (np.int64(nwin) * LANES * SEGS)
        us_rest = us8 % (np.int64(nwin) * LANES * SEGS)
        for bh in (8, 16, 32, 64, 128):
            merged = (us_rb8 // (bh // 8)) * (np.int64(nwin) * LANES * SEGS)
            merged = merged + us_rest
            u = np.unique(merged) if bh > 8 else us8 if bh == 8 else None
            group = u // SEGS
            first = np.zeros(len(u), np.int64)
            newgrp = np.nonzero(np.diff(group))[0] + 1
            first[newgrp] = newgrp
            np.maximum.accumulate(first, out=first)
            layer = np.arange(len(u)) - first
            nb = len(np.unique((group // LANES) * SEGS + layer))
            nb = max(nb, -(-R // bh))
            if not self.model.fits(
                self.model.window_resident_bytes(nb, bh)
            ):
                continue
            if self.model.window_resident_bytes(nb, bh) > 100 * max(nnz, 1):
                continue  # >100 B/nnz: pathological plan
            t32 = self.model.window_seconds(nb, bh, R, C)
            cands.append(
                (f"win{bh}", t32, dataclasses.replace(base, block_h=bh))
            )
            t16 = self.model.window_seconds_bf16(nb, bh, R, C)
            if t16 < t32 * 0.95:
                cands.append(
                    (f"win{bh}-bf16", t16,
                     dataclasses.replace(
                         base, block_h=bh, value_dtype="bfloat16"))
                )

        # ELLX (pure-XLA base-K ELL + overflow) — the scalar-free engine for
        # irregular matrices.  Candidate per block height; block counts per
        # row-block derive from the same unique-key arrays.
        ellx_units = {}
        for bh in (1, 8, 16):
            if bh == 1:
                k1 = coo.rows.astype(np.int64) * ncb + coo.cols // LANES
                uk = np.unique(k1)
                uk_rb = uk // ncb
            elif bh == 8:
                uk_rb = uk_rb8
            else:
                m = np.unique((uk_rb8 // 2) * ncb + uk_cb)
                uk_rb = m // ncb
            nrb = max(-(-R // bh), 1)
            counts = np.bincount(
                uk_rb.astype(np.int64), minlength=nrb
            )
            k = choose_k_base(counts, bh, p)
            base_b = nrb * k * (bh * LANES * 4 + 4)
            ov = int(np.maximum(counts - k, 0).sum())
            resident = base_b + ov * (bh * LANES * 4 + 16)
            ellx_units[bh] = (len(uk_rb), k, ov)
            if not self.model.fits(resident):
                continue
            if resident > 2000 * max(nnz, 1):
                continue
            t = self.model.ellx_seconds(base_b, ov, R, C)
            cands.append(
                (f"ellx{bh}", t, dataclasses.replace(base, block_h=bh))
            )
            if cr_gain and bh == 8:
                cnt_cr = np.bincount(
                    (uk8_cr // ncb).astype(np.int64), minlength=nrb
                )
                k_cr = choose_k_base(cnt_cr, bh, p)
                ov_cr = int(np.maximum(cnt_cr - k_cr, 0).sum())
                base_cr = nrb * k_cr * (bh * LANES * 4 + 4)
                if self.model.fits(base_cr):
                    cands.append((
                        "ellx8-cr",
                        self.model.ellx_seconds(base_cr, ov_cr, R, C),
                        dataclasses.replace(
                            base, block_h=bh, col_reorder=True
                        ),
                    ))

        # Split (hub rows/cols dense + ELLX body) — the load-balance
        # (HI crossbar) analog for power-law/arrowhead matrices.
        col_deg = np.bincount(coo.cols, minlength=C)
        r_pad8, c_pad = -(-R // 8) * 8, ncb * LANES
        thr_c = max(r_pad8 * 4.0 / p.body_bytes_per_nnz, 4.0)
        hub_c = np.nonzero(col_deg > thr_c)[0][:_MAX_HUBS]
        in_hc = np.zeros(C, bool)
        in_hc[hub_c] = True
        sel_hc = in_hc[coo.cols]
        row_deg = np.bincount(coo.rows[~sel_hc], minlength=R)
        thr_r = max(c_pad * 4.0 / p.body_bytes_per_nnz, 4.0)
        hub_r = np.nonzero(row_deg > thr_r)[0][:_MAX_HUBS]
        if len(hub_c) or len(hub_r):
            in_hr = np.zeros(R, bool)
            in_hr[hub_r] = True
            body_sel = ~sel_hc & ~in_hr[coo.rows]
            kc_pad = -(-max(len(hub_c), 1) // LANES) * LANES
            kr_pad = -(-max(len(hub_r), 1) // 8) * 8
            hub_b = (r_pad8 * kc_pad * 4 if len(hub_c) else 0) + (
                kr_pad * c_pad * 4 if len(hub_r) else 0
            )
            if body_sel.any():
                kb = (
                    coo.rows[body_sel].astype(np.int64) * ncb
                    + coo.cols[body_sel] // LANES
                )
                ukb = np.unique(kb)
                counts = np.bincount(ukb // ncb, minlength=R)
                k = choose_k_base(counts, 1, p)
                base_b = R * k * (LANES * 4 + 4)
                ov = int(np.maximum(counts - k, 0).sum())
                # routed body alternative (build_split_plan body="auto"
                # makes the same choice at plan time)
                if routed_vmem_ok(coo.shape, p):
                    bst = best_routed_estimate(
                        coo.rows[body_sel], coo.cols[body_sel], coo.shape,
                        profile=p,
                    )
                else:
                    bst = {"tiles": 0}
                t_rb = self.model.routed_seconds(
                    bst["est_ns"], bst["stream_bytes"], bst["residual"],
                    R, C,
                ) if bst["tiles"] else float("inf")
            else:
                base_b, ov, t_rb = 0, 0, float("inf")
            if self.model.fits(hub_b + base_b):
                t_eb = self.model.split_seconds(hub_b, base_b, ov, R, C)
                hub_t = hub_b / (p.hbm_gbps * 1e9 * p.dense_efficiency)
                t = min(t_eb, hub_t + t_rb + p.launch_overhead_s)
                cands.append(
                    ("split", t, dataclasses.replace(base, block_h=1))
                )

        # Routed stream (the crossbar-analog per-nnz format): cheap
        # macro-cell group estimate mirroring the v2 planner (plan/
        # routed.py::estimate_routed_cost_ns).  The estimate is within
        # ~1.4x of the built plan's modeled cost on structured classes,
        # ~2-4x optimistic on heavily scattered ones (conflict layers are
        # not modeled) — measure_candidates() resolves close calls.
        routed_fits_vmem = routed_vmem_ok(coo.shape, p)
        rst = best_routed_estimate(coo.rows, coo.cols, coo.shape, profile=p)
        if rst["tiles"] and routed_fits_vmem \
                and self.model.fits(rst["stream_bytes"]):
            t = self.model.routed_seconds(
                rst["est_ns"], rst["stream_bytes"], rst["residual"], R, C,
            )
            cands.append(("routed", t, base))

        # Rank-space routed (degree-sorted rows/cols + fast permute
        # sandwich): estimated on the ranked coordinates; pays two
        # permutation passes but concentrates power-law nnz into dense
        # low-layer tiles (plan/routed.py build_ranked_routed_plan).
        # Only worth evaluating when the matrix is irregular enough that
        # plain routed already carries real cost.
        if rst["tiles"] and routed_fits_vmem and rst["est_ns"] > 50e3:
            rrank, _ = degree_rank_perms(
                np.bincount(coo.rows, minlength=R)
            )
            crank, _ = degree_rank_perms(
                np.bincount(coo.cols, minlength=C)
            )
            rstr = best_routed_estimate(
                rrank[coo.rows.astype(np.int64)],
                crank[coo.cols.astype(np.int64)],
                coo.shape, profile=p,
            )
            if rstr["tiles"] and self.model.fits(rstr["stream_bytes"]):
                t = self.model.routed_seconds(
                    rstr["est_ns"], rstr["stream_bytes"],
                    rstr["residual"], R, C,
                ) + (
                    estimate_permute_cost_ns(C, p)
                    + estimate_permute_cost_ns(R, p)
                ) / 1e9
                cands.append((
                    "routed-rank", t,
                    dataclasses.replace(base, rank_sort=True),
                ))

        # Banded routed (x + y exceed VMEM, soc-Pokec scale): grid of
        # VMEM-feasible cells, rank-sorted so hubs concentrate top-left
        # (plan/routed.py build_banded_routed_plan) — the routed format's
        # y row-tiling answer (spmv-helper.cpp:139-263).
        if not routed_fits_vmem:
            rbd = estimate_banded_routed_ns(
                coo.rows, coo.cols, coo.shape, rank_sort=True, profile=p
            )
            if rbd["tiles"] and self.model.fits(rbd["stream_bytes"]):
                t = self.model.routed_seconds(
                    rbd["est_ns"], rbd["stream_bytes"],
                    rbd["residual"], R, C,
                ) + (
                    estimate_permute_cost_ns(C, p)
                    + estimate_permute_cost_ns(R, p)
                ) / 1e9
                cands.append((
                    "routed-rank", t,
                    dataclasses.replace(base, rank_sort=True),
                ))

        # Gather stream.
        P = base.num_pes
        thresh = base.split_threshold or derive_split_threshold(nnz, P)
        steps = estimate_stream_steps(coo.row_lengths(), P, thresh)
        if self.model.fits(self.model.stream_resident_bytes(steps, P)):
            cands.append(
                ("stream", self.model.stream_seconds(steps, P, R, C), base)
            )

        if not cands:
            raise RuntimeError("no candidate fits device memory")
        cands.sort(key=lambda c: c[1])
        # bf16 payloads round values to an 8-bit mantissa, which on general
        # real-valued matrices violates the reference's rtol=1e-3 acceptance
        # (general_test.py:106) — verified on hardware.  A bf16 candidate may
        # only WIN through measure_candidates(), whose accuracy guard
        # validates it against the golden result for this specific matrix;
        # the model-only pick is always a full-precision format.
        pickable = [c for c in cands if not c[0].endswith("-bf16")]
        label, secs, cfg = pickable[0]
        fmt = _label_format(label)
        return TuneResult(
            format=fmt,
            config=cfg,
            est_seconds=secs,
            est_gflops=flops / secs / 1e9,
            candidates=[(lbl, s) for lbl, s, _ in cands],
        )


def _measured_cache_load(path: str) -> dict:
    if path and os.path.exists(path):
        try:
            with open(path) as f:
                return json.load(f)
        except Exception:
            return {}
    return {}


def _measured_cache_put(path: str, key: str, entry: dict) -> None:
    if not path:
        return
    cache = _measured_cache_load(path)
    cache[key] = entry
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=1)
    os.replace(tmp, path)


def _shortlist(result: TuneResult, top: int) -> list:
    """The JAX tuner's shortlist: the ``top`` cheapest full-precision
    candidates, then the best of each other format family (routed and
    routed-rank count apart) within 2.5x of the best estimate, at most 4
    in all; plus the cheapest bf16 candidate when it models faster than
    the best."""
    fp32c = [c for c in result.candidates if not c[0].endswith("-bf16")]
    bf16c = [c for c in result.candidates if c[0].endswith("-bf16")]
    shortlist = list(fp32c[: max(top, 1)])
    if shortlist:
        def _fam(lbl):
            return "routed-rank" if lbl == "routed-rank" \
                else _label_format(lbl)

        best_est = shortlist[0][1]
        fams = {_fam(lbl) for lbl, _ in shortlist}
        for label, est in fp32c[max(top, 1):]:
            if len(shortlist) >= 4:
                break
            fam = _fam(label)
            if fam not in fams and est <= 2.5 * best_est:
                fams.add(fam)
                shortlist.append((label, est))
        if bf16c and bf16c[0][1] < best_est:
            shortlist.append(bf16c[0])
    return shortlist


def _candidate_config(label: str, base: SpmvConfig) -> SpmvConfig:
    """The config a candidate label stands for, from the model's pick."""
    fmt = _label_format(label)
    if label == "routed-rank":
        return dataclasses.replace(base, rank_sort=True)
    if label == "routed":
        return dataclasses.replace(base, rank_sort=False)
    if fmt in ("dense", "stream"):
        return base
    if fmt == "split":
        return dataclasses.replace(base, block_h=1)
    stem = label.replace("-bf16", "").replace("-cr", "")
    return dataclasses.replace(
        base, block_h=int("".join(c for c in stem if c.isdigit())),
        value_dtype="bfloat16" if label.endswith("-bf16") else "float32",
        col_reorder=label.endswith("-cr"),
    )


def measured_shortlist(result: TuneResult, top: int) -> list:
    """The candidates :func:`measure_candidates` times, in order: the
    shortlist's (label, estimate, format, config), each config once."""
    out, seen = [], set()
    for label, est in _shortlist(result, top):
        fmt = _label_format(label)
        cfg = _candidate_config(label, result.config)
        key = (fmt, cfg.block_h, cfg.value_dtype, cfg.rank_sort,
               cfg.col_reorder)
        if key not in seen:
            seen.add(key)
            out.append((label, est, fmt, cfg))
    return out


def measure_candidates(
    coo: COOMatrix, result: TuneResult, top: int = 2,
    cache_path: Optional[str] = None, device="cuda",
    profile: Optional[DeviceProfile] = None,
) -> TuneResult:
    """Refine the model's choice by timing the shortlisted candidates on
    ``device``.

    Each candidate is prepared as a port ``SpmvHandle`` on ``device``
    under ``profile`` (None: the device's, as the model's pick was) and
    timed with ``utils/timing.bench_spmv``; the fastest that passes the
    accuracy guard replaces the model's pick.  Each measurement is written
    through to ``cache_path + '.measured'`` as it completes, so a tune cut
    short resumes where it stopped.  A candidate that fails to build or to
    run is reported on stderr and cached as failed; it counts as final
    only once some candidate of the matrix has succeeded.
    """
    from hispmv_tpu_torch.api.handle import SpmvHandle

    if profile is None:
        profile = device_profile(device)
    mpath = (cache_path + ".measured") if cache_path else None
    mfp = matrix_fingerprint(coo)
    mcache = _measured_cache_load(mpath)

    # the benchmark's x distribution (standard normal), and its golden
    x0 = np.random.default_rng(0).standard_normal(
        coo.num_cols
    ).astype(np.float32)
    golden = coo.matvec(x0.astype(np.float64))
    measured = []
    for label, est, fmt, cfg in measured_shortlist(result, top):
        mkey = f"{mfp}:{profile.name}:{label}"
        hit = mcache.get(mkey)
        if hit is not None:
            if hit.get("t") is not None:
                measured.append((label, hit["t"], fmt, cfg))
                continue
            if any(
                k.startswith(mfp + ":") and v.get("t") is not None
                for k, v in mcache.items()
            ):
                continue
        try:
            h = SpmvHandle(coo, config=cfg, format=fmt, device=device,
                           profile=profile)
            t, y = bench_spmv(h, x0)
            del h
            # accuracy guard: f32 formats may miss rtol 1e-3 on at most
            # 1e-4 of the rows (fp32 cancellation on huge rows); bf16
            # payloads on none
            bad = np.abs(y - golden) > (1e-4 + 1e-3 * np.abs(golden))
            allow = 0 if label.endswith("-bf16") else max(
                int(1e-4 * len(golden)), 8
            )
            if bad.sum() > allow:
                print(
                    f"tune: candidate {label} failed accuracy "
                    f"({int(bad.sum())} mismatches), discarded",
                    file=sys.stderr, flush=True,
                )
                _measured_cache_put(
                    mpath, mkey,
                    {"t": None, "err": f"accuracy:{int(bad.sum())}"},
                )
                continue
            measured.append((label, t, fmt, cfg))
            _measured_cache_put(mpath, mkey, {"t": t})
        except Exception as e:
            print(
                f"tune: candidate {label} failed to measure: {e!r}",
                file=sys.stderr, flush=True,
            )
            traceback.print_exc(limit=4)
            _measured_cache_put(mpath, mkey, {"t": None, "err": repr(e)[:200]})
            continue
    if not measured:
        return result
    measured.sort(key=lambda m: m[1])
    label, secs, fmt, cfg = measured[0]
    # Sanity floor: a measured winner more than 4x slower than the model's
    # estimate for a model-best family that was never measured means the
    # real winner's measurement failed; the model's pick stands (and the
    # result stays unmeasured, so a later measured tune retries it).
    model_family_measured = any(m[2] == result.format for m in measured)
    if (
        secs > 4.0 * result.est_seconds
        and result.format != fmt
        and not model_family_measured
    ):
        return result
    flops = 2 * (coo.nnz + coo.shape[0])
    done = {m[0] for m in measured}
    return TuneResult(
        format=fmt,
        config=cfg,
        est_seconds=secs,
        est_gflops=flops / secs / 1e9,
        candidates=[(lbl, s) for lbl, s, _, _ in measured]
        + [(lbl, s) for lbl, s in result.candidates if lbl not in done],
        measured=True,
        n_measured=len(measured),
    )


def tune(
    coo: COOMatrix,
    cache_path: Optional[str] = None,
    profile: Optional[DeviceProfile] = None,
    measure: int = 0,
    device="cuda",
) -> TuneResult:
    """DSE with a persistent JSON cache keyed by matrix fingerprint and
    the profile's name and values (``tune.cost.profile_key``).

    ``profile`` None takes ``device``'s (``device_profile``: ``H100`` on
    the card, ``V5E`` on the CPU).
    ``measure > 1`` also times the shortlist (``measure`` cheapest and the
    close families) on ``device`` and picks the measured winner; measured
    entries serve every later call, model-only ones are re-run when a
    caller asks for measurement.  The model-only search touches no
    device."""
    if profile is None:
        profile = device_profile(device)
    key = None
    if cache_path:
        key = (f"{matrix_fingerprint(coo)}:{profile.name}:"
               f"{profile_key(profile)}")
        if os.path.exists(cache_path):
            with open(cache_path) as f:
                entry = json.load(f).get(key)
            if entry is not None:
                cached = TuneResult.from_json(entry)
                if cached.measured or measure <= 1:
                    return cached
    result = DSE(profile).explore(coo)
    if measure > 1:
        result = measure_candidates(
            coo, result, top=measure, cache_path=cache_path, device=device,
            profile=profile,
        )
    if key:
        cache = {}
        if os.path.exists(cache_path):
            with open(cache_path) as f:
                cache = json.load(f)
        cache[key] = result.to_json()
        tmp = cache_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=1)
        os.replace(tmp, cache_path)
    return result
