"""B4 (the x- and y-paneled chunked stream) and the block handle's layout
dispatch in the port against the JAX package.

``pack_chunks_tiled`` gives identical arrays; the plain PyTorch version of
the kernel matches ``spmv_chunked_tiled_pallas`` in interpret mode on the
same arrays, with small panels so that a matrix has several of each, for
f32 and bf16 payloads.  With the JAX handle's class constants patched and
the same values in the port's profile (``V5E`` with its budgets replaced),
the port's ``SpmvHandle`` picks the JAX handle's layout (chunked,
x-paneled or tiled) and ``linear`` kernel (B2 or B6), and gives its y.

Port against JAX: rtol=1e-5, atol=1e-5*max(1, max|y|) (fp32 accumulation on
both sides, only the order of summation differs).  Against the float64
golden: rtol=1e-3."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import small_matrix_cases

import hispmv_tpu.api.handle as jhandle_mod
import hispmv_tpu_torch.api.handle as handle_mod
from hispmv_tpu.api.handle import SpmvHandle as JSpmvHandle
from hispmv_tpu.config import SpmvConfig as JSpmvConfig
from hispmv_tpu.ops.spmv_chunked import pack_chunks_tiled as jpack_chunks_tiled
from hispmv_tpu.ops.spmv_chunked import spmv_chunked_tiled_pallas
from hispmv_tpu.plan.blocks import build_block_plan as jbuild_block_plan
from hispmv_tpu_torch.api.handle import SpmvHandle
from hispmv_tpu_torch.config import SpmvConfig
from hispmv_tpu_torch.formats.matrix import COOMatrix
from hispmv_tpu_torch.formats.synth import banded_coo, random_coo
from hispmv_tpu_torch.ops.spmv_chunked import (
    pack_chunks_tiled,
    spmv_chunked_tiled,
    spmv_chunked_tiled_plain,
    tiled_sector_mask,
)
from hispmv_tpu_torch.plan.blocks import build_block_plan
from hispmv_tpu_torch.tune.cost import V5E

CHUNK = 16
CASES = list(small_matrix_cases())
# (panel_ncb, panel_nrb): several x and y panels on the small cases
PANELS = [(2, 8), (4, 16), (3, 40)]


def _empty_row_panel():
    """Nonzeros in rows 0-127 and 256-383 only: with bh 8 and panel_nrb 16,
    row panel 1 holds only the planner's zero placeholder blocks, which
    :func:`_plans` drops, so that no chunk visits it."""
    rng = np.random.default_rng(40)
    rows = np.concatenate([rng.integers(0, 128, 400),
                           rng.integers(256, 384, 400)])
    cols = rng.integers(0, 1200, 800)
    k = np.unique(rows.astype(np.int64) * 1200 + cols)
    vals = rng.standard_normal(len(k)).astype(np.float32)
    return COOMatrix((384, 1200), k // 1200, k % 1200, vals)


@functools.lru_cache(maxsize=None)
def _case(name):
    if name == "empty_row_panel":
        return _empty_row_panel()
    if name == "banded_big":  # several x and y panels at (4, 16)
        return banded_coo(3000, 3000, 30_000, seed=50)
    return small_matrix_cases()[name]


def _drop_row_blocks(plan, lo, hi):
    keep = (plan.block_rows < lo) | (plan.block_rows >= hi)
    assert not plan.data[~keep].any()
    return dataclasses.replace(
        plan, data=plan.data[keep], block_rows=plan.block_rows[keep],
        block_cols=plan.block_cols[keep],
        block_firsts=plan.block_firsts[keep],
        block_lasts=plan.block_lasts[keep])


def _plans(name):
    """The port's and the JAX package's BlockPlan of case ``name``."""
    coo = _case(name)
    plan, jplan = build_block_plan(coo, 8), jbuild_block_plan(coo, 8)
    if name == "empty_row_panel":
        plan, jplan = (_drop_row_blocks(p, 16, 32) for p in (plan, jplan))
    return coo, plan, jplan


def assert_close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float64)
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _x2d(plan, panel_ncb, seed=0):
    npanels = -(-plan.num_col_blocks // panel_ncb)
    x = np.zeros(npanels * panel_ncb * 128, np.float32)
    x[: plan.shape[1]] = np.random.default_rng(seed).standard_normal(
        plan.shape[1])
    return x.reshape(-1, 128)


@pytest.mark.parametrize("panels", PANELS)
@pytest.mark.parametrize("name", CASES + ["empty_row_panel", "banded_big"])
def test_pack_chunks_tiled_equal(name, panels):
    _, plan, jplan = _plans(name)
    got = pack_chunks_tiled(plan, CHUNK, *panels)
    want = jpack_chunks_tiled(jplan, CHUNK, *panels)
    assert got[5] == want[5]
    for a, b in zip(got[:5], want[:5]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_empty_row_panel_case_skips_a_panel():
    _, plan, _ = _plans("empty_row_panel")
    _, _, _, ypanels, yfirst, _ = pack_chunks_tiled(plan, CHUNK, 4, 16)
    assert sorted(np.unique(ypanels)) == [0, 2]
    assert yfirst.sum() == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("panels", [(2, 8), (4, 16)])
@pytest.mark.parametrize("name", ["banded_big", "empty_row_panel", "wide",
                                  "single_dense_row", "tall", "tiny"])
def test_plain_b4_matches_pallas(name, panels, dtype):
    panel_ncb, panel_nrb = panels
    coo, plan, jplan = _plans(name)
    data3d, meta, xp, yp, _, _ = pack_chunks_tiled(plan, CHUNK, *panels)
    jarrays = jpack_chunks_tiled(jplan, CHUNK, *panels, dtype=dtype)
    tdata = torch.from_numpy(data3d)
    if dtype == "bfloat16":
        tdata = tdata.to(torch.bfloat16)
    np.testing.assert_array_equal(tdata.float().numpy(),
                                  np.asarray(jarrays[0], np.float32))
    npy = -(-plan.num_row_blocks // panel_nrb)
    x2d = _x2d(plan, panel_ncb)
    y = spmv_chunked_tiled_plain(
        tdata, torch.from_numpy(meta), torch.from_numpy(xp),
        torch.from_numpy(yp), torch.from_numpy(x2d), npy, panel_nrb, 8,
        CHUNK, panel_ncb)
    jy = spmv_chunked_tiled_pallas(
        *(jnp.asarray(a) for a in jarrays[:5]), jnp.asarray(x2d), npy,
        panel_nrb, 8, CHUNK, panel_ncb, interpret=True)
    assert y.shape == (npy * panel_nrb, 8)
    # the TPU leaves row panels that no chunk visits unwritten; the port
    # gives zeros there
    visited = np.zeros(npy, bool)
    visited[np.unique(yp)] = True
    rows = np.repeat(visited, panel_nrb)
    assert_close(y.numpy()[rows], np.asarray(jy)[rows])
    assert not y.numpy()[~rows].any()
    if dtype == "float32":
        want = coo.to_scipy() @ x2d.reshape(-1)[: coo.num_cols].astype(
            np.float64)
        assert_close(y.numpy().reshape(-1)[: coo.num_rows], want, rtol=1e-3)


def _tensors(panels=(4, 16)):
    plan = build_block_plan(_case("banded_big"), 8)
    data3d, meta, xp, yp, _, _ = pack_chunks_tiled(plan, CHUNK, *panels)
    npy = -(-plan.num_row_blocks // panels[1])
    return (torch.from_numpy(data3d), torch.from_numpy(meta),
            torch.from_numpy(xp), torch.from_numpy(yp),
            torch.from_numpy(_x2d(plan, panels[0])), npy, panels[1], 8,
            CHUNK, panels[0])


def test_banded_big_has_several_panels_of_each():
    _, _, xp, yp, *_ = _tensors()
    assert len(np.unique(xp.numpy())) >= 4
    assert len(np.unique(yp.numpy())) >= 4


def test_wrapper_on_cpu_takes_plain_version():
    args = _tensors()
    before = spmv_chunked_tiled.launches
    torch.testing.assert_close(spmv_chunked_tiled(*args),
                               spmv_chunked_tiled_plain(*args), rtol=0,
                               atol=0)
    assert spmv_chunked_tiled.launches == before


def test_wrapper_rejects_bad_arguments():
    data, meta, xp, yp, x2d, npy, pnrb, bh, chunk, pncb = _tensors()
    with pytest.raises(ValueError):
        spmv_chunked_tiled(data, meta, xp[1:], yp, x2d, npy, pnrb, bh, chunk,
                           pncb)
    with pytest.raises(ValueError):
        spmv_chunked_tiled(data, meta, xp, yp.long(), x2d, npy, pnrb, bh,
                           chunk, pncb)
    with pytest.raises(ValueError):
        spmv_chunked_tiled(data, meta, xp, yp, x2d, npy, 0, bh, chunk, pncb)
    with pytest.raises(TypeError):
        spmv_chunked_tiled(data.double(), meta, xp, yp, x2d, npy, pnrb, bh,
                           chunk, pncb)


def test_wrapper_off_cpu_never_takes_plain_version():
    data, meta, xp, yp, x2d, *rest = _tensors()
    on_meta = [t.to("meta") for t in (data, meta, xp, yp, x2d)]
    with pytest.raises(ValueError, match="no kernel"):
        spmv_chunked_tiled(*on_meta, *rest)


# ---------------------------------------------------------------------------
# The handle's layout dispatch and linear rule
# ---------------------------------------------------------------------------

# class constants per layout on HANDLE_COO (5000 x 20000, bh 8, chunk 256:
# x 157 col blocks, y 625 row blocks; two chunk buffers are 2 MiB)
LAYOUTS = {
    "chunked": {},
    "paneled": {"_CHUNKED_VMEM_BUDGET": 2 * 2**20 + 48 * 1024,
                "_PANEL_NCB": 8},
    "tiled": {"_CHUNKED_VMEM_BUDGET": 64 * 1024, "_PANEL_NCB": 16,
              "_PANEL_Y_BYTES": 8 * 1024},
}


@functools.lru_cache(maxsize=None)
def _handle_coo():
    return banded_coo(5000, 20_000, 60_000, seed=52)


# the port's profile field of each JAX class constant; the JAX handle's
# one budget also rules its B2/B6 choice, the port's batched_budget_bytes
PROFILE_FIELDS = {"_CHUNKED_VMEM_BUDGET": ("chunked_budget_bytes",
                                           "batched_budget_bytes"),
                  "_PANEL_NCB": ("panel_ncb",),
                  "_PANEL_Y_BYTES": ("panel_y_bytes",)}


def _patch(monkeypatch, consts):
    """Set ``consts`` on the JAX handle's class; returns ``V5E`` with the
    same values, the port handle's profile."""
    for k, v in consts.items():
        monkeypatch.setattr(JSpmvHandle, k, v)
    return dataclasses.replace(V5E, **{
        f: v for k, v in consts.items() for f in PROFILE_FIELDS[k]})


def _layout(h):
    return [name for name in ("chunked", "paneled", "tiled")
            if getattr(h, "_" + name)]


def _record(monkeypatch, module, names, seen):
    for n in names:
        fn = getattr(module, n)

        def rec(*a, _fn=fn, _n=n, **kw):
            seen.append(_n)
            return _fn(*a, **kw)
        monkeypatch.setattr(module, n, rec)


@pytest.mark.parametrize("col_reorder", [False, True])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_handle_layout_and_run_match_jax(layout, col_reorder, monkeypatch):
    coo = _handle_coo()
    profile = _patch(monkeypatch, LAYOUTS[layout])
    h = SpmvHandle(coo, SpmvConfig(col_reorder=col_reorder), "block",
                   device="cpu", profile=profile)
    jh = JSpmvHandle(coo, JSpmvConfig(col_reorder=col_reorder), "block",
                     interpret=True)
    assert _layout(h) == _layout(jh) == [layout]
    assert h.padded_cols == jh.padded_cols
    assert sorted(h._d) == sorted(jh._d)
    for k in h._d:
        np.testing.assert_array_equal(h._d[k].numpy(), np.asarray(jh._d[k]))
    x = np.random.default_rng(53).standard_normal(coo.num_cols).astype(
        np.float32)
    y = h.run(x).numpy()
    assert_close(y, np.asarray(jh.run(x))[: coo.num_rows])
    assert_close(y, coo.matvec(x.astype(np.float64)), rtol=1e-3)


@pytest.mark.parametrize("col_reorder", [False, True])
@pytest.mark.parametrize("layout,batch_budget,want", [
    ("chunked", None, "B2"),
    ("chunked", 2 * 2**20 + 1024, "B6"),  # built chunked, batch too large
    ("paneled", None, "B6"),
    ("tiled", None, "B6"),
])
def test_handle_linear_kernel_matches_jax(layout, batch_budget, want,
                                          col_reorder, monkeypatch):
    coo = _handle_coo()
    profile = _patch(monkeypatch, LAYOUTS[layout])
    h = SpmvHandle(coo, SpmvConfig(col_reorder=col_reorder), "block",
                   device="cpu", profile=profile)
    jh = JSpmvHandle(coo, JSpmvConfig(col_reorder=col_reorder), "block",
                     interpret=True)
    if batch_budget is not None:
        h.profile = _patch(monkeypatch, {"_CHUNKED_VMEM_BUDGET": batch_budget})
    seen, jseen = [], []
    _record(monkeypatch, handle_mod,
            ["spmv_chunked_batched", "spmv_block_batched"], seen)
    _record(monkeypatch, jhandle_mod,
            ["spmv_chunked_batched_pallas", "spmv_block_batched_pallas"],
            jseen)
    B = 3
    xb = np.random.default_rng(54).standard_normal(
        (B, coo.num_cols)).astype(np.float32)
    bias = np.random.default_rng(55).standard_normal(coo.num_rows).astype(
        np.float32)
    y = h.linear(xb, bias).numpy()
    jy = np.asarray(jh.linear(xb, bias))
    names = {"spmv_chunked_batched": "B2", "spmv_block_batched": "B6",
             "spmv_chunked_batched_pallas": "B2",
             "spmv_block_batched_pallas": "B6"}
    assert [names[n] for n in seen] == [names[n] for n in jseen] == [want]
    assert (h._batch_d is None) == (want == "B2")
    assert_close(y, jy)
    golden = (coo.to_scipy() @ xb.astype(np.float64).T).T + bias
    assert_close(y, golden, rtol=1e-3)


@pytest.mark.parametrize("block_h", [8, 64])
@pytest.mark.parametrize("batch_budget,want", [(None, "B2"), (0, "B6")])
def test_bf16_block_linear_matches_jax(block_h, batch_budget, want,
                                       monkeypatch):
    """A bf16 block handle's ``linear``: B2 reads the bf16 payload, B6 the
    plan's f32 values (as the JAX handle uploads them), in both packages."""
    coo = _handle_coo()
    cfg = dict(block_h=block_h, value_dtype="bfloat16")
    h = SpmvHandle(coo, SpmvConfig(**cfg), "block", device="cpu",
                   profile=V5E)
    jh = JSpmvHandle(coo, JSpmvConfig(**cfg), "block", interpret=True)
    if batch_budget is not None:
        h.profile = _patch(monkeypatch,
                           {"_CHUNKED_VMEM_BUDGET": batch_budget})
    seen = []
    _record(monkeypatch, handle_mod,
            ["spmv_chunked_batched", "spmv_block_batched"], seen)
    xb = np.random.default_rng(56).standard_normal(
        (3, coo.num_cols)).astype(np.float32)
    y = h.linear(xb).numpy()
    assert seen == [{"B2": "spmv_chunked_batched",
                     "B6": "spmv_block_batched"}[want]]
    assert_close(y, np.asarray(jh.linear(xb)))
    vals = coo.values
    if want == "B2":
        vals = torch.from_numpy(vals).to(torch.bfloat16).float().numpy()
    a = COOMatrix(coo.shape, coo.rows, coo.cols, vals).to_scipy()
    assert_close(y, (a @ xb.astype(np.float64).T).T, rtol=1e-3)


def test_paneled_path_satisfiable_with_shipped_constants():
    """The port's mirror of the JAX handle's reachability check: the
    paneled layout fires without patching for a 200k x 5.1M matrix."""
    h = SpmvHandle.__new__(SpmvHandle)
    h.config = SpmvConfig()
    h.profile = V5E

    class FakePlan:
        block_h = 8
        num_row_blocks = 25_000  # 200k rows: resident y = 0.8 MiB
        num_col_blocks = 40_000  # 5.1M cols: x alone would blow the budget

    assert not h._block_fits_chunked(FakePlan())
    assert h._block_fits_paneled(FakePlan())


def test_shipped_constants_tile_a_large_square_matrix():
    """With the JAX values, a square block matrix past ~1.05M rows is
    neither chunked nor paneled: it takes B4."""
    h = SpmvHandle.__new__(SpmvHandle)
    h.profile = V5E

    class FakePlan:
        block_h = 8
        num_row_blocks = 1_100_000 // 8
        num_col_blocks = 1_100_000 // 128

    assert not h._block_fits_chunked(FakePlan())
    assert not h._block_fits_paneled(FakePlan())
    assert SpmvHandle._panel_nrb(h, 8) == 32768


def test_random_matrix_packs_alike_in_both_layouts(monkeypatch):
    """One matrix packed chunked and tiled gives one product."""
    coo = random_coo(700, 9000, 20_000, seed=56)
    x = np.random.default_rng(57).standard_normal(9000).astype(np.float32)
    y_chunked = SpmvHandle(coo, format="block", device="cpu").run(x)
    h = SpmvHandle(coo, format="block", device="cpu",
                   profile=_patch(monkeypatch, LAYOUTS["tiled"]))
    assert h._tiled
    assert_close(h.run(x).numpy(), y_chunked.numpy())


# ---------------------------------------------------------------------------
# B4's sector mask: one 16-bit word a payload row, bit g for lanes 8g..8g+7
# ---------------------------------------------------------------------------


def _mask_numpy(payload):
    """The sector mask of ``payload`` f32 [nchunks, rows, 128], bit by bit
    in numpy, as int16."""
    nz = (payload != 0).reshape(*payload.shape[:2], 16, 8).any(-1)
    words = np.zeros(payload.shape[:2], np.uint16)
    for g in range(16):
        words |= nz[..., g].astype(np.uint16) << np.uint16(g)
    return words.view(np.int16)


def _payload(name, dtype, panels=(4, 16)):
    """(plan, packed arrays, uploaded payload tensor) of case ``name``."""
    _, plan, _ = _plans(name)
    arrays = pack_chunks_tiled(plan, CHUNK, *panels)
    tdata = torch.from_numpy(arrays[0])
    if dtype == "bfloat16":
        tdata = tdata.to(torch.bfloat16)
    return plan, arrays, tdata


def _lane_live(mask):
    """bool [.., 128]: the lanes whose granule's bit is set."""
    words = mask.astype(np.int32) & 0xFFFF
    return ((words[..., None] >> (np.arange(128) // 8)) & 1).astype(bool)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CASES + ["banded_big"])
def test_tiled_sector_mask_equals_numpy(name, dtype):
    _, arrays, tdata = _payload(name, dtype)
    got = tiled_sector_mask(tdata, 8)
    assert got.dtype == torch.int16
    assert got.shape == tdata.shape[:2]
    np.testing.assert_array_equal(got.numpy(),
                                  _mask_numpy(tdata.float().numpy()))
    # under 1% of the payload's bytes
    assert got.nbytes * 100 < tdata.nbytes


@pytest.mark.parametrize("name", CASES + ["empty_row_panel", "banded_big"])
def test_sector_mask_covers_every_nonzero_and_no_padding(name):
    _, plan, _ = _plans(name)
    panel_ncb, panel_nrb = 4, 16
    data3d, *_ = pack_chunks_tiled(plan, CHUNK, panel_ncb, panel_nrb)
    mask = tiled_sector_mask(torch.from_numpy(data3d), 8).numpy()
    live = _lane_live(mask)
    assert live[data3d != 0].all()  # every nonzero lane is read
    assert (data3d[live].reshape(-1) != 0).any()
    # padding: the blocks past each (row panel, col panel) segment's count
    key = (plan.block_rows // panel_nrb).astype(np.int64) * 10**6 \
        + plan.block_cols // panel_ncb
    counts = np.unique(key, return_counts=True)[1]
    pad = np.concatenate([np.arange(-(-n // CHUNK) * CHUNK) >= n
                          for n in counts])
    assert pad.size == data3d.shape[0] * CHUNK
    block_mask = mask.reshape(-1, 8)
    assert not block_mask[pad].any()
    if name == "banded_big":
        assert pad.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["banded_big", "empty_row_panel", "wide",
                                  "single_dense_row"])
def test_plain_b4_with_sector_mask_equals_unmasked_and_pallas(name, dtype):
    panel_ncb, panel_nrb = 4, 16
    _, plan, jplan = _plans(name)
    _, arrays, tdata = _payload(name, dtype, (panel_ncb, panel_nrb))
    _, meta, xp, yp, _, _ = arrays
    npy = -(-plan.num_row_blocks // panel_nrb)
    x2d = _x2d(plan, panel_ncb, seed=1)
    args = (tdata, torch.from_numpy(meta), torch.from_numpy(xp),
            torch.from_numpy(yp), torch.from_numpy(x2d), npy, panel_nrb, 8,
            CHUNK, panel_ncb)
    mask = tiled_sector_mask(tdata, 8)
    y = spmv_chunked_tiled_plain(*args, mask)
    torch.testing.assert_close(y, spmv_chunked_tiled_plain(*args), rtol=0,
                               atol=0)
    jarrays = jpack_chunks_tiled(jplan, CHUNK, panel_ncb, panel_nrb,
                                 dtype=dtype)
    jy = spmv_chunked_tiled_pallas(
        *(jnp.asarray(a) for a in jarrays[:5]), jnp.asarray(x2d), npy,
        panel_nrb, 8, CHUNK, panel_ncb, interpret=True)
    rows = np.repeat(np.isin(np.arange(npy), yp), panel_nrb)
    assert_close(y.numpy()[rows], np.asarray(jy)[rows])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_b4_skips_a_cleared_granule(dtype):
    """With one needed bit cleared, the plain B4 gives exactly its answer
    on the payload with that granule zeroed."""
    data, *rest = _tensors()
    data = data.to(dtype)
    mask = tiled_sector_mask(data, 8)
    c, r = (int(v[0]) for v in torch.nonzero(mask, as_tuple=True))
    word = int(mask[c, r]) & 0xFFFF
    g = (word & -word).bit_length() - 1  # its lowest set bit
    assert data[c, r, 8 * g: 8 * g + 8].any()  # the bit is needed
    word &= ~(1 << g)
    cleared = mask.clone()
    cleared[c, r] = word - (1 << 16) if word >= 1 << 15 else word
    zeroed = data.clone()
    zeroed[c, r, 8 * g: 8 * g + 8] = 0
    y = spmv_chunked_tiled_plain(data, *rest, cleared)
    torch.testing.assert_close(
        y, spmv_chunked_tiled_plain(zeroed, *rest,
                                    tiled_sector_mask(zeroed, 8)),
        rtol=0, atol=0)
    torch.testing.assert_close(y, spmv_chunked_tiled_plain(zeroed, *rest),
                               rtol=0, atol=0)
    assert not torch.equal(y, spmv_chunked_tiled_plain(data, *rest, mask))


def test_wrapper_on_cpu_with_sector_mask_takes_plain_version():
    args = _tensors()
    mask = tiled_sector_mask(args[0], 8)
    before = spmv_chunked_tiled.launches
    torch.testing.assert_close(spmv_chunked_tiled(*args, sector_mask=mask),
                               spmv_chunked_tiled_plain(*args, mask),
                               rtol=0, atol=0)
    assert spmv_chunked_tiled.launches == before


@pytest.mark.parametrize("bad", ["dtype", "rows", "flat", "chunks"])
def test_wrapper_rejects_bad_sector_mask(bad):
    args = _tensors()
    mask = tiled_sector_mask(args[0], 8)
    wrong = {"dtype": mask.to(torch.int32), "rows": mask[:, 1:],
             "flat": mask.reshape(-1), "chunks": mask[1:]}[bad]
    with pytest.raises(ValueError, match="sector_mask"):
        spmv_chunked_tiled(*args, sector_mask=wrong)


def test_sector_mask_rejects_a_payload_of_another_block_height():
    with pytest.raises(ValueError, match="tiled_sector_mask"):
        tiled_sector_mask(torch.zeros(2, 12, 128), 8)


@pytest.mark.parametrize("col_reorder", [False, True])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_handle_holds_sector_mask_of_tiled_layout_only(layout, col_reorder,
                                                       monkeypatch):
    """The tiled handle keeps B4's mask outside its device dict, which stays
    the JAX handle's, counts its bytes in ``device_bytes`` and passes it to
    B4 on every ``run``; the other layouts hold none."""
    coo = _handle_coo()
    profile = _patch(monkeypatch, LAYOUTS[layout])
    h = SpmvHandle(coo, SpmvConfig(col_reorder=col_reorder), "block",
                   device="cpu", profile=profile)
    jh = JSpmvHandle(coo, JSpmvConfig(col_reorder=col_reorder), "block",
                     interpret=True)
    assert sorted(h._d) == sorted(jh._d)
    extra = 0
    if layout == "tiled":
        m = h._sector_mask
        assert m.dtype == torch.int16
        assert m.shape == h._d["data"].shape[:2]
        torch.testing.assert_close(m, tiled_sector_mask(h._d["data"], 8),
                                   rtol=0, atol=0)
        extra = m.nbytes
    else:
        assert h._sector_mask is None
    assert h.device_bytes == jh.device_bytes + extra
    assert h.stats.device_bytes == h.device_bytes
    seen = []

    def rec(*a, **kw):
        seen.append(a[10] if len(a) > 10 else kw.get("sector_mask"))
        return spmv_chunked_tiled(*a, **kw)
    monkeypatch.setattr(handle_mod, "spmv_chunked_tiled", rec)
    x = np.random.default_rng(58).standard_normal(coo.num_cols).astype(
        np.float32)
    y = h.run(x).numpy()
    assert len(seen) == (layout == "tiled")
    if seen:
        assert seen[0] is h._sector_mask
    assert_close(y, coo.matvec(x.astype(np.float64)), rtol=1e-3)
