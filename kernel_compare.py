#!/usr/bin/env python3
"""Times B2 (``spmv_chunked_batched``) and B8 (``spmv_windowed_batched``)
on their cases of ``chip_smoke.py`` in the checkout it runs from, so that
two trees can be compared on one card in one run: copy this file to the root
of each checkout and run it there, the trees in turns (parent, change,
change, parent).

    python3 kernel_compare.py LABEL

B2's cases: TSOPF_RS_b2383's block handle at B 8 and 64 and trans5's ELLX
overflow at B 8.  B8's: crystk03's window handle (format auto) at B 64 and
the MLP's fc3 (the full-width model of ``chip_smoke.py``, seed 0) on fc2's
activations at B 64 and on the first of them alone (B 1).  Suite stand-ins
at scale 1.0, seed 0; x from a seeded generator.  B8 takes x vector-minor,
``xt [nwin*8, 128, B]``, or in a checkout that still has ``pack_batch_x``,
x packed [nwin*8, B*128]; the script passes whichever the checkout's
wrapper takes.  Per case it prints
the kernel's device busy time (torch.profiler, over 20 calls), its bound,
and its agreement with the plain version; where the wrapper takes ``vpt``,
also the time at V 4 and 8.  Exits 1 when a case disagrees, 2 without a
CUDA card."""

import sys

import numpy as np
import torch

import chip_smoke as cs
from hispmv_tpu_torch import Accelerator, SpmvConfig, prepare
from hispmv_tpu_torch.formats.synth import suite_matrix
from hispmv_tpu_torch.models import AcceleratorLayerManager, ThreeLayerFCModel
from hispmv_tpu_torch.ops import spmv_chunked as sc
from hispmv_tpu_torch.ops import spmv_windowed as sw


def b2_cases(rng):
    """(label, kernel name, args) of B2's three cases."""
    handles = {
        "TSOPF_RS_b2383": prepare(suite_matrix("TSOPF_RS_b2383", 1.0,
                                               seed=cs.SEED), SpmvConfig(),
                                  "block"),
        "trans5": prepare(suite_matrix("trans5", 1.0, seed=cs.SEED),
                          SpmvConfig(), "auto"),
    }
    cases = []
    for name, B, ov in (("TSOPF_RS_b2383", 8, ""), ("TSOPF_RS_b2383", 64, ""),
                        ("trans5", 8, "o")):
        h = handles[name]
        xb = h._pad_x(torch.from_numpy(rng.standard_normal(
            (B, h.shape[1])).astype(np.float32)).cuda())
        nrb = (h.plan.overflow if ov else h.plan).num_row_blocks
        cases.append((
            f"B2 [{name}{' ELLX overflow' if ov else ''}, B {B}]",
            "spmv_chunked_batched",
            (h._d[ov + "data"], h._d[ov + "meta"],
             xb.T.reshape(-1, 128, B).contiguous(), nrb, h.plan.block_h,
             h._chunk)))
    return cases


def b8_x(xb, num_windows):
    """The checkout's B8 x for the padded batch ``xb`` [B, nwin*1024]."""
    if hasattr(sw, "pack_batch_x"):  # x packed [nwin*8, B*128]
        return sw.pack_batch_x(xb, num_windows)
    return xb.T.reshape(-1, 128, xb.shape[0]).contiguous()


def b8_cases(rng):
    """(label, kernel name, args) of B8's three cases."""
    h = prepare(suite_matrix("crystk03", 1.0, seed=cs.SEED), SpmvConfig(),
                "auto")
    runs = [("crystk03", h, h._pad_x(torch.from_numpy(rng.standard_normal(
        (cs.BATCH, h.shape[1])).astype(np.float32)).cuda()))]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    model = ThreeLayerFCModel(cs.MLP["input"], hidden=cs.MLP["hidden"],
                              out=cs.MLP["out"], density=cs.MLP["density"],
                              generator=gen, device="cuda")
    accel = AcceleratorLayerManager(Accelerator()).replace_layers(model)
    (h1, b1), (h2, b2), (h3, _) = accel.layers
    x = torch.from_numpy(np.random.default_rng(cs.SEED + 3).standard_normal(
        (cs.BATCH, cs.MLP["input"])).astype(np.float32)).cuda()
    xb = h3._pad_x(torch.relu(h2.linear(torch.relu(h1.linear(x, b1)), b2)))
    label = f"MLP fc3 {h3.shape[0]}x{h3.shape[1]}"
    runs += [(label, h3, xb), (label, h3, xb[:1].contiguous())]
    cases = []
    for label, h, xb in runs:
        if h.format != "window":
            raise SystemExit(f"kernel_compare: {label} runs as {h.format}, "
                             "not window")
        p = h.plan
        cases.append((
            f"B8 [{label}, bh {p.block_h}, B {xb.shape[0]}]",
            "spmv_windowed_batched",
            (h._d["data"], h._d["subidx"], h._d["meta"],
             b8_x(xb, p.num_windows), p.num_row_blocks, p.block_h,
             h._wchunk)))
    return cases


def main(label: str) -> int:
    if not torch.cuda.is_available():
        print("kernel_compare: needs a CUDA card", file=sys.stderr)
        return 2
    rng = np.random.default_rng(cs.SEED)
    takes_vpt = {"spmv_chunked_batched": hasattr(sc, "chunked_batched_grid"),
                 "spmv_windowed_batched": hasattr(sw,
                                                  "windowed_batched_grid")}
    ok = True
    for tag, name, args in b2_cases(rng) + b8_cases(rng):
        kern, plain = cs.KERNELS[name]["wrapper"], cs.PLAIN[name]
        y = kern(*args)
        agree, _, line = cs._agree(name, y, plain(*args))
        ok &= agree
        bound, by = cs.kernel_bound(name, args, {}, y)
        busy = cs.device_ms(lambda: kern(*args))
        msg = (f"{label} {tag}: device busy {cs._ms(busy)}, bound "
               f"{bound:.4f} ms ({by}), {line}, {'ok' if agree else 'FAIL'}")
        if takes_vpt[name]:
            for vpt in (4, 8):
                t = cs.device_ms(lambda: kern(*args, vpt=vpt))
                msg += f"; V {vpt} {cs._ms(t)}"
        print(msg, flush=True)
    print(f"{label} {cs.gpu_line()}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "tree"))
