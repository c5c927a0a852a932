#!/usr/bin/env python3
"""Times B2 (``spmv_chunked_batched``) on the three B2 cases of
``chip_smoke.py`` in the checkout it runs from, so that two trees can be
compared in one card session: copy this file to the root of each checkout
and run it there, the trees in turns (parent, change, change, parent).

    python3 b2_compare.py LABEL

The cases: TSOPF_RS_b2383's block handle at B 8 and 64 and trans5's ELLX
overflow at B 8 (the suite stand-ins at scale 1.0, seed 0; x from a seeded
generator).  Per case it prints the kernel's device busy time
(torch.profiler, over 20 calls), its bound, and its agreement with the
plain version; where the wrapper takes ``vpt``, also the time at V 4 and
8.  Exits 1 when a case disagrees, 2 without a CUDA card."""

import sys

import numpy as np
import torch

import chip_smoke as cs
from hispmv_tpu_torch import SpmvConfig, prepare
from hispmv_tpu_torch.formats.synth import suite_matrix
from hispmv_tpu_torch.ops import spmv_chunked as sc


def main(label: str) -> int:
    if not torch.cuda.is_available():
        print("b2_compare: needs a CUDA card", file=sys.stderr)
        return 2
    handles = {
        "TSOPF_RS_b2383": prepare(suite_matrix("TSOPF_RS_b2383", 1.0,
                                               seed=cs.SEED), SpmvConfig(),
                                  "block"),
        "trans5": prepare(suite_matrix("trans5", 1.0, seed=cs.SEED),
                          SpmvConfig(), "auto"),
    }
    rng = np.random.default_rng(cs.SEED)
    takes_vpt = hasattr(sc, "chunked_batched_grid")
    ok = True
    for name, B, ov in (("TSOPF_RS_b2383", 8, ""), ("TSOPF_RS_b2383", 64, ""),
                        ("trans5", 8, "o")):
        h = handles[name]
        xb = h._pad_x(torch.from_numpy(rng.standard_normal(
            (B, h.shape[1])).astype(np.float32)).cuda())
        nrb = (h.plan.overflow if ov else h.plan).num_row_blocks
        args = (h._d[ov + "data"], h._d[ov + "meta"],
                xb.T.reshape(-1, 128, B).contiguous(), nrb, h.plan.block_h,
                h._chunk)
        y = sc.spmv_chunked_batched(*args)
        agree, _, line = cs._agree("spmv_chunked_batched", y,
                                   sc.spmv_chunked_batched_plain(*args))
        ok &= agree
        bound, by = cs.kernel_bound("spmv_chunked_batched", args, {}, y)
        busy = cs.device_ms(lambda: sc.spmv_chunked_batched(*args))
        msg = (f"{label} B2 [{name}{' ELLX overflow' if ov else ''}, B {B}]:"
               f" device busy {cs._ms(busy)}, bound {bound:.4f} ms ({by}),"
               f" {line}, {'ok' if agree else 'FAIL'}")
        if takes_vpt:
            for vpt in (4, 8):
                t = cs.device_ms(
                    lambda: sc.spmv_chunked_batched(*args, vpt=vpt))
                msg += f"; V {vpt} {cs._ms(t)}"
        print(msg, flush=True)
    print(f"{label} {cs.gpu_line()}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "tree"))
