#!/usr/bin/env python3
"""Times variants of B6 (``csrc/spmv_block.cu::block_run_batched_kernel``)
beside the kernel as committed, on the B6 cases of ``kernel_compare.py``
(TSOPF_RS_b2383 and the Flan_1565-sized block matrix at B 64), to show
what bounds it on the card:

    python3 b6_variants.py

Each variant is the committed source with one change, made here by text
substitution and built with ``nvcc`` into ``hispmv_tpu_torch/_build/``:
``m8n8k4`` (two m8n8k4 DMMAs in place of each m16n8k4), ``m16n8k16`` (one
DMMA a ring slot), ``no_widening`` (the fp32 -> fp64 conversions replaced
by a bit move: wrong sums, timing only) and ``cap128`` (at most 128
registers a thread, 4 CTAs an SM).  Per variant it prints the registers
and spills (``-Xptxas -v``), its agreement with the plain version and its
device busy time (torch.profiler), four readings a case with the variants
in turns.  Exits 2 without a CUDA card."""

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from hispmv_tpu_torch.ops import cuda_build

LOOP = """#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dmma_16x8x4(acc[j & 1], s.x[i].x, s.x[i].y, a[i]);
      }"""
M884 = """#pragma unroll
      for (int i = 0; i < 4; ++i) {
        asm volatile(
            "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
            "{%0, %1}, {%2}, {%3}, {%0, %1};\\n"
            : "+d"(acc[j & 1][0][0]), "+d"(acc[j & 1][0][1])
            : "d"(static_cast<double>(s.x[i].x)), "d"(a[i]));
        asm volatile(
            "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
            "{%0, %1}, {%2}, {%3}, {%0, %1};\\n"
            : "+d"(acc[j & 1][1][0]), "+d"(acc[j & 1][1][1])
            : "d"(static_cast<double>(s.x[i].y)), "d"(a[i]));
      }"""
M16816 = """      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
          "{%12, %13, %14, %15}, {%0, %1, %2, %3};\\n"
          : "+d"(acc[j & 1][0][0]), "+d"(acc[j & 1][0][1]),
            "+d"(acc[j & 1][1][0]), "+d"(acc[j & 1][1][1])
          : "d"(double(s.x[0].x)), "d"(double(s.x[0].y)),
            "d"(double(s.x[1].x)), "d"(double(s.x[1].y)),
            "d"(double(s.x[2].x)), "d"(double(s.x[2].y)),
            "d"(double(s.x[3].x)), "d"(double(s.x[3].y)),
            "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]));"""
A_WIDE = "const double a[4] = {s.a.x, s.a.y, s.a.z, s.a.w};"
BITS = "__hiloint2double(__float_as_int({}), 0)"
A_BITS = "const double a[4] = {%s};" % ", ".join(
    BITS.format("s.a." + c) for c in "xyzw")
LOOP_BITS = LOOP.replace("s.x[i].x, s.x[i].y", ", ".join(
    BITS.format(v) for v in ("s.x[i].x", "s.x[i].y")))
BOUNDS = "__launch_bounds__(kB6Warps * 32)"

VARIANTS = {
    "m8n8k4": [(LOOP, M884)],
    "m16n8k16": [(LOOP, M16816)],
    "no_widening": [(A_WIDE, A_BITS), (LOOP, LOOP_BITS)],
    "cap128": [(BOUNDS, "__launch_bounds__(kB6Warps * 32, 4)")],
}


def build_variants():
    """{name: loaded library} of the committed kernel ("tree") and each
    variant, built in parallel; prints each one's registers and spills."""
    src = open(os.path.join(cuda_build.CSRC_DIR, "spmv_block.cu")).read()
    build = os.path.dirname(cuda_build.LIB_PATH)
    os.makedirs(build, exist_ok=True)
    procs = {}
    for name, edits in {"tree": [], **VARIANTS}.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"b6_variants: {name}: source changed")
            text = text.replace(old, new)
        cu = os.path.join(build, f"b6_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared",
               "-Xptxas", "-v", "-I", cuda_build.CSRC_DIR, "-o", so, cu]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"b6_variants: {name} failed:\n{out}")
        b6 = [part for part in out.split("Compiling entry function")
              if "block_run_batched_kernel" in part]
        print(f"{name}: registers " + ", ".join(
            re.search(r"Used (\d+) registers", part).group(1) + " ("
            + re.search(r"(\d+) bytes spill stores", part).group(1)
            + " B spilled)" for part in b6), flush=True)
        lib = ctypes.CDLL(so)
        lib.hispmv_spmv_block_batched.restype = ctypes.c_int
        lib.hispmv_spmv_block_batched.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def call(lib, args, starts):
    data, rows, cols, firsts, lasts, xt, nrb = args
    y = torch.zeros((nrb, data.shape[1], xt.shape[2]), device=xt.device)
    rc = lib.hispmv_spmv_block_batched(
        data.data_ptr(), rows.data_ptr(), cols.data_ptr(), firsts.data_ptr(),
        lasts.data_ptr(), starts.data_ptr(), xt.data_ptr(), y.data_ptr(),
        data.shape[0], starts.numel(), data.shape[1], xt.shape[2],
        torch.cuda.current_stream().cuda_stream)
    cuda_build.check(rc, "b6_variants")
    return y


def main() -> int:
    if not torch.cuda.is_available():
        print("b6_variants: needs a CUDA card", file=sys.stderr)
        return 2
    import kernel_compare as kc

    libs = build_variants()
    order = list(libs.items())
    for tag, name, args, _, *kw in kc.b6_cases(np.random.default_rng(cs.SEED)):
        if name != "spmv_block_batched":
            continue
        starts = kw[0]["starts"]
        want = cs.PLAIN[name](*args)
        times = {v: [] for v in libs}
        for r in range(4):
            for v, lib in (order if r % 2 == 0 else order[::-1]):
                times[v].append(cs.device_ms(lambda: call(lib, args, starts)))
        for v, lib in order:
            agree = cs._agree(name, call(lib, args, starts), want)[0]
            print(f"{tag} {v}: device busy " + ", ".join(
                cs._ms(t) for t in times[v]) + f"; agrees with the plain "
                f"version: {agree}", flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
