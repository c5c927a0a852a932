"""Build and load the port's hand-written CUDA kernels.

The sources under ``hispmv_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes``: one ``nvcc`` per source, all started together, then one link.
The build happens at first use (never at import), into
``hispmv_tpu_torch/_build/`` (listed in ``.gitignore``), and again whenever
a source is newer than the library.  No PyTorch header is compiled, so a
build takes seconds.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
LIB_PATH = os.path.join(_PKG, "_build", "libhispmv_kernels.so")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _inputs() -> list:
    return sources() + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of hispmv_tpu_torch are built from source at first use"
    )


def _stale() -> bool:
    """True when the library is missing or older than any source."""
    try:
        built = os.path.getmtime(LIB_PATH)
    except OSError:
        return True
    return any(os.path.getmtime(s) > built for s in _inputs())


def _check_nvcc(runs, verbose: bool) -> None:
    """``runs``: (cmd, returncode, output) of finished nvcc calls.  Raises
    with the output of every failed call."""
    failed = [f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}"
              for cmd, rc, out in runs if rc != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    if verbose:
        for _, _, out in runs:
            if out:
                print(out)


def build(verbose: bool = False) -> float:
    """Compile the kernels if the library is stale; returns the seconds
    spent compiling (0.0 when the library was current).  Raises with the
    compiler's output when nvcc fails."""
    if not _stale():
        return 0.0
    nvcc = _nvcc()
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    objs, procs = [], []
    for src in sources():
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        objs.append(obj)
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
    try:
        runs = []
        for p in procs:
            out = p.communicate()[0]
            runs.append((p.args, p.returncode, out))
        _check_nvcc(runs, verbose)
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        _check_nvcc([(link, proc.returncode, proc.stdout)], verbose)
    finally:
        for p in procs:  # stop every compiler this call started
            if p.poll() is None:
                p.kill()
                p.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, LIB_PATH)  # atomic: concurrent loaders see a whole file
    return time.perf_counter() - t0


def build_alone(source: str, defines: dict, path: str) -> ctypes.CDLL:
    """One source of ``csrc/`` built alone into the library ``path`` with
    the build's flags and ``-D`` name=value for each entry of ``defines``,
    then loaded (the caller sets argtypes): tests and measurements of a
    compile-time parameter use it.  Raises with the compiler's output."""
    cmd = [_nvcc(), *NVCC_FLAGS, "-shared",
           *(f"-D{k}={v}" for k, v in defines.items()), "-o", path,
           os.path.join(CSRC_DIR, source)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    _check_nvcc([(cmd, proc.returncode, proc.stdout)], False)
    return ctypes.CDLL(path)


def get_lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.hispmv_spmv_chunked.restype = i32
            lib.hispmv_spmv_chunked.argtypes = [
                ptr, i32, ptr, ptr, ptr, i32, i32, i32, i32, ptr,
            ]
            lib.hispmv_spmv_windowed.restype = i32
            lib.hispmv_spmv_windowed.argtypes = [
                ptr, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr,
            ]
            lib.hispmv_spmv_routed_streams.restype = i32
            lib.hispmv_spmv_routed_streams.argtypes = [
                ptr, i32, ptr, ctypes.c_longlong, ptr, i32, ptr,
            ]
            lib.hispmv_spmv_chunked_batched.restype = i32
            lib.hispmv_spmv_chunked_batched.argtypes = [
                ptr, i32, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr,
            ]
            lib.hispmv_spmv_chunked_batched_grid.restype = i32
            lib.hispmv_spmv_chunked_batched_grid.argtypes = [
                i32, i32, i32, i32, i32, ptr,
            ]
            lib.hispmv_spmv_windowed_batched.restype = i32
            lib.hispmv_spmv_windowed_batched.argtypes = [
                ptr, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr,
            ]
            lib.hispmv_spmv_windowed_batched_grid.restype = i32
            lib.hispmv_spmv_windowed_batched_grid.argtypes = [
                i32, i32, i32, i32, i32, ptr,
            ]
            lib.hispmv_spmv_routed_batched.restype = i32
            lib.hispmv_spmv_routed_batched.argtypes = [
                ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong,
                i32, ptr, i32, i32, i32, i32, i32, i32, ptr,
            ]
            lib.hispmv_spmv_routed_batched_v.restype = i32
            lib.hispmv_spmv_routed_batched_v.argtypes = [i32, i32, i32]
            lib.hispmv_spmv_chunked_paneled.restype = i32
            lib.hispmv_spmv_chunked_paneled.argtypes = [
                ptr, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr,
            ]
            lib.hispmv_spmv_chunked_paneled_grid.restype = i32
            lib.hispmv_spmv_chunked_paneled_grid.argtypes = [
                i32, i32, i32, ptr,
            ]
            lib.hispmv_spmv_chunked_tiled.restype = i32
            lib.hispmv_spmv_chunked_tiled.argtypes = [
                ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                i32, ptr,
            ]
            lib.hispmv_spmv_chunked_tiled_grid.restype = i32
            lib.hispmv_spmv_chunked_tiled_grid.argtypes = [
                i32, i32, i32, ptr,
            ]
            lib.hispmv_spmv_block.restype = i32
            lib.hispmv_spmv_block.argtypes = [
                ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr,
            ]
            lib.hispmv_spmv_block_batched.restype = i32
            lib.hispmv_spmv_block_batched.argtypes = [
                ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                ptr,
            ]
            lib.hispmv_spmv_block_batched_grid.restype = i32
            lib.hispmv_spmv_block_batched_grid.argtypes = [i32, i32, i32, ptr]
            lib.hispmv_permute_stage.restype = i32
            lib.hispmv_permute_stage.argtypes = [ptr, ptr, ptr, i32, ptr]
            lib.hispmv_permute_stage_grid.restype = i32
            lib.hispmv_permute_stage_grid.argtypes = [i32, ptr]
            lib.hispmv_s1_gather.restype = i32
            lib.hispmv_s1_gather.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
            lib.hispmv_s1_gather_grid.restype = i32
            lib.hispmv_s1_gather_grid.argtypes = [i32, ptr]
            lib.hispmv_spmv_gathered.restype = i32
            lib.hispmv_spmv_gathered.argtypes = [
                ptr, ptr, ptr, ptr, ctypes.c_longlong, ptr, i32, i32, ptr,
            ]
            lib.hispmv_spmv_gathered_grid.restype = i32
            lib.hispmv_spmv_gathered_grid.argtypes = [i32, ptr]
            lib.hispmv_error_string.restype = ctypes.c_char_p
            lib.hispmv_error_string.argtypes = [i32]
            _lib = lib
        return _lib


def launch_shape(fn: str, *args) -> tuple:
    """The three ints of the library's shape query ``fn`` (a
    ``hispmv_*_grid`` function of ``args`` and an out array of three
    ints): (V, row slices, CTAs) of the vec streams, (warps a CTA, row
    slices, CTAs) of B6, (warps a CTA, rows, CTAs) of B12, (windows a CTA,
    threads a CTA, CTAs) of B11, (threads a CTA, CTAs, resident CTAs an SM)
    of B13; raises for sizes its launcher refuses."""
    out = (ctypes.c_int * 3)()
    check(getattr(get_lib(), fn)(*args, ctypes.addressof(out)), fn)
    return tuple(out)


def check(rc: int, name: str) -> None:
    """Raise when a launch returned a nonzero cudaError_t."""
    if rc != 0:
        msg = get_lib().hispmv_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")
