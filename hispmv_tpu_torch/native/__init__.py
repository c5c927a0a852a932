"""Native (C++) planning routines of the routed and permutation planners.

The routines of ``hispmv_native.cpp`` (copied from the JAX package's
``hispmv_tpu/native``) are compiled with the host ``g++`` at first use,
never at import, into ``hispmv_tpu_torch/_build/`` (listed in
``.gitignore``), and again whenever the source is newer than the library.
The build is tried once with ``-fopenmp`` and once without; when both fail
it raises with the compiler's output.  There is no silent fallback: the
numpy / Python versions beside the callers (``plan/routed.py``,
``plan/permute.py``) are the plain versions the tests hold these to, and
the Python colouring takes tens of seconds where the native one takes
milliseconds.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "hispmv_native.cpp")
LIB_PATH = os.path.join(os.path.dirname(_HERE), "_build", "libhispmv_native.so")

_lock = threading.Lock()
_lib = None


def _stale() -> bool:
    try:
        return os.path.getmtime(SRC) > os.path.getmtime(LIB_PATH)
    except OSError:
        return True


def build() -> None:
    """Compile the library if it is missing or older than its source.
    Raises with both compilers' output when neither build succeeds."""
    if not _stale():
        return
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    # portable -O3 (no -march=native): the library may be built on one host
    # and loaded on another of the same checkout
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-shared", "-fPIC",
           "-std=c++17", "-fopenmp", SRC, "-o", tmp]
    errors = []
    for c in (cmd, [a for a in cmd if a != "-fopenmp"]):
        try:
            proc = subprocess.run(c, capture_output=True, text=True,
                                  timeout=300)
        except OSError as e:  # no compiler at all
            errors.append(f"{' '.join(c)}\n{e}")
            continue
        if proc.returncode == 0:
            os.replace(tmp, LIB_PATH)  # atomic for concurrent loaders
            return
        errors.append(f"{' '.join(c)}\n{proc.stdout}{proc.stderr}")
    raise RuntimeError(
        "building the native planning library failed (the routed and "
        "permutation planners need it):\n" + "\n".join(errors)
    )


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
            lib.euler_color.restype = ctypes.c_int
            lib.euler_color.argtypes = [ptr, ptr, i64, ctypes.c_int, ptr]
            lib.greedy_cell_merge.restype = i64
            lib.greedy_cell_merge.argtypes = [ptr, ptr, i64, i64, ptr]
            lib.radix_argsort_u64.restype = None
            lib.radix_argsort_u64.argtypes = [ptr, i64, ptr]
            lib.distinct_rank_u64.restype = None
            lib.distinct_rank_u64.argtypes = [ptr, i64, ctypes.c_ulonglong,
                                              ptr]
            lib.routed_tile_stats.restype = None
            lib.routed_tile_stats.argtypes = [ptr, ptr, ptr, i64, ptr, ptr,
                                              ptr, ptr]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def euler_color(sw: np.ndarray, dw: np.ndarray, d: int) -> np.ndarray:
    """Proper d-edge-colouring (int32 colours) of a d-regular bipartite
    multigraph given by non-negative vertex ids ``sw``/``dw``, by recursive
    Euler splits; ``d`` a power of two."""
    if len(sw) != len(dw):
        raise ValueError("sw and dw differ in length")
    sw = np.ascontiguousarray(sw, np.int32)
    dw = np.ascontiguousarray(dw, np.int32)
    if len(sw) and min(int(sw.min()), int(dw.min())) < 0:
        raise ValueError("vertex ids must be non-negative")
    colors = np.empty(len(sw), np.int32)
    rc = get_lib().euler_color(_ptr(sw), _ptr(dw), len(sw), int(d),
                               _ptr(colors))
    if rc != 0:
        raise ValueError(f"euler_color: d={d} is not a power of two")
    return colors


def greedy_cell_merge(strip: np.ndarray, bc: np.ndarray,
                      cap: int) -> np.ndarray:
    """Group id (int64) per cell: consecutive cells of one strip share a
    group while their summed band count stays <= ``cap``."""
    strip = np.ascontiguousarray(strip, np.int64)
    bc = np.ascontiguousarray(bc, np.int64)
    if len(strip) != len(bc):
        raise ValueError("strip and bc differ in length")
    gid = np.empty(len(strip), np.int64)
    get_lib().greedy_cell_merge(_ptr(strip), _ptr(bc), len(strip), int(cap),
                                _ptr(gid))
    return gid


def radix_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable argsort (int64) of uint64 keys."""
    keys = np.ascontiguousarray(keys, np.uint64)
    if len(keys) >= 1 << 32:
        raise ValueError("radix_argsort holds indices in 32 bits")
    order = np.empty(len(keys), np.int64)
    get_lib().radix_argsort_u64(_ptr(keys), len(keys), _ptr(order))
    return order


def distinct_rank(key: np.ndarray, width: int) -> np.ndarray:
    """Per entry: the number of distinct key values preceding it within its
    group (group = key // width; equal keys share a rank)."""
    key = np.ascontiguousarray(key, np.uint64)
    rank = np.empty(len(key), np.int64)
    get_lib().distinct_rank_u64(_ptr(key), len(key), int(width), _ptr(rank))
    return rank


def routed_tile_stats(p_win: np.ndarray, p_band: np.ndarray,
                      pad: np.ndarray):
    """Per 1024-slot tile: (nnz, window min, window span, distinct bands),
    int32 each."""
    n = len(p_win)
    if n % 1024 or len(p_band) != n or len(pad) != n:
        raise ValueError("routed_tile_stats takes whole tiles of 1024 slots")
    T = n // 1024
    p_win = np.ascontiguousarray(p_win, np.int32)
    p_band = np.ascontiguousarray(p_band, np.int32)
    pad = np.ascontiguousarray(pad, np.uint8)
    out = [np.empty(T, np.int32) for _ in range(4)]
    get_lib().routed_tile_stats(_ptr(p_win), _ptr(p_band), _ptr(pad), T,
                                *map(_ptr, out))
    return tuple(out)
