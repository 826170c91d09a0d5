"""ctypes bindings for the native host runtime (``src/annhost.cpp``; port of
``approximatenn_tpu/native/lib.py``).

The shared library is built with g++ at first use into the package's
``_build/`` directory (git-ignored), under a name that carries a hash of
the source and the flags, so an edit rebuilds; the build writes a
temporary file and renames it, so concurrent processes never load a half
written library.  Plain C ABI + ctypes keeps the binding dependency-free.
Every entry point has a numpy fallback with the same results, used where
no compiler is present; ``available()`` reports which path is active.
This is host code, off the card's path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "src" / "annhost.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libannhost_{tag}.so"


def _build(out: Path) -> bool:
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
    except OSError:
        return False
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        c_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        c_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        c_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.ann_native_abi.restype = ctypes.c_int32
        lib.ann_native_abi.argtypes = []
        lib.ann_bucket_table.restype = ctypes.c_int32
        lib.ann_bucket_table.argtypes = [
            c_i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, c_i32p, ctypes.c_void_p,
        ]
        lib.ann_brute_force.restype = None
        lib.ann_brute_force.argtypes = [
            c_f32p, ctypes.c_int64, ctypes.c_int64, c_f32p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int64, c_i32p, c_f32p, ctypes.c_int32,
        ]
        lib.ann_rank_guesses.restype = None
        lib.ann_rank_guesses.argtypes = [
            c_f32p, ctypes.c_int64, ctypes.c_int64, c_f32p, ctypes.c_int64,
            c_i32p, ctypes.c_int32, ctypes.c_int64, c_i64p, c_i32p, c_i32p,
            ctypes.c_int32,
        ]
        if lib.ann_native_abi() != 1:
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the compiled native library is in use."""
    return _load() is not None


def bucket_table(
    codes: np.ndarray, n_buckets: int, capacity: int | None, sentinel: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Host bucket-table build with the reference's exact first-seen order
    (its ``alg.c:252-266``).  Returns (table (n_buckets, cap), counts,
    tmax)."""
    codes = np.ascontiguousarray(codes, np.int32)
    counts = np.empty(n_buckets, np.int32)
    lib = _load()
    if lib is not None:
        tmax = lib.ann_bucket_table(codes, len(codes), n_buckets, 0, sentinel,
                                    counts, None)
        if tmax < 0:
            raise ValueError("code out of range for n_buckets")
        cap = tmax if capacity is None else capacity
        table = np.empty((n_buckets, max(cap, 1)), np.int32)
        lib.ann_bucket_table(codes, len(codes), n_buckets, max(cap, 1),
                             sentinel, counts, table.ctypes.data_as(ctypes.c_void_p))
        return table, counts, int(tmax)
    # numpy fallback (same semantics)
    if codes.size and (codes.min() < 0 or codes.max() >= n_buckets):
        raise ValueError("code out of range for n_buckets")
    counts[:] = np.bincount(codes, minlength=n_buckets)
    tmax = int(counts.max()) if n_buckets else 0
    cap = max(tmax if capacity is None else capacity, 1)
    table = np.full((n_buckets, cap), sentinel, np.int32)
    fill = np.zeros(n_buckets, np.int64)
    for i, c in enumerate(codes):
        if fill[c] < cap:
            table[c, fill[c]] = i
            fill[c] += 1
    return table, counts, tmax


def _sq_dists(points: np.ndarray, queries: np.ndarray, exclude_self_offset: int):
    """(m, n) float32 squared distances, the diff form the library uses;
    the self-matches at ``q + exclude_self_offset`` get +inf."""
    m, n = queries.shape[0], points.shape[0]
    dd = ((queries[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    if exclude_self_offset >= 0:
        rows = np.arange(m) + exclude_self_offset
        ok = rows < n
        dd[np.arange(m)[ok], rows[ok]] = np.inf
    return dd


def brute_force_knn(
    points: np.ndarray,
    queries: np.ndarray,
    k: int,
    *,
    exclude_self_offset: int = -1,
    n_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Multithreaded exact kNN on the host (ground-truth oracle)."""
    points = np.ascontiguousarray(points, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    n, d = points.shape
    m = queries.shape[0]
    kk = min(k, n)
    lib = _load()
    out_ids = np.empty((m, k), np.int32)
    out_dd = np.empty((m, k), np.float32)
    if lib is not None:
        lib.ann_brute_force(points, n, d, queries, m, k, exclude_self_offset,
                            out_ids.reshape(-1), out_dd.reshape(-1), n_threads)
        return out_ids, out_dd
    dd = _sq_dists(points, queries, exclude_self_offset)
    idx = np.argsort(dd, axis=1)[:, :kk]
    out_ids[:, :kk] = idx
    out_dd[:, :kk] = np.take_along_axis(dd, idx, 1)
    out_ids[:, kk:] = n
    out_dd[:, kk:] = np.inf
    return out_ids, out_dd


def rank_guesses(
    points: np.ndarray,
    queries: np.ndarray,
    guesses: np.ndarray,
    *,
    exclude_self_offset: int = -1,
    n_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-query (rank sum, misses, max rank) of each guess against the
    exact ordering (the reference's ``test_correctness.c:169-262``)."""
    points = np.ascontiguousarray(points, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    guesses = np.ascontiguousarray(guesses, np.int32)
    n, d = points.shape
    m, k = guesses.shape
    lib = _load()
    rank_sum = np.empty(m, np.int64)
    miss = np.empty(m, np.int32)
    mx = np.empty(m, np.int32)
    if lib is not None:
        lib.ann_rank_guesses(points, n, d, queries, m, guesses.reshape(-1), k,
                             exclude_self_offset, rank_sum, miss, mx, n_threads)
        return rank_sum, miss, mx
    dd = _sq_dists(points, queries, exclude_self_offset)
    for q in range(m):
        ranks = np.empty(k, np.int64)
        for j in range(k):
            g = guesses[q, j]
            bad = g < 0 or g >= n or (exclude_self_offset >= 0 and g == q + exclude_self_offset)
            ranks[j] = n if bad else int((dd[q] < dd[q, g]).sum())
        rank_sum[q] = ranks.sum()
        miss[q] = int((ranks >= k).sum())
        mx[q] = int(ranks.max())
    return rank_sum, miss, mx
