"""Exact k-NN: the hand-written CUDA kernel, its plain PyTorch twin, and
the exact-search entry point.

Port of ``approximatenn_tpu/ops/pallas_exact.py`` (the rank-merge Pallas
kernel ``_kernel_rank`` behind ``exact_knn_pallas``, plus
``quantize_corpus`` and ``exact_search``).  The kernel source is
``csrc/exact_knn.cu``; it is compiled with nvcc for ``sm_90a`` into
``_build/`` at first use and bound through ctypes (a plain C interface, so
the build takes seconds).

Contract (both versions): ids (m, k) int32 ascending by squared L2
distance on the raw coordinates, ties to the smaller id, (n, +inf) past the
real candidates; optional per-query ``exclude`` id; f32, bf16, f16 or int8
(+ ``scale``) corpora.  Ranking happens in the score domain
``|x|^2 - 2 q.x`` and ``|q|^2`` is added to the k winners, as on the TPU.
A bf16/f16 corpus multiplies queries rounded to its dtype; an int8 corpus
multiplies queries quantised with its own scale (``round(q / scale)``
clipped to [-127, 127]) and distances come back times scale^2.

``exact_knn`` runs the kernel for a CUDA tensor and the plain version for
a CPU tensor, never anything else: no fallback, no silent device move.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..config import itype

KMAX = 128
_MAX_SPLITS = 32
_QB = 32  # queries per block in the kernel (csrc/exact_knn.cu: QB)
_TN = 128  # corpus rows per tile (csrc/exact_knn.cu: TN)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}
_PRECISIONS = ("highest", "split3", "default")

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "exact_knn.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# kernel launches through exact_knn, a plain count a run reads to show
# that its main path went through the kernel
launches = {"exact_knn": 0}
_lib = None


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the exact kernel builds from "
                       f"{SOURCE} on a machine with the CUDA toolkit")


def build_library(verbose: bool = False) -> Path:
    """Compile ``csrc/exact_knn.cu`` (if this source was not built yet) and
    return the shared library's path.  The name carries a hash of the
    source and flags, so an edited source rebuilds."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libexact_knn_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr)
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.exact_knn_launch.argtypes = [ci, vp, ci, vp, vp, vp, ci, ci, ci, ci,
                                         ci, vp, vp, vp, vp, ctypes.c_float, vp]
        lib.exact_knn_launch.restype = ci
        lib.exact_knn_error_string.argtypes = [ci]
        lib.exact_knn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_precision(matmul_precision):
    if matmul_precision not in _PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {_PRECISIONS}, "
                         f"got {matmul_precision!r}")


def _check_scale(points, scale):
    if points.dtype == torch.int8 and scale is None:
        raise ValueError("int8 corpus requires its quantization scale "
                         "(see quantize_corpus)")


def _check(points, queries, k, exclude, matmul_precision):
    _check_precision(matmul_precision)
    if points.dim() != 2 or queries.dim() != 2:
        raise ValueError("points and queries must be 2-D")
    if points.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported corpus dtype {points.dtype}")
    if queries.dtype != torch.float32:
        raise TypeError(f"queries must be float32, got {queries.dtype}")
    if points.shape[1] != queries.shape[1]:
        raise ValueError(f"dims differ: {points.shape} vs {queries.shape}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if points.shape[0] < 1 or points.shape[0] >= 2**31:
        raise ValueError("need 1 <= n < 2**31 corpus rows")
    if points.device != queries.device:
        raise ValueError(f"points on {points.device}, queries on {queries.device}")
    if exclude is not None:
        if exclude.shape != (queries.shape[0],) or exclude.dtype != torch.int32:
            raise ValueError("exclude must be an (m,) int32 tensor")
        if exclude.device != points.device:
            raise ValueError("exclude must live on the points' device")


def _prepare(points, queries, scale):
    """(queries as the kernel multiplies them, |q|^2, scale^2) -- the
    query-side conventions both versions share."""
    _check_scale(points, scale)
    q = queries
    scale2 = 1.0
    if points.dtype == torch.int8:
        s = torch.tensor(float(scale), dtype=torch.float32)
        scale2 = float(s * s)
        q = torch.clamp(torch.round(q / float(s)), -127, 127)
    return q.contiguous(), (q * q).sum(-1), scale2


def _splits(m: int, n: int, device) -> int:
    """Corpus splits: enough blocks to fill the card (about four resident
    blocks per SM) when there are few query blocks."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_blocks = -(-m // _QB)
    n_tiles = -(-n // _TN)
    want = -(-4 * sms // q_blocks)
    return max(1, min(_MAX_SPLITS, n_tiles, want))


def exact_knn(points: torch.Tensor, queries: torch.Tensor, k: int, *,
              exclude: torch.Tensor | None = None, scale=None,
              matmul_precision: str = "highest"):
    """Exact k nearest neighbours through the CUDA kernel (CUDA tensors) or
    :func:`exact_knn_plain` (CPU tensors).  Returns (ids (m, k) int32,
    squared distances (m, k) float32).  ``matmul_precision`` is validated;
    every tier computes in IEEE fp32 (see the kernel source)."""
    _check(points, queries, k, exclude, matmul_precision)
    if k > KMAX:
        raise ValueError(f"exact_knn supports k <= {KMAX}, got {k}")
    if points.device.type == "cpu":
        return exact_knn_plain(points, queries, k, exclude=exclude, scale=scale,
                               matmul_precision=matmul_precision)
    if points.device.type != "cuda":
        raise ValueError(f"exact_knn runs on cuda or cpu, not {points.device}")
    if not points.is_contiguous():
        raise ValueError("points must be contiguous")
    n, d = points.shape
    m = queries.shape[0]
    dev = points.device
    if m == 0:
        return (torch.empty((0, k), dtype=itype, device=dev),
                torch.empty((0, k), dtype=torch.float32, device=dev))
    q, qn, scale2 = _prepare(points, queries, scale)
    if exclude is not None:
        exclude = exclude.contiguous()
    s = _splits(m, n, dev)
    part_d = torch.empty((m, s, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((m, s, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, k), dtype=itype, device=dev)
    lib = _library()
    err = lib.exact_knn_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        points.data_ptr(), _DTYPE_CODE[points.dtype], q.data_ptr(),
        exclude.data_ptr() if exclude is not None else None, qn.data_ptr(),
        n, d, m, k, s, part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), scale2, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("exact_knn kernel launch failed: "
                           + lib.exact_knn_error_string(err).decode())
    launches["exact_knn"] += 1
    return out_i, out_d


def exact_knn_plain(points: torch.Tensor, queries: torch.Tensor, k: int, *,
                    exclude: torch.Tensor | None = None, scale=None,
                    matmul_precision: str = "highest"):
    """Plain PyTorch version of the kernel, same contract and score domain:
    a float32 matmul per query block, a stable sort (ties to the smaller
    id), |q|^2 added to the winners.  Takes any k (a check may ask for
    k + 1 to see the boundary)."""
    _check(points, queries, k, exclude, matmul_precision)
    n = points.shape[0]
    m = queries.shape[0]
    q, qn, scale2 = _prepare(points, queries, scale)
    if points.dtype in (torch.bfloat16, torch.float16):
        q = q.to(points.dtype).float()
    x = points.float()
    pn = (x * x).sum(-1)
    kk = min(k, n)
    block = max(1, min(m, (64 << 20) // n))  # (block, n) score rows ~256 MB
    vals, ids = [], []
    for lo in range(0, m, block):
        s = pn[None, :] - 2.0 * (q[lo: lo + block] @ x.T)
        if exclude is not None:
            e = exclude[lo: lo + block].long()
            rows = torch.nonzero((e >= 0) & (e < n)).squeeze(1)
            s[rows, e[rows]] = float("inf")
        v, i = torch.sort(s, dim=1, stable=True)
        # copies: a slice would keep the whole sorted (block, n) rows alive
        vals.append(v[:, :kk].clone())
        ids.append(i[:, :kk].clone())
    v = torch.cat(vals) if vals else pn.new_empty((0, kk))
    i = torch.cat(ids) if ids else torch.empty((0, kk), dtype=torch.long,
                                                device=pn.device)
    if kk < k:
        v = torch.cat([v, v.new_full((m, k - kk), float("inf"))], dim=1)
        i = torch.cat([i, i.new_full((m, k - kk), n)], dim=1)
    inf = torch.isinf(v)
    ids_out = torch.where(inf, torch.full_like(i, n), i).to(itype)
    d_out = torch.where(inf, v, (v + qn[:, None]) * scale2)
    return ids_out, d_out


def exact_knn_self(points: torch.Tensor, k: int, **kw):
    """Exact kNN graph with self-exclusion."""
    n = points.shape[0]
    excl = torch.arange(n, dtype=torch.int32, device=points.device)
    q = points if points.dtype == torch.float32 else points.float()
    return exact_knn(points, q, k, exclude=excl, **kw)


def quantize_corpus(points: torch.Tensor, scale=None,
                    chunk_rows: int = 1 << 20):
    """Symmetric int8 quantization for the exact engine's int8 tier:
    (rows int8 (n, d), scale () float32) with rows = round(x / scale)
    clipped to [-127, 127] and scale = max|x| / 127 by default.  Works in
    row chunks so no corpus-sized float32 transient is made."""
    n = points.shape[0]
    if scale is None:
        mx = torch.zeros((), dtype=torch.float32, device=points.device)
        for lo in range(0, n, chunk_rows):
            mx = torch.maximum(mx, points[lo: lo + chunk_rows].float().abs().max())
        scale = mx / 127.0
    scale = torch.as_tensor(scale, dtype=torch.float32, device=points.device)
    out = torch.empty(points.shape, dtype=torch.int8, device=points.device)
    for lo in range(0, n, chunk_rows):
        blk = points[lo: lo + chunk_rows].float()
        out[lo: lo + chunk_rows] = torch.clamp(torch.round(blk / scale),
                                               -127, 127).to(torch.int8)
    return out, scale


def exact_search(points: torch.Tensor, queries: torch.Tensor, k: int, *,
                 scale=None, matmul_precision: str = "highest"):
    """Exact k-NN with the engine the tensors' device has: the CUDA kernel
    for k <= 128 at every n; the float oracle (:func:`brute_force_knn`) on
    the CPU, as the JAX package does off the TPU.  An int8 corpus needs its
    ``scale``; on the CPU it is dequantised, and the queries snapped to the
    same grid, so both rank the same quantized values.  A bf16/f16 corpus
    is ranked on the CPU in float32 from its stored values."""
    if points.device.type == "cuda":
        if k > KMAX:
            raise NotImplementedError(
                f"exact search with k > {KMAX} on CUDA needs the two-phase "
                "kernels (_kernel_emit + _kernel_rescan), not ported yet: "
                "ROADMAP queue B, two-phase exact")
        pk = points
        if pk.dtype not in _DTYPE_CODE:
            pk = pk.float()
        q = queries.to(device=pk.device, dtype=torch.float32).contiguous()
        return exact_knn(pk.contiguous(), q, k, scale=scale,
                         matmul_precision=matmul_precision)
    from .distance import brute_force_knn

    _check_precision(matmul_precision)
    _check_scale(points, scale)
    if points.dtype == torch.int8:
        s = torch.as_tensor(scale, dtype=torch.float32)
        points = points.float() * s
        queries = torch.clamp(torch.round(queries.float() / s), -127, 127) * s
    elif points.dtype in (torch.bfloat16, torch.float16):
        # rank the stored values in float32: a half-precision |x|^2 (what
        # the JAX oracle computes for such a corpus) misranks neighbours
        points = points.float()
    return brute_force_knn(points, queries, k)
