"""Exact k-NN: the hand-written CUDA kernels' build and launch counts (for
every kernel source of the package), the rank kernel, its plain PyTorch
twin, and the exact-search entry point.

Port of ``approximatenn_tpu/ops/pallas_exact.py`` (the rank-merge Pallas
kernel ``_kernel_rank`` behind ``exact_knn_pallas``, plus
``quantize_corpus`` and ``exact_search``; the two-phase engine is in
``ops/twophase.py``).  The kernel sources are ``csrc/*.cu``; each is
compiled with nvcc for ``sm_90a`` into ``_build/`` at first use and bound
through ctypes (a plain C interface, so a build takes seconds).

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

from ..config import default_device, itype

KMAX = 128
_MAX_SPLITS = 32
_QB = 32  # queries per block in the kernel (csrc/exact_knn.cu: QB)
_TN = 128  # corpus rows per tile (csrc/exact_knn.cu: TN)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}
_PRECISIONS = ("highest", "split3", "default")

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
# one shared library per kernel source; the headers are part of every one
SOURCES = {"exact_knn": CSRC / "exact_knn.cu",
           "twophase_knn": CSRC / "twophase_knn.cu",
           "probe_knn": CSRC / "probe_knn.cu"}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# C entry points of each library: name -> argtypes (all return a CUDA error code)
_ENTRY_POINTS = {
    "exact_knn": {"exact_knn_launch": [_ci, _vp, _ci, _vp, _vp, _vp, _ci, _ci, _ci,
                                       _ci, _ci, _vp, _vp, _vp, _vp, ctypes.c_float,
                                       _vp]},
    "twophase_knn": {
        "twophase_emit_launch": [_ci, _vp, _ci, _vp, _vp, _ci, _ci, _ci, _ci, _ci,
                                 _ci, _vp, _vp, _vp],
        "twophase_rescan_launch": [_ci, _vp, _ci, _vp, _vp, _ci, _ci, _ci, _ci, _ci,
                                   _ci, _vp, _vp, _vp],
    },
    "probe_knn": {"probe_topk_launch": [_ci, _vp, _ci, _vp, _vp, _ci, _ci, _ci, _ci, _ci,
                                        _ci, _ci, _ci, _vp, _vp, _vp]},
}

# kernel launches through the wrappers, plain counts a run reads to show
# that its main path went through the kernels
launches = {"exact_knn": 0, "twophase_emit": 0, "twophase_rescan": 0, "probe_topk": 0}
_libs: dict = {}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the exact kernels build from "
                       f"{CSRC} on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library of kernel source ``name`` is built.  The file name
    carries a hash of the source, the shared headers and the flags, so an
    edit to any of them rebuilds."""
    data = SOURCES[name].read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        data += header.read_bytes()
    tag = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build_libraries(names=None, verbose: bool = False) -> dict:
    """Compile the kernel sources ``names`` (default: all) that are not built
    yet, one nvcc per source, all started together; return {name: path}."""
    names = list(SOURCES) if names is None else list(names)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{SOURCES[name].name}: nvcc failed ({proc.returncode}):\n{err}")
            continue
        if verbose and err:
            print(err)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def _library(name: str):
    """The loaded library of kernel source ``name`` (built at first use)."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build_libraries([name])[name]))
        for fn, argtypes in _ENTRY_POINTS[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _ci
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes = [_ci]
        err_fn.restype = ctypes.c_char_p
        lib.error_string = err_fn
        _libs[name] = lib
    return _libs[name]


def launch_error(lib, what: str, err: int) -> RuntimeError:
    return RuntimeError(f"{what} kernel launch failed: "
                        + lib.error_string(err).decode())


def device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


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


def splits(m: int, n: int, device, cap: int = _MAX_SPLITS) -> int:
    """Corpus splits of a 32-query x 128-row tiled kernel: enough blocks to
    fill the card (about four resident blocks per SM) when there are few
    query blocks."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_blocks = -(-m // _QB)
    n_tiles = -(-n // _TN)
    want = -(-4 * sms // q_blocks)
    return max(1, min(cap, n_tiles, want))


def exact_knn(points: torch.Tensor, queries: torch.Tensor, k: int, *,
              exclude: torch.Tensor | None = None, scale=None,
              matmul_precision: str = "highest", merge: str = "rank",
              twophase_seg: int = 512, stream: bool = False):
    """Exact k nearest neighbours through the CUDA kernel (CUDA tensors) or
    :func:`exact_knn_plain` (CPU tensors).  Returns (ids (m, k) int32,
    squared distances (m, k) float32).  ``matmul_precision`` is validated;
    every tier computes in IEEE fp32 (see the kernel source).

    ``merge="twophase"`` is the JAX package's two-phase merge: the emit
    kernel's per-``twophase_seg``-row segment minima, then the k best of
    them per query (one candidate per segment, so not exact on its own;
    :func:`~.twophase.exact_knn_twophase` is the exact engine).  It takes
    any k."""
    if stream or merge == "rescan":
        raise NotImplementedError(
            "merge='rescan' and stream=True (the _kernel and _stream_kernel "
            "TPU kernels) are not ported yet: ROADMAP queue B")
    if merge not in ("rank", "twophase"):
        raise ValueError(f"unknown merge style {merge!r}")
    _check(points, queries, k, exclude, matmul_precision)
    if merge == "twophase":
        from .twophase import segment_merge

        return segment_merge(points, queries, k, twophase_seg, exclude=exclude,
                             scale=scale, matmul_precision=matmul_precision)
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
    s = splits(m, n, dev)
    part_d = torch.empty((m, s, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((m, s, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, k), dtype=itype, device=dev)
    lib = _library("exact_knn")
    err = lib.exact_knn_launch(
        device_index(dev), points.data_ptr(), _DTYPE_CODE[points.dtype], q.data_ptr(),
        exclude.data_ptr() if exclude is not None else None, qn.data_ptr(),
        n, d, m, k, s, part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), scale2, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise launch_error(lib, "exact_knn", err)
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


def place(points, queries, device=None):
    """(corpus, queries) of an exact entry point as tensors: the corpus on
    :func:`config.default_device` (its own device for a tensor, ``device``
    when given, else the card), the queries on the corpus's device in
    float32 (float64 beside a float64 corpus, for the oracle)."""
    points = torch.as_tensor(points, device=default_device(points, device))
    qdt = torch.float64 if points.dtype == torch.float64 else torch.float32
    return points, torch.as_tensor(queries, device=points.device).to(qdt)


def exact_search(points, queries, k: int, *, scale=None,
                 matmul_precision: str = "highest", no_twophase: bool = False,
                 device=None, **kw):
    """Exact k-NN with the engine the tensors' device has, routed as the
    JAX package routes it on its accelerator (:func:`~.twophase.route`):
    on a CUDA corpus the two-phase engine at n >= ``TWOPHASE_MIN_N`` and
    for k > 128, the rank kernel below that, brute force on the card for
    k > 128 close to n; on the CPU the float oracle
    (:func:`brute_force_knn`), as the JAX package does off the TPU.
    ``kw`` takes the two-phase knobs (``seg``, ``pad_segments``,
    ``rescan``) and the rank kernel's (``merge``, ``twophase_seg``,
    ``stream``); pinning a rank-only knob keeps the rank kernel.
    ``no_twophase`` escapes the n >= ``TWOPHASE_MIN_N`` route only: past
    k = 128 there is no rank kernel to escape to.  An int8 corpus needs
    its ``scale``; on the CPU it is dequantised, and the queries snapped
    to the same grid, so both rank the same quantized values.  A bf16/f16
    corpus is ranked on the CPU in float32 from its stored values.  Takes
    tensors or array-likes (placed by :func:`place`)."""
    points, queries = place(points, queries, device)
    if points.device.type == "cuda":
        from .twophase import TWOPHASE_ONLY_KW, exact_knn_twophase, route

        pk = points
        if pk.dtype not in _DTYPE_CODE:
            pk = pk.float()
        pk = pk.contiguous()
        q = queries.float().contiguous()
        engine = route(pk.shape[0], k, kw, no_twophase)
        if engine == "twophase":
            return exact_knn_twophase(pk, q, k, scale=scale,
                                      matmul_precision=matmul_precision, **kw)
        if engine == "rank":
            for key in TWOPHASE_ONLY_KW:
                kw.pop(key, None)
            return exact_knn(pk, q, k, scale=scale,
                             matmul_precision=matmul_precision, **kw)
    from .distance import brute_force_knn

    _check_precision(matmul_precision)
    _check_scale(points, scale)
    if points.dtype == torch.int8:
        s = torch.as_tensor(scale, dtype=torch.float32, device=points.device)
        points = points.float() * s
        queries = torch.clamp(torch.round(queries.float() / s), -127, 127) * s
    elif points.dtype in (torch.bfloat16, torch.float16):
        # rank the stored values in float32: a half-precision |x|^2 (what
        # the JAX oracle computes for such a corpus) misranks neighbours
        points = points.float()
    return brute_force_knn(points, queries, k)
