"""Exact k-NN: the hand-written CUDA kernels' build and launch counts (for
every kernel source of the package), the rank, rescan-merge and streaming
kernels with their plain PyTorch twins, and the exact-search entry point.

Port of ``approximatenn_tpu/ops/pallas_exact.py`` (``exact_knn_pallas``
with its Pallas kernels ``_kernel_rank`` (merge="rank"), ``_kernel``
(merge="rescan") and ``_stream_kernel`` (stream=True), plus
``quantize_corpus`` and ``exact_search``; the two-phase engine is in
``ops/twophase.py``).  The kernel sources are ``csrc/*.cu``; each is
compiled with nvcc for ``sm_90a`` into ``_build/`` at first use and bound
through ctypes (a plain C interface, so a build takes seconds).

Contract (every version): ids (m, k) int32 ascending by squared L2
distance on the raw coordinates, ties to the smaller id, (n, +inf) past the
real candidates; optional per-query ``exclude`` id; f32, bf16, f16 or int8
(+ ``scale``) corpora.  The rank kernel ranks in the score domain
``|x|^2 - 2 q.x`` with the norms of the values it streams and adds
``|q|^2`` to the k winners; the rescan-merge kernel forms ``(|q|^2 + pn) -
2 q.x`` and the streaming kernel ``|q|^2 - (2 q.x - pn)``, both with norms
``pn`` precomputed in float32 from the unrounded corpus, as on the TPU.
The corpus streams at ``compute_dtype`` when one is given (int8 ignores
it), else at its stored width, and all three kernels multiply on the
tensor cores at that width; a bf16/f16 stream multiplies queries rounded
to its dtype; an int8 corpus multiplies queries quantised with its own
scale (``round(q / scale)`` clipped to [-127, 127]) and distances come back
times scale^2.  ``|q|^2`` always comes from the unrounded float32 queries.

Precision tiers (``matmul_precision``, the JAX package's ``_dist_dot``): a
float32 stream computes its dot products at "highest" (IEEE float32 in the
plain versions, three TF32 passes on the card, which rank alike), "split3"
(:func:`dot_split3`: each factor split into bf16 ``hi`` and ``lo``, the
products ``hi*hi + hi*lo + lo*hi`` in float32; three bf16 passes on the
card) or "default" (one pass of the factors rounded to bf16, as
``Precision.DEFAULT`` on the TPU); bf16, f16 and int8 streams ignore the
tier (:func:`stream_tier`).  Norms are float32 at every tier.

The rank kernel has two designs (:func:`rank_design`): the tile loop
(``csrc/knn_tile.cuh``) and, for a float32 stream at "highest", the Hopper
pipeline (``csrc/knn_wgmma_tf32.cuh``, :func:`rank_plan`), counted also
under ``launches["exact_knn:wgmma"]``.

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
from ..utils.profiling import span

KMAX = 128
_MAX_SPLITS = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}
# matmul_precision -> the tier code the kernels take (csrc/knn_mma.cuh)
TIER_CODE = {"highest": 0, "split3": 1, "default": 2}
_PRECISIONS = tuple(TIER_CODE)
COMPUTE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_CUDA_INVALID_VALUE = 1  # cudaErrorInvalidValue
PLAIN_TILE = 4096  # corpus rows per tile of the rescan-merge/stream plain versions

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
# one shared library per kernel source; the headers are part of every one
SOURCES = {"exact_knn": CSRC / "exact_knn.cu",
           "twophase_knn": CSRC / "twophase_knn.cu",
           "probe_knn": CSRC / "probe_knn.cu",
           "rescan_merge_knn": CSRC / "rescan_merge_knn.cu",
           "stream_knn": CSRC / "stream_knn.cu"}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# C entry points of each library: name -> argtypes (all return a CUDA error code)
_ENTRY_POINTS = {
    "exact_knn": {"exact_knn_launch": [_ci, _vp, _ci, _ci, _vp, _vp, _vp, _ci, _ci, _ci,
                                       _ci, _ci, _vp, _vp, _vp, _vp, ctypes.c_float,
                                       _vp],
                  "exact_knn_query_block": [], "exact_knn_tile_rows": [],
                  "exact_knn_wgmma_launch": [_ci, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci,
                                             _ci, _ci, _ci, _vp, _vp, _vp, _vp,
                                             ctypes.c_float, _vp],
                  "exact_knn_wgmma_query_block": [], "exact_knn_wgmma_tile_rows": [],
                  "exact_knn_wgmma_max_k": [], "exact_knn_wgmma_smem": [_ci, _ci, _ci]},
    "twophase_knn": {
        "twophase_emit_launch": [_ci, _vp, _ci, _ci, _vp, _vp, _ci, _ci, _ci, _ci, _ci,
                                 _ci, _vp, _vp, _vp],
        "twophase_rescan_launch": [_ci, _vp, _ci, _vp, _vp, _ci, _ci, _ci, _ci, _ci,
                                   _ci, _ci, _ci, _ci, _vp, _vp, _vp, _vp, _vp],
        "twophase_rescan_blocks_per_sm": [_ci, _ci],
        "twophase_knn_query_block": [], "twophase_knn_tile_rows": [],
        "twophase_emit_wgmma_launch": [_ci, _vp, _ci, _vp, _vp, _ci, _ci, _ci, _ci, _ci,
                                       _ci, _ci, _ci, _vp, _vp, _vp],
        "twophase_emit_wgmma_query_block": [], "twophase_emit_wgmma_tile_rows": [],
        "twophase_emit_wgmma_smem": [_ci, _ci],
    },
    "probe_knn": {"probe_topk_launch": [_ci, _vp, _ci, _vp, _vp, _ci, _ci, _ci, _ci, _ci,
                                        _ci, _ci, _ci, _ci, _ci, _ci, _vp, _vp, _vp],
                  "probe_tiles_workspace": [_ci] * 7,
                  "probe_tiles_block": [_ci] * 6 + [ctypes.c_longlong],
                  "probe_tiles_launch": [_ci, _vp, _ci, _vp, _vp, _ci, _ci, _ci, _ci, _ci,
                                         _ci, _ci, _ci, _vp, ctypes.c_longlong, _vp, _vp,
                                         _vp]},
    "rescan_merge_knn": {"exact_knn_rescan_launch": [_ci, _vp, _ci, _ci, _vp, _vp, _vp, _vp,
                                                     _ci, _ci, _ci, _ci, _ci, _vp, _vp, _vp,
                                                     _vp, ctypes.c_float, _vp],
                         "rescan_merge_knn_query_block": [], "rescan_merge_knn_tile_rows": []},
    "stream_knn": {"exact_knn_stream_launch": [_ci, _vp, _ci, _ci, _vp, _vp, _vp, _vp, _ci,
                                               _ci, _ci, _ci, _vp, _vp, ctypes.c_float, _vp]},
}

# entry points that return something other than a CUDA error code
_RESTYPES = {"probe_tiles_workspace": ctypes.c_longlong,
             "probe_tiles_block": ctypes.c_longlong}

# kernel launches through the wrappers, plain counts a run reads to show
# that its main path went through the kernels (the two-phase rescan counts
# its selecting launches, k <= 128, apart from its emit-all ones).  The four
# tensor-core kernels also count their launches at the bf16 tiers of a
# float32 stream under "<kernel>:split3" and "<kernel>:default" (the kernel's
# own key counts every launch).  "twophase_emit:wgmma" counts the emit
# launches of the Hopper pipeline (csrc/knn_wgmma.cuh) among "twophase_emit"'s,
# "exact_knn:wgmma" the rank launches of the float32 one
# (csrc/knn_wgmma_tf32.cuh) among "exact_knn"'s, "probe_topk:tiles" the
# probe launches of its tile design (ops/probe.py:probe_design) among
# "probe_topk"'s.  "twophase_calls" counts
# calls of the two-phase engine (ops/twophase.py:exact_knn_twophase), which
# launch the emit once a query block (ops/twophase.py:query_block).
TIERED = ("exact_knn", "exact_knn_rescan", "exact_knn_stream", "twophase_emit")
launches = {"exact_knn": 0, "twophase_emit": 0, "twophase_rescan": 0,
            "twophase_rescan_all": 0, "probe_topk": 0, "exact_knn_rescan": 0,
            "exact_knn_stream": 0, "twophase_emit:wgmma": 0, "exact_knn:wgmma": 0,
            "twophase_calls": 0, "probe_topk:tiles": 0,
            **{f"{name}:{tier}": 0 for name in TIERED for tier in ("split3", "default")}}
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
            getattr(lib, fn).restype = _RESTYPES.get(fn, _ci)
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes = [_ci]
        err_fn.restype = ctypes.c_char_p
        lib.error_string = err_fn
        _libs[name] = lib
    return _libs[name]


def launch_error(lib, what: str, err: int) -> RuntimeError:
    return RuntimeError(f"{what} kernel launch failed: "
                        + lib.error_string(err).decode())


def count_launch(key: str, tier: str) -> None:
    """One launch of kernel ``key`` at ``tier`` (:func:`stream_tier`)."""
    launches[key] += 1
    if tier != "highest":
        launches[f"{key}:{tier}"] += 1


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
    query-side conventions every version shares."""
    _check_scale(points, scale)
    q = queries
    scale2 = 1.0
    if points.dtype == torch.int8:
        s = torch.tensor(float(scale), dtype=torch.float32)
        scale2 = float(s * s)
        q = torch.clamp(torch.round(q / float(s)), -127, 127)
    return q.contiguous(), (q * q).sum(-1), scale2


def check_tpu_knobs(kw) -> None:
    """Raise ``ValueError`` on the JAX kernels' TPU tiling knobs (``tile``,
    ``query_block``, ``interpret``; one given as None is unset): the CUDA
    kernels pick their own tiles."""
    given = sorted(key for key in ("tile", "query_block", "interpret")
                   if kw.get(key) is not None)
    if given:
        raise ValueError(f"{given}: TPU tiling knobs of the JAX package's Pallas "
                         "kernels, with no counterpart on this package's CUDA kernels")


def exact_kernel(merge: str = "rank", stream: bool = False) -> str:
    """The kernel ``exact_knn`` runs for these knobs: "stream" (which takes
    precedence over ``merge``, as in the JAX package), "rank", "rescan"
    (the rescan merge) or "twophase" (the segment merge)."""
    if stream:
        return "stream"
    if merge not in ("rank", "rescan", "twophase"):
        raise ValueError(f"unknown merge style {merge!r}")
    return merge


def stream_dtype(dtype: torch.dtype, compute_dtype=None) -> torch.dtype:
    """The type a corpus of ``dtype`` streams at through the kernels:
    ``compute_dtype`` (float32, bfloat16 or float16) when one is given,
    else the stored type (float32 for a type no kernel takes); an int8
    corpus ignores the knob, as in the JAX package."""
    if compute_dtype is not None and compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype!r}")
    if dtype == torch.int8:
        return dtype
    if compute_dtype is not None:
        return compute_dtype
    return dtype if dtype in _DTYPE_CODE else torch.float32


def stream_tier(dtype: torch.dtype, matmul_precision: str) -> str:
    """The tier the kernels compute for a corpus streamed at ``dtype``
    (:func:`stream_dtype`): ``matmul_precision`` for float32, "highest" (no
    tier: one pass at storage width, int8 in int32) for the other types, as
    the JAX package decides it (``pallas_exact.py``'s ``f32_path``)."""
    _check_precision(matmul_precision)
    return matmul_precision if dtype == torch.float32 else "highest"


def split_bf16(x: torch.Tensor):
    """(hi, lo) bf16 with ``hi = bf16(x)`` and ``lo = bf16(x - hi)``, each
    rounded to nearest even (``.to(torch.bfloat16)``, as the JAX package's
    ``astype`` and the kernels' ``cvt.rn.bf16x2.f32``); ``x - hi`` is exact
    in float32.  The factors of :func:`dot_split3`."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def dot_split3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` ((m, d) x (n, d) -> (m, n) float32) at the "split3" tier,
    the JAX package's ``_dot_split3``: ``hi*hi + hi*lo + lo*hi`` of the
    :func:`split_bf16` factors, each product of two bf16 values exact in
    float32 and summed in float32 (``lo*lo``, 2^-16 of a product, dropped).
    Only the order of the sums differs from JAX's."""
    (ah, al), (bh, bl) = split_bf16(a), split_bf16(b)
    ah, al, bh, bl = ah.float(), al.float(), bh.float(), bl.float()
    return (ah @ bh.T + ah @ bl.T) + al @ bh.T


def dist_dot(q: torch.Tensor, x: torch.Tensor, tier: str) -> torch.Tensor:
    """The distance cross-term ``q @ x.T`` (float32 factors) at ``tier``
    (:func:`stream_tier`), the JAX package's ``_dist_dot``: IEEE float32
    ("highest"), :func:`dot_split3` ("split3"), or one product of the factors
    rounded to bf16, summed in float32 ("default")."""
    if tier == "split3":
        return dot_split3(q, x)
    if tier == "default":
        return q.to(torch.bfloat16).float() @ x.to(torch.bfloat16).float().T
    return q @ x.T


def compute_corpus(points: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """The corpus as the kernels stream it (:func:`stream_dtype`)."""
    cdt = stream_dtype(points.dtype, compute_dtype)
    return points if points.dtype == cdt else points.to(cdt)


def point_norms(points: torch.Tensor, chunk_rows: int = 1 << 18) -> torch.Tensor:
    """|x|^2 per row in float32 from the stored values, in row chunks (no
    corpus-sized float32 transient): the ``pn`` of the rescan-merge and
    streaming kernels."""
    n = points.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    for lo in range(0, n, chunk_rows):
        x = points[lo: lo + chunk_rows].float()
        out[lo: lo + chunk_rows] = (x * x).sum(-1)
    return out


def _round_queries(pts: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Queries rounded to a half corpus's type, as the kernels multiply them."""
    return q.to(pts.dtype).float() if pts.dtype in (torch.bfloat16, torch.float16) else q


def splits(m: int, n: int, sms: int, query_block: int, tile_rows: int) -> int:
    """Corpus splits of the rank kernel and the rescan merge on a card of
    ``sms`` SMs.  A block (``query_block`` queries, the corpus in
    ``tile_rows``-row tiles) fills an SM's shared memory, so the ceil(m /
    query_block) x s blocks run in ceil(blocks / sms) waves: the fewest s
    (at most the kernels' 32 and the corpus's tiles) whose waves keep at
    least 7/8 of the SMs busy, else the s that keeps the most busy."""
    q_blocks = -(-m // query_block)
    n_tiles = -(-n // tile_rows)

    def busy(s):
        return q_blocks * s / (-(-q_blocks * s // sms) * sms)

    cands = range(1, max(1, min(_MAX_SPLITS, n_tiles)) + 1)
    return next((s for s in cands if busy(s) >= 7 / 8), max(cands, key=busy))


def split_rows(n: int, n_splits: int, tile_rows: int, split_tiles: int = 1) -> int:
    """Corpus rows a split of the tile loop covers (``csrc/knn_tile.cuh:
    launch_tiled``): ceil(tiles / ``n_splits``) ``tile_rows``-row tiles,
    rounded up to a multiple of ``split_tiles`` (1 for the rank kernel and
    the rescan merge, a segment's tiles for emit); split s starts at s
    times this, and one past the corpus's end has no rows."""
    tiles = -(-(-(-n // tile_rows)) // n_splits)
    return -(-tiles // split_tiles) * split_tiles * tile_rows


# rows a lane group of csrc/knn_gather.cuh's row scorer keeps in flight
# (its ROWS), the least lanes a group takes
GATHER_ROWS = 4


def gather_geometry(d: int, itemsize: int, ptr: int = 0, *,
                    lanes: int | None = None) -> tuple[int, int]:
    """(bytes a load V, lanes a group G) of the row scorer the probe and
    the two-phase rescan share (``csrc/knn_gather.cuh``), for rows of
    ``d`` elements of ``itemsize`` bytes at data pointer ``ptr``: V is the
    widest of 16, 8, 4, 2 and 1 bytes that divides a row's bytes and the
    pointer; G is ``lanes`` or the smallest power of two that covers a
    row's V-byte vectors in two passes, within [:data:`GATHER_ROWS`, 32]
    (d = 128: 16 lanes in f32, 8 in bf16 and f16, 4 in int8; PERF.md §6
    has the reading that chose two passes)."""
    row_bytes = d * itemsize
    v = 16
    while row_bytes % v or ptr % v:
        v //= 2
    if lanes is None:
        half = -(-(row_bytes // v) // 2)  # vectors a pass
        lanes = min(32, max(GATHER_ROWS, 1 << (half - 1).bit_length()))
    if lanes & (lanes - 1) or not GATHER_ROWS <= lanes <= 32:
        raise ValueError(f"lanes={lanes} must be a power of two in [{GATHER_ROWS}, 32]")
    return v, lanes


# The rank kernel on the Hopper pipeline (csrc/knn_wgmma_tf32.cuh with
# exact_knn.cu:RankSelectWG): queries a work unit, corpus rows a tile,
# features a ring item, the widest row and the largest k it takes, the
# fewest and most ring slots, and the shared memory a block may use.
# :func:`_check_rank_geometry` holds them to the built library.
WG_RANK_QUERIES = 128
WG_RANK_TILE_ROWS = 128
WG_RANK_BOX = 16
WG_RANK_MAX_D = 128
WG_RANK_KMAX = 64
WG_RANK_STAGES = (4, 12)
SMEM_MAX = 232_448


def rank_boxes_per_item(d: int) -> int:
    """16-feature boxes a ring item of the Hopper rank kernel holds for rows
    of width d (``knn_wgmma_tf32.cuh:boxes_per_item``): two where a tile's
    boxes pair up, else one."""
    return 1 if -(-d // WG_RANK_BOX) % 2 else 2


def wgmma_rank_smem(stages: int, bpi: int, k: int) -> int:
    """Bytes of shared memory of a Hopper rank block (``knn_wgmma_tf32.cuh:
    smem_bytes``): alignment slack, ``stages`` ring slots of ``bpi`` hi and
    ``bpi`` lo boxes (128 rows x 64 bytes each), a norm slice a slot, the
    split's norm parts of two tiles (4 a row), three barriers a slot, the
    128 queries' sorted lists of k (score, id) pairs."""
    rows = WG_RANK_TILE_ROWS
    return 1024 + stages * 2 * bpi * rows * 64 + stages * rows * 4 + 2 * rows * 4 * 4 \
        + 3 * stages * 8 + WG_RANK_QUERIES * k * 8


def rank_design(dtype: torch.dtype, tier: str, d: int, k: int, m: int) -> str:
    """Which rank kernel serves m queries against a corpus streamed at
    ``dtype`` and ``tier`` (:func:`stream_tier`) of width ``d`` at ``k``:
    "wgmma" (the Hopper pipeline: TMA-fed ring, 3xTF32 on wgmma,
    top-k read from the accumulators) for float32 at "highest" with rows
    whose pitch is a multiple of 16 bytes (d a multiple of 4, TMA's stride
    rule) up to :data:`WG_RANK_MAX_D` features, k up to
    :data:`WG_RANK_KMAX` (the lists its shared memory holds beside the ring)
    and more than one block of :data:`WG_RANK_QUERIES` queries; "tile" (the
    tile loop of ``knn_tile.cuh``) for everything else: the bf16 tiers,
    bf16, f16, int8, other d and k, and one query block, whose at most 32
    work units (one a corpus split) leave most of the card idle
    (``chip_smoke.py:rank_designs`` times both designs on each side of the
    gate and fails where the routed one is slower)."""
    if (dtype == torch.float32 and tier == "highest" and d % 4 == 0
            and 4 <= d <= WG_RANK_MAX_D and 1 <= k <= WG_RANK_KMAX
            and m > WG_RANK_QUERIES):
        return "wgmma"
    return "tile"


def persistent_splits(n_qb: int, groups: int, sms: int,
                      cap: int | None = None) -> tuple[int, float]:
    """(splits, share of SM slots busy) of a persistent kernel's work units,
    ``n_qb`` query blocks x splits of whole row groups (``groups`` of them),
    on ``sms`` persistent blocks: the fewest splits (at most ``cap``) whose
    units keep at least 15/16 of the SMs busy over their waves (units of one
    split cost the same), else the count that keeps the most busy; counted
    as the non-empty ones.  The Hopper emit's and the Hopper rank kernel's
    plans."""
    def busy(s):
        units = n_qb * s
        return units / (-(-units // sms) * sms)

    best = 1
    for s in range(1, min(groups, cap or groups) + 1):  # s = sms has busy 1 where groups >> sms
        s_eff = -(-groups // -(-groups // s))  # as many as are non-empty
        if busy(s_eff) > busy(best):
            best = s_eff
        if busy(best) >= 15 / 16:
            break
    return best, busy(best)


def rank_plan(m: int, n: int, d: int, k: int, sms: int) -> dict:
    """The Hopper rank kernel's launch for m queries against n rows of width
    d at k on a card of ``sms`` SMs.  Work units are (block of 128 queries, corpus
    split); a split takes whole 128-row tiles; the splits are
    :func:`persistent_splits`' at most the split merge's 32.  The ring: the
    deepest (in items of
    :func:`rank_boxes_per_item` boxes) that fits beside the lists of k.
    Returns {"splits", "split_rows", "units", "blocks", "stages", "busy"}."""
    groups = -(-n // WG_RANK_TILE_ROWS)
    n_qb = -(-m // WG_RANK_QUERIES)
    bpi = rank_boxes_per_item(d)
    stages = max((s for s in range(WG_RANK_STAGES[0], WG_RANK_STAGES[1] + 1)
                  if wgmma_rank_smem(s, bpi, k) <= SMEM_MAX), default=0)
    if not stages:
        raise ValueError(f"no Hopper rank ring fits k = {k}")
    best, busy = persistent_splits(n_qb, groups, sms, _MAX_SPLITS)
    per = -(-groups // best) * WG_RANK_TILE_ROWS
    units = n_qb * best
    return {"splits": best, "split_rows": per, "units": units, "blocks": min(units, sms),
            "stages": stages, "busy": busy}


def _check_rank_geometry(lib) -> None:
    """The built library's Hopper rank geometry is the planner's."""
    got = (lib.exact_knn_wgmma_query_block(), lib.exact_knn_wgmma_tile_rows(),
           lib.exact_knn_wgmma_max_k(), lib.exact_knn_wgmma_smem(4, 2, 10))
    want = (WG_RANK_QUERIES, WG_RANK_TILE_ROWS, WG_RANK_KMAX, wgmma_rank_smem(4, 2, 10))
    if got != want:
        raise RuntimeError(f"exact_knn's Hopper rank geometry {got} is not the planner's {want}")


def tile_geometry(name: str) -> tuple[int, int]:
    """(queries per block, corpus rows per tile) of the rank kernel
    (``name="exact_knn"``), the rescan merge (``"rescan_merge_knn"``) or the
    two-phase emit kernel (``"twophase_knn"``), read from the built
    library."""
    lib = _library(name)
    return getattr(lib, f"{name}_query_block")(), getattr(lib, f"{name}_tile_rows")()


def exact_knn(points: torch.Tensor, queries: torch.Tensor, k: int, *,
              exclude: torch.Tensor | None = None, scale=None,
              matmul_precision: str = "highest", merge: str = "rank",
              twophase_seg: int = 512, stream: bool = False, compute_dtype=None,
              tile=None, query_block=None, interpret=None):
    """Exact k nearest neighbours through a CUDA kernel (CUDA tensors) or its
    plain version (CPU tensors): the rank kernel (``merge="rank"``), the
    rescan-merge kernel (``merge="rescan"``) or the streaming kernel
    (``stream=True``, which takes precedence over ``merge``).  Returns
    (ids (m, k) int32, squared distances (m, k) float32).
    ``matmul_precision`` is the tier of a float32 stream (see the module
    docstring): on the tensor cores "highest" is three TF32 passes with
    fp32 accumulation (which ranks as IEEE fp32 does), "split3" three bf16
    passes, "default" one, in all three kernels and the two-phase emit;
    bf16 and f16 streams multiply in one pass at storage width (queries
    rounded to it) and int8 in int32, whatever the tier (see the kernel
    sources).  ``compute_dtype`` (torch.float32, bfloat16
    or float16) is the width the corpus streams at; see the module
    docstring for the norms each kernel takes.  The JAX kernels' TPU knobs
    (``tile``, ``query_block``, ``interpret``) raise ``ValueError``.  The
    rank kernel's CUDA route is the span ``exact.rank``.

    ``merge="twophase"`` is the JAX package's two-phase merge: the emit
    kernel's per-``twophase_seg``-row segment minima, then the k best of
    them per query (one candidate per segment, so not exact on its own;
    :func:`~.twophase.exact_knn_twophase` is the exact engine).  It takes
    any k."""
    check_tpu_knobs({"tile": tile, "query_block": query_block, "interpret": interpret})
    kernel = exact_kernel(merge, stream)
    _check(points, queries, k, exclude, matmul_precision)
    if kernel == "twophase":
        from .twophase import segment_merge

        return segment_merge(compute_corpus(points, compute_dtype), queries, k, twophase_seg,
                             exclude=exclude, scale=scale,
                             matmul_precision=matmul_precision)
    if k > KMAX:
        raise ValueError(f"exact_knn supports k <= {KMAX}, got {k}")
    if points.device.type == "cpu":
        plain = {"rank": exact_knn_plain, "rescan": exact_knn_rescan_plain,
                 "stream": exact_knn_stream_plain}[kernel]
        return plain(points, queries, k, exclude=exclude, scale=scale,
                     matmul_precision=matmul_precision, compute_dtype=compute_dtype)
    if points.device.type != "cuda":
        raise ValueError(f"exact_knn runs on cuda or cpu, not {points.device}")
    if not points.is_contiguous():
        raise ValueError("points must be contiguous")
    if exclude is not None:
        exclude = exclude.contiguous()
    if kernel == "stream":
        return stream_cuda(points, queries, k, exclude=exclude, scale=scale,
                           compute_dtype=compute_dtype, matmul_precision=matmul_precision)
    if kernel == "rescan":
        pts, q, qn, pn, scale2 = _replace_worst_inputs(points, queries, scale, compute_dtype)
        return _split_launch("rescan_merge_knn", "exact_knn_rescan", pts, q, qn, pn, k,
                             exclude, scale2, stream_tier(pts.dtype, matmul_precision))
    with span("exact.rank", rows=queries.shape[0]):
        pts = compute_corpus(points, compute_dtype)
        q, qn, scale2 = _prepare(pts, queries, scale)
        return _split_launch("exact_knn", "exact_knn", pts, q, qn, None, k, exclude, scale2,
                             stream_tier(pts.dtype, matmul_precision))


def _empty(k: int, dev):
    return (torch.empty((0, k), dtype=itype, device=dev),
            torch.empty((0, k), dtype=torch.float32, device=dev))


def _split_launch(name: str, key: str, pts, q, qn, pn, k: int, exclude, scale2, tier: str):
    """Launch the corpus-split kernel of library ``name``: the rank kernel
    (``"exact_knn"``, ``pn`` None; of :func:`rank_design`'s design) or the
    rescan merge (``"rescan_merge_knn"``, which takes the point norms ``pn``
    after ``qn``), at precision ``tier`` (:func:`stream_tier`); per (query
    block, corpus split) a running top-k, then a merge of the splits'
    ascending lists."""
    n, d = pts.shape
    m = q.shape[0]
    dev = pts.device
    if m == 0:
        return _empty(k, dev)
    # rows are copied in 16-byte units where their width allows
    if pts.data_ptr() % 16:
        pts = pts.clone()
    lib = _library(name)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if pn is None and rank_design(pts.dtype, tier, d, k, m) == "wgmma":
        return _rank_wgmma(lib, pts, q, qn, k, exclude, scale2, sms)
    s = splits(m, n, sms, *tile_geometry(name))
    part_d = torch.empty((m, s, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((m, s, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, k), dtype=itype, device=dev)
    head = (device_index(dev), pts.data_ptr(), _DTYPE_CODE[pts.dtype], TIER_CODE[tier],
            q.data_ptr(), exclude.data_ptr() if exclude is not None else None, qn.data_ptr())
    tail = (n, d, m, k, s, part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), scale2, torch.cuda.current_stream(dev).cuda_stream)
    if pn is None:
        err = lib.exact_knn_launch(*head, *tail)
    else:
        err = lib.exact_knn_rescan_launch(*head, pn.data_ptr(), *tail)
    if err != 0:
        raise launch_error(lib, key, err)
    count_launch(key, tier)
    return out_i, out_d


def _rank_wgmma(lib, pts, q, qn, k: int, exclude, scale2, sms: int):
    """The rank kernel on the Hopper pipeline (:func:`rank_design` said
    "wgmma"), launched as :func:`rank_plan` plans it, then the split merge;
    counted under ``launches["exact_knn"]`` and ``["exact_knn:wgmma"]``."""
    n, d = pts.shape
    m = q.shape[0]
    dev = pts.device
    _check_rank_geometry(lib)
    plan = rank_plan(m, n, d, k, sms)
    s = plan["splits"]
    part_d = torch.empty((m, s, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((m, s, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, k), dtype=itype, device=dev)
    err = lib.exact_knn_wgmma_launch(
        device_index(dev), pts.data_ptr(), q.data_ptr(),
        exclude.data_ptr() if exclude is not None else None, qn.data_ptr(), n, d, m, k,
        plan["split_rows"], s, plan["stages"], plan["blocks"], part_d.data_ptr(),
        part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), scale2,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise launch_error(lib, "exact_knn", err)
    count_launch("exact_knn", "highest")
    launches["exact_knn:wgmma"] += 1
    return out_i, out_d


def _replace_worst_inputs(points, queries, scale, compute_dtype):
    """(corpus as streamed, queries (quantised for int8), |q|^2 from the
    unrounded queries, pn from the unrounded corpus, scale^2): the inputs
    the rescan-merge and streaming kernels and their plain versions share."""
    q, qn, scale2 = _prepare(points, queries, scale)
    pts = compute_corpus(points, compute_dtype).contiguous()
    return pts, q, qn, point_norms(points), scale2


def stream_cuda(points, queries, k: int, *, exclude=None, scale=None, compute_dtype=None,
                matmul_precision: str = "highest"):
    """The streaming kernel (``csrc/stream_knn.cu``) on checked CUDA
    inputs: one block per 8 queries walks the whole corpus through a ring
    of shared-memory tiles and multiplies on the tensor cores (float32 at
    "highest" in three TF32 passes, see :func:`split_tf32`, at "split3" and
    "default" in three or one bf16 passes; bf16, f16 and int8 at storage
    width)."""
    pts, q, qn, pn, scale2 = _replace_worst_inputs(points, queries, scale, compute_dtype)
    tier = stream_tier(pts.dtype, matmul_precision)
    n, d = pts.shape
    m = q.shape[0]
    dev = pts.device
    if m == 0:
        return _empty(k, dev)
    # rows are copied in 16-byte units where their width allows
    if pts.data_ptr() % 16:
        pts = pts.clone()
    out_d = torch.empty((m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, k), dtype=itype, device=dev)
    lib = _library("stream_knn")
    err = lib.exact_knn_stream_launch(
        device_index(dev), pts.data_ptr(), _DTYPE_CODE[pts.dtype], TIER_CODE[tier],
        q.data_ptr(), exclude.data_ptr() if exclude is not None else None, qn.data_ptr(),
        pn.data_ptr(),
        n, d, m, k, out_d.data_ptr(), out_i.data_ptr(), scale2,
        torch.cuda.current_stream(dev).cuda_stream)
    if err == _CUDA_INVALID_VALUE:
        raise ValueError("stream=True holds two corpus tiles (of 16 rows at least) in a "
                         f"block's shared memory: d = {d} at {pts.element_size()} bytes a "
                         f"value with k = {k} does not fit")
    if err != 0:
        raise launch_error(lib, "exact_knn_stream", err)
    count_launch("exact_knn_stream", tier)
    return out_i, out_d


def exact_knn_plain(points: torch.Tensor, queries: torch.Tensor, k: int, *,
                    exclude: torch.Tensor | None = None, scale=None,
                    matmul_precision: str = "highest", compute_dtype=None):
    """Plain PyTorch version of the rank kernel, same contract and score
    domain: a float32 matmul per query block at the tier (:func:`dist_dot`),
    a stable sort (ties to the smaller id), |q|^2 added to the winners; the
    norms are those of the corpus as streamed (rounded to
    ``compute_dtype``).  Takes any k (a check may ask for k + 1 to see the
    boundary)."""
    _check(points, queries, k, exclude, matmul_precision)
    points = compute_corpus(points, compute_dtype)
    tier = stream_tier(points.dtype, matmul_precision)
    n = points.shape[0]
    m = queries.shape[0]
    q, qn, scale2 = _prepare(points, queries, scale)
    q = _round_queries(points, q)
    x = points.float()
    pn = (x * x).sum(-1)
    kk = min(k, n)
    block = max(1, min(m, (64 << 20) // n))  # (block, n) score rows ~256 MB
    vals, ids = [], []
    for lo in range(0, m, block):
        s = pn[None, :] - 2.0 * dist_dot(q[lo: lo + block], x, tier)
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


def _replace_worst_plain(points, queries, k, *, exclude, scale, matmul_precision,
                         compute_dtype, tile, stream):
    """The rescan-merge (``stream=False``) or streaming kernel's algorithm in
    plain PyTorch, the TPU kernels' own loop: per ``tile``-row corpus tile
    the distances (``(qn + pn) - 2 q.x``, or ``qn - s`` with ``s = 2 q.x -
    pn`` for the stream; ``q.x`` at the tier, :func:`dist_dot`), a skip
    test against each query's running worst, then at most k rounds in
    which the tile's smallest (distance, id) replaces the worst running
    slot (ties to the smallest slot) while it beats it; at the end the
    unsorted running k in ascending order."""
    _check(points, queries, k, exclude, matmul_precision)
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    pts, q, qn, pn, scale2 = _replace_worst_inputs(points, queries, scale, compute_dtype)
    q = _round_queries(pts, q)
    tier = stream_tier(pts.dtype, matmul_precision)
    n = pts.shape[0]
    m = q.shape[0]
    dev = pts.device
    inf = float("inf")
    big = torch.iinfo(torch.int64).max
    slots = torch.arange(k, device=dev)
    run_d = torch.full((m, k), inf, device=dev)
    run_i = torch.full((m, k), n, dtype=torch.int64, device=dev)
    ex = exclude.long() if exclude is not None else None
    block = max(1, min(m, (64 << 20) // tile))  # (block, tile) distances ~256 MB
    for lo in range(0, m, block):
        hi = min(m, lo + block)
        qb, qnb = q[lo:hi], qn[lo:hi]
        rd, ri = run_d[lo:hi], run_i[lo:hi]  # views: updated in place
        rows = torch.arange(hi - lo, device=dev)
        for t0 in range(0, n, tile):
            x = pts[t0: t0 + tile].float()
            gids = torch.arange(t0, t0 + x.shape[0], device=dev)
            dots = dist_dot(qb, x, tier)
            pnt = pn[t0: t0 + tile]
            masked = (gids[None, :] == ex[lo:hi, None]) if ex is not None else None
            worst = rd.max(1).values
            if stream:
                s = 2.0 * dots - pnt[None, :]
                smax = (s if masked is None else s.masked_fill(masked, -inf)).max(1).values
                if not bool((qnb - smax < worst).any()):
                    continue
                dd = qnb[:, None] - s
            else:
                dd = (qnb[:, None] + pnt[None, :]) - 2.0 * dots
            if masked is not None:
                dd = dd.masked_fill(masked, inf)
            if not stream and not bool((dd.min(1).values < worst).any()):
                continue
            for _ in range(k):
                dmin = dd.min(1).values
                imin = torch.where(dd == dmin[:, None], gids, big).min(1).values
                wmax = rd.max(1).values
                wslot = torch.where(rd == wmax[:, None], slots, k).min(1).values
                hit = dmin < wmax
                if not bool(hit.any()):
                    break
                rd[rows[hit], wslot[hit]] = dmin[hit]
                ri[rows[hit], wslot[hit]] = imin[hit]
                dd[rows, imin - t0] = inf
    # ascending extraction of the running k
    out_d, out_i = [], []
    for _ in range(k):
        dmin = run_d.min(1).values
        imin = torch.where(run_d == dmin[:, None], run_i, big).min(1).values
        imin = torch.where(torch.isinf(dmin), n, imin)
        out_d.append(dmin)
        out_i.append(imin)
        run_d = torch.where(run_i == imin[:, None], inf, run_d)
    return torch.stack(out_i, 1).to(itype), torch.stack(out_d, 1) * scale2


def exact_knn_rescan_plain(points: torch.Tensor, queries: torch.Tensor, k: int, *,
                           exclude: torch.Tensor | None = None, scale=None,
                           matmul_precision: str = "highest", compute_dtype=None,
                           tile: int = PLAIN_TILE):
    """Plain PyTorch version of the rescan-merge kernel (JAX ``_kernel``):
    distances ``(|q|^2 + pn) - 2 q.x`` with ``pn`` from the unrounded
    corpus, the unsorted replace-the-worst merge over ``tile``-row tiles
    (see :func:`_replace_worst_plain`).  Takes any k."""
    return _replace_worst_plain(points, queries, k, exclude=exclude, scale=scale,
                                matmul_precision=matmul_precision,
                                compute_dtype=compute_dtype, tile=tile, stream=False)


def exact_knn_rescan_plain_by_splits(points: torch.Tensor, queries: torch.Tensor, k: int,
                                     n_splits: int, tile_rows: int, *,
                                     exclude: torch.Tensor | None = None, **kw):
    """The rescan merge's plain version as the kernel's grid runs it: the
    corpus in ``n_splits`` ranges of whole ``tile_rows``-row tiles, each
    walked on its own at the kernel's tiles, then the ranges' ascending
    lists merged by (distance, id).  Among equal distances the
    replace-the-worst merge keeps ids by the order it meets them, so this,
    not one walk over the whole corpus, is what the kernel equals bit for
    bit.  ``kw`` goes to :func:`exact_knn_rescan_plain`."""
    n = points.shape[0]
    per = split_rows(n, n_splits, tile_rows)
    ids, dists = [], []
    for lo in range(0, n, per):
        e = None if exclude is None else exclude - lo
        i, dd = exact_knn_rescan_plain(points[lo: lo + per], queries, k, exclude=e,
                                       tile=tile_rows, **kw)
        ids.append(torch.where(i < min(per, n - lo), i + lo, n))
        dists.append(dd)
    ids, dists = torch.cat(ids, 1), torch.cat(dists, 1)
    order = torch.sort(ids, dim=1, stable=True).indices
    ids, dists = ids.gather(1, order), dists.gather(1, order)
    order = torch.sort(dists, dim=1, stable=True).indices[:, :k]
    return ids.gather(1, order).to(itype), dists.gather(1, order)


def exact_knn_stream_plain(points: torch.Tensor, queries: torch.Tensor, k: int, *,
                           exclude: torch.Tensor | None = None, scale=None,
                           matmul_precision: str = "highest", compute_dtype=None,
                           tile: int = PLAIN_TILE):
    """Plain PyTorch version of the streaming kernel (JAX ``_stream_kernel``):
    the skip test on ``s = 2 q.x - pn`` before any distance exists, then
    distances ``|q|^2 - s`` in the merge branch (about an ulp from the
    rescan merge's association), the same replace-the-worst merge.  Takes
    any k."""
    return _replace_worst_plain(points, queries, k, exclude=exclude, scale=scale,
                                matmul_precision=matmul_precision,
                                compute_dtype=compute_dtype, tile=tile, stream=True)


def stream_query_block() -> int:
    """Queries per block of the streaming kernel, read from its built
    library: a call with m queries runs ceil(m / this) blocks, each of which
    reads the whole corpus."""
    return _library("stream_knn").exact_knn_stream_query_block()


def split_tf32(x: torch.Tensor):
    """(hi, lo) with ``x = hi + lo`` up to 2^-22 |x|, both representable in
    TF32 (10 mantissa bits): ``hi`` is float32 ``x`` rounded to TF32 (to
    nearest, ties away from zero, as ``cvt.rna.tf32.f32``) by integer
    arithmetic on its bits, ``lo`` the remainder rounded the same way.
    The split the streaming kernel makes in registers; its float32 dot
    product is the sum of ``lo*hi + hi*lo + hi*hi``."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        # the magnitude sits in the low 31 bits: adding half a TF32 ulp and
        # clearing the 13 dropped bits rounds it, ties away from zero
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def exact_knn_self(points: torch.Tensor, k: int, **kw):
    """Exact kNN graph with self-exclusion (``kw`` as :func:`exact_knn`)."""
    n = points.shape[0]
    excl = torch.arange(n, dtype=torch.int32, device=points.device)
    q = points if points.dtype == torch.float32 else points.float()
    return exact_knn(points, q, k, exclude=excl, **kw)


def abs_max(points: torch.Tensor, chunk_rows: int = 1 << 20) -> torch.Tensor:
    """max|x| over ``points`` as a () float32 tensor on their device, in
    row chunks so no corpus-sized float32 transient is made."""
    mx = torch.zeros((), dtype=torch.float32, device=points.device)
    for lo in range(0, points.shape[0], chunk_rows):
        mx = torch.maximum(mx, points[lo: lo + chunk_rows].float().abs().max())
    return mx


def quantize_corpus(points: torch.Tensor, scale=None,
                    chunk_rows: int = 1 << 20):
    """Symmetric int8 quantization for the exact engine's int8 tier:
    (rows int8 (n, d), scale () float32) with rows = round(x / scale)
    clipped to [-127, 127] and scale = max|x| / 127 by default.  Works in
    row chunks so no corpus-sized float32 transient is made."""
    n = points.shape[0]
    if scale is None:
        scale = abs_max(points, chunk_rows) / 127.0
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
    on a CUDA corpus the two-phase engine at n >= ``TWOPHASE_MIN_N`` (where
    this card's crossover puts it) and for k > 128, the rank kernel below
    that, brute force on the card for k > 128 close to n; on the CPU the
    float oracle
    (:func:`brute_force_knn`), as the JAX package does off the TPU.
    ``kw`` takes the two-phase knobs (``seg``, ``pad_segments``,
    ``rescan``) and :func:`exact_knn`'s (``merge``, ``twophase_seg``,
    ``stream``, ``compute_dtype``); pinning one of the latter keeps the
    kernel family of :func:`exact_knn` (rank, rescan merge, stream), as in
    the JAX package.  The JAX kernels' TPU knobs (``tile``,
    ``query_block``, ``interpret``) raise ``ValueError``.
    ``no_twophase`` escapes the n >= ``TWOPHASE_MIN_N`` route only: past
    k = 128 there is no rank kernel to escape to.  An int8 corpus needs
    its ``scale``; on the CPU it is dequantised, and the queries snapped
    to the same grid, so both rank the same quantized values.  A bf16/f16
    corpus is ranked on the CPU in float32 from its stored values.  Takes
    tensors or array-likes (placed by :func:`place`)."""
    check_tpu_knobs(kw)
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
            kw = {key: v for key, v in kw.items() if key not in TWOPHASE_ONLY_KW}
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
