"""The exact two-phase engine: segment emit, segment pick, window rescan.

Port of ``approximatenn_tpu/ops/pallas_exact.py:exact_knn_twophase`` with
its two TPU kernels, ``_kernel_emit`` and ``_kernel_rescan``, written for
Hopper in ``csrc/twophase_knn.cu``.  Each kernel has a plain PyTorch
version here; a wrapper runs the plain version for CPU tensors and the
kernel for CUDA tensors, never anything else.

1. Emit (:func:`segment_minima`): for every query and every ``seg``-row
   segment (segment s is rows ``[s*seg, min((s+1)*seg, n))``), the least
   score ``|x|^2 - 2 q.x`` and its row id, ties to the smaller id.
2. Pick (:func:`segment_merge`): per query the ``P = k + pad_segments``
   segments with the smallest minima (score + ``|q|^2``), ties to the
   smaller id.
3. Rescan (:func:`rescan_windows`): the rows of those P segments, squared
   L2 in diff form ``sum((x - q)^2)`` in fp32, and the k nearest; for
   k > 128 every window row is returned and the final top-k runs here.

Exactness (the JAX docstring's argument): the k-th smallest segment minimum
is a true distance, so every true top-k member lies in a segment whose
minimum ranks among the k best; the ``pad_segments`` extra segments absorb
ties.  It holds for any segment length, so the TPU's tile, VMEM and DMA
alignment constraints on ``seg`` are not ported, nor the clamped windows
and the tail merge they forced.
"""

from __future__ import annotations

import math

import torch

from ..config import itype
from ..utils.profiling import span
from .exact import (_DTYPE_CODE, KMAX, SMEM_MAX, TIER_CODE, _check, _prepare, count_launch,
                    device_index, dist_dot, gather_geometry, launch_error, launches,
                    persistent_splits, place, splits, stream_tier, tile_geometry, _library)

# From this corpus size exact serving takes the two-phase engine, for every
# row type.  Two-phase / rank on an H100 (chip_smoke.py's crossover, m =
# 1000, k = 10; PERF.md): float32 1.14-1.54 at 250k-4M rows and 1.10-1.12
# at 8M-10M against the tile-loop rank kernel, so the threshold is the exact
# engine's own limit (engine/serving.py:EXACT_MAX_N_DEFAULT); bf16 0.889 at
# 250k down to 0.167 at 10M with the Hopper emit.  Per-type: ROADMAP.md P2.
TWOPHASE_MIN_N = 8_000_000
# keywords exact_knn_twophase takes; any other (merge, stream, compute_dtype)
# pins exact_knn's kernel family: rank, rescan merge or stream
TWOPHASE_KW = frozenset({"seg", "pad_segments", "scale", "rescan",
                         "matmul_precision"})
# two-phase-only knobs, dropped before a rank-kernel dispatch
TWOPHASE_ONLY_KW = ("seg", "pad_segments", "rescan")

_INT32_MAX = 2**31 - 1
_BLOCK_ELEMS = 64 << 20  # plain versions: ~256 MB float32 per query block
# (query, segment) pairs of one query block of the engine: the emit's
# minima and ids take 8 bytes a pair and the segment pick's keys and
# temporaries ~32 more, so a block peaks near 21 GB beside the corpus.  A
# batch within it is one block (10,000 queries against 10M rows at seg 512
# is 1.95e8 pairs); past it the blocks are whole 128-query emit units
# (1,024 queries against 250M rows).
BLOCK_PAIRS = 1 << 29


def auto_seg(n: int) -> int:
    """The JAX package's segment length, ~sqrt(n)/8 as a power of two in
    [32, 512] (64 at 250k-500k, 128 at 1M, 512 at 10M)."""
    return min(512, max(32, 1 << (math.isqrt(n) // 8).bit_length()))


def _check_seg(seg: int) -> None:
    if seg < 1 or seg & (seg - 1):
        raise ValueError(f"seg must be a power of two, got {seg}")


def big_k_route(n: int, k: int) -> bool:
    """k > 128 takes the two-phase engine (emit-all rescan) unless k is
    close to n, as in the JAX package."""
    return KMAX < k < n and n >= 8 * (k + 2)


def takes_twophase(n: int, k: int, itemsize: int = 4, min_n: int = TWOPHASE_MIN_N) -> bool:
    """The build's half of :func:`route` for k <= 128 over n rows of
    ``itemsize`` bytes (the servers' ``_twophase``, ``search_exact_sharded``'s
    default): n >= ``min_n``, k + 2 <= 128, rows of at most 4 bytes."""
    return n >= min_n and k + 2 <= KMAX and itemsize <= 4


def route(n: int, k: int, kw, no_twophase: bool = False,
          min_n: int = TWOPHASE_MIN_N) -> str:
    """The engine an exact search runs on a CUDA corpus of n rows:
    "twophase", "rank" (:func:`~.exact.exact_knn`, whose ``merge`` and
    ``stream`` pick its kernel) or "brute" (``kw``: the extra keywords given;
    ``min_n``: the corpus size from which k <= 128 takes the two-phase
    engine).  The one routing rule of ``exact_search``, ``Server`` and
    ``ShardedServer``; ``no_twophase`` escapes :func:`takes_twophase` only."""
    tp_ok = set(kw) <= TWOPHASE_KW
    if k <= KMAX:
        tp = tp_ok and not no_twophase and takes_twophase(n, k, min_n=min_n)
        return "twophase" if tp else "rank"
    return "twophase" if tp_ok and big_k_route(n, k) else "brute"


def query_block(m: int, n_seg: int) -> int:
    """Queries a block of :func:`exact_knn_twophase` for m queries against
    ``n_seg`` segments: all m where the pairs fit :data:`BLOCK_PAIRS`, else
    as many as fit, in whole :data:`WG_QUERIES`-query units where one fits
    (at least one query)."""
    if m * n_seg <= BLOCK_PAIRS:
        return max(m, 1)
    per = BLOCK_PAIRS // n_seg
    if per >= WG_QUERIES:
        per -= per % WG_QUERIES
    return max(1, per)


def smallest(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Per row, the k smallest (distance, id) pairs in ascending order, ties
    to the smaller id, padded with (int32 max, +inf) past the row length.
    One ``torch.topk`` over int64 keys: the float's bits mapped to an
    order-preserving int32 in the high word, the id in the low word, so the
    order is total and does not depend on the selection algorithm."""
    L = dists.shape[-1]
    kk = min(k, L)
    b = (dists + 0.0).view(torch.int32)  # + 0.0 turns -0.0 into +0.0
    b = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    key = (b.to(torch.int64) << 32) | ids.to(torch.int64)
    _, j = torch.topk(key, kk, dim=-1, largest=False, sorted=True)
    out_d, out_i = dists.gather(-1, j), ids.gather(-1, j).to(itype)
    if kk < k:
        shape = out_d.shape[:-1] + (k - kk,)
        out_d = torch.cat([out_d, out_d.new_full(shape, float("inf"))], dim=-1)
        out_i = torch.cat([out_i, out_i.new_full(shape, _INT32_MAX)], dim=-1)
    return out_d, out_i


# -- phase 1: the emit kernels and their plain version -------------------------

# The Hopper emit (csrc/knn_wgmma.cuh with twophase_knn.cu:EmitSelectWG):
# queries a work unit, corpus rows a ring stage, features a swizzled chunk,
# the widest row it takes and the fewest and most ring stages (the shared
# memory a block may use is ``exact.SMEM_MAX``).  ``segment_minima`` checks
# the first two and the shared memory against the built library.
WG_QUERIES = 128
WG_TILE_ROWS = 256
WG_CHUNK = 32
WG_MAX_D = 128
WG_STAGES = (3, 8)
# segments staged a query (EmitSelectWG::SB), staging row stride SB + 1
_WG_STATE = 2 * 64 * 17 * 8


def wgmma_smem(stages: int, chunks: int) -> int:
    """Bytes of shared memory of a Hopper emit block (``knn_wgmma.cuh:
    smem_bytes``): alignment slack, ``stages`` ring stages of ``chunks``
    chunks of 256 rows x 64 bytes, a norm slice and three barriers a
    stage, the selection step's staging."""
    return 1024 + stages * chunks * WG_TILE_ROWS * 64 + stages * WG_TILE_ROWS * 4 \
        + 3 * stages * 8 + _WG_STATE


def emit_design(dtype: torch.dtype, d: int, seg: int) -> str:
    """Which emit kernel serves a corpus of ``dtype`` and width ``d`` at
    segments of ``seg`` rows: "wgmma" (the Hopper pipeline: TMA-fed ring,
    wgmma, segment minima reduced in registers) for bf16 and f16 rows whose
    pitch is a multiple of 16 bytes (d a multiple of 8, TMA's stride rule)
    up to :data:`WG_MAX_D` features, at ``seg`` >= 8 (a quad's columns);
    "tile" (the tile loop of ``knn_tile.cuh``) for everything else: float32
    at every tier, int8, other d, ``seg`` < 8."""
    if (dtype in (torch.bfloat16, torch.float16) and d % 8 == 0 and 8 <= d <= WG_MAX_D
            and seg >= 8):
        return "wgmma"
    return "tile"


def emit_plan(m: int, n: int, d: int, seg: int, sms: int) -> dict:
    """The Hopper emit's launch for m queries against n rows of width d at
    ``seg``-row segments on a card of ``sms`` SMs.  Work units are (block of
    128 queries, corpus split); a split takes whole groups of max(seg, 256)
    rows, so a segment is never cut and every pair is written once; the
    splits are :func:`~.exact.persistent_splits`'.  The ring: the deepest
    that fits (at most 8 stages).
    Returns {"splits", "split_rows", "units", "blocks", "stages", "busy"}."""
    group = max(seg, WG_TILE_ROWS)
    groups = -(-n // group)
    n_qb = -(-m // WG_QUERIES)
    chunks = -(-d // WG_CHUNK)
    stages = max((s for s in range(WG_STAGES[0], WG_STAGES[1] + 1)
                  if wgmma_smem(s, chunks) <= SMEM_MAX), default=0)
    if not stages:
        raise ValueError(f"no Hopper emit ring fits d = {d}")
    best, busy = persistent_splits(n_qb, groups, sms)
    per = -(-groups // best) * group
    units = n_qb * best
    return {"splits": best, "split_rows": per, "units": units, "blocks": min(units, sms),
            "stages": stages, "busy": busy}


def segment_minima(points: torch.Tensor, queries: torch.Tensor, seg: int, *,
                   exclude: torch.Tensor | None = None, scale=None,
                   matmul_precision: str = "highest"):
    """Phase 1: per query and ``seg``-row segment, the least score
    ``|x|^2 - 2 q.x`` and its id, as (minima (m, ceil(n/seg)) float32, ids
    int32); rows past n and the excluded id score +inf, ties go to the
    smaller id; ``q.x`` at ``matmul_precision``'s tier for a float32 corpus
    (:func:`~.exact.stream_tier`).  On a CUDA tensor one launch of the emit
    kernel :func:`emit_design` names: the Hopper pipeline (counted also
    under ``launches["twophase_emit:wgmma"]``) or the tile loop;
    :func:`segment_minima_plain` on a CPU tensor."""
    _check(points, queries, 1, exclude, matmul_precision)
    _check_seg(seg)
    if points.device.type == "cpu":
        return segment_minima_plain(points, queries, seg, exclude=exclude,
                                    scale=scale, matmul_precision=matmul_precision)
    if points.device.type != "cuda":
        raise ValueError(f"segment_minima runs on cuda or cpu, not {points.device}")
    if not points.is_contiguous():
        raise ValueError("points must be contiguous")
    n, d = points.shape
    m = queries.shape[0]
    dev = points.device
    n_seg = -(-n // seg)
    seg_d = torch.empty((m, n_seg), dtype=torch.float32, device=dev)
    seg_i = torch.empty((m, n_seg), dtype=torch.int32, device=dev)
    if m == 0:
        return seg_d, seg_i
    q, _, _ = _prepare(points, queries, scale)
    if exclude is not None:
        exclude = exclude.contiguous()
    # rows are copied in 16-byte units where their width allows
    if points.data_ptr() % 16:
        points = points.clone()
    lib = _library("twophase_knn")
    tier = stream_tier(points.dtype, matmul_precision)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if emit_design(points.dtype, d, seg) == "wgmma":
        _check_wgmma_geometry(lib)
        plan = emit_plan(m, n, d, seg, sms)
        err = lib.twophase_emit_wgmma_launch(
            device_index(dev), points.data_ptr(), _DTYPE_CODE[points.dtype], q.data_ptr(),
            exclude.data_ptr() if exclude is not None else None, n, d, m, seg, n_seg,
            plan["split_rows"], plan["stages"], plan["blocks"], seg_d.data_ptr(),
            seg_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise launch_error(lib, "twophase_emit", err)
        count_launch("twophase_emit", tier)
        launches["twophase_emit:wgmma"] += 1
        return seg_d, seg_i
    # the rank kernel's grid; the kernel rounds a split up to whole segments
    s = splits(m, n, sms, *tile_geometry("twophase_knn"))
    err = lib.twophase_emit_launch(
        device_index(dev), points.data_ptr(), _DTYPE_CODE[points.dtype], TIER_CODE[tier],
        q.data_ptr(),
        exclude.data_ptr() if exclude is not None else None, n, d, m, seg, n_seg, s,
        seg_d.data_ptr(), seg_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise launch_error(lib, "twophase_emit", err)
    count_launch("twophase_emit", tier)
    return seg_d, seg_i


def _check_wgmma_geometry(lib) -> None:
    """The built library's Hopper emit geometry is the planner's."""
    got = (lib.twophase_emit_wgmma_query_block(), lib.twophase_emit_wgmma_tile_rows(),
           lib.twophase_emit_wgmma_smem(3, 3))
    want = (WG_QUERIES, WG_TILE_ROWS, wgmma_smem(3, 3))
    if got != want:
        raise RuntimeError(f"twophase_knn's Hopper emit geometry {got} is not the planner's {want}")


def segment_minima_plain(points: torch.Tensor, queries: torch.Tensor, seg: int, *,
                         exclude: torch.Tensor | None = None, scale=None,
                         matmul_precision: str = "highest"):
    """Plain PyTorch version of the emit kernel: per query block the score
    rows ``pn - 2 q @ x.T`` (the product at the tier, :func:`~.exact.dist_dot`),
    padded to whole segments with +inf, then the minimum and its first
    index per segment."""
    _check(points, queries, 1, exclude, matmul_precision)
    _check_seg(seg)
    tier = stream_tier(points.dtype, matmul_precision)
    n = points.shape[0]
    m = queries.shape[0]
    q, _, _ = _prepare(points, queries, scale)
    if points.dtype in (torch.bfloat16, torch.float16):
        q = q.to(points.dtype).float()
    x = points.float()
    pn = (x * x).sum(-1)
    n_seg = -(-n // seg)
    base = torch.arange(n_seg, device=x.device, dtype=torch.int64) * seg
    block = max(1, min(m, _BLOCK_ELEMS // (n_seg * seg)))
    vals, ids = [], []
    for lo in range(0, m, block):
        s = torch.full((min(block, m - lo), n_seg * seg), float("inf"),
                       device=x.device)
        s[:, :n] = pn[None, :] - 2.0 * dist_dot(q[lo: lo + block], x, tier)
        if exclude is not None:
            e = exclude[lo: lo + block].long()
            rows = torch.nonzero((e >= 0) & (e < n)).squeeze(1)
            s[rows, e[rows]] = float("inf")
        v, a = s.view(-1, n_seg, seg).min(-1)
        vals.append(v)
        ids.append((a + base).to(itype))
    if not vals:
        return (torch.empty((0, n_seg), device=x.device),
                torch.empty((0, n_seg), dtype=itype, device=x.device))
    return torch.cat(vals), torch.cat(ids)


def segment_merge(points: torch.Tensor, queries: torch.Tensor, k: int, seg: int, *,
                  exclude: torch.Tensor | None = None, scale=None,
                  matmul_precision: str = "highest"):
    """Phases 1 and 2 (``exact_knn_pallas(merge="twophase")``): the k
    segments of smallest minimum per query, as (ids (m, k) of each
    segment's best row, distances = minimum + |q|^2, times scale^2 for
    int8), ascending, ties to the smaller id; (n, +inf) where the segments
    run out."""
    seg_d, seg_i = segment_minima(points, queries, seg, exclude=exclude,
                                  scale=scale, matmul_precision=matmul_precision)
    _, qn, scale2 = _prepare(points, queries, scale)
    d_k, i_k = smallest(seg_d + qn[:, None], seg_i, k)
    inf = torch.isinf(d_k)
    ids = torch.where(inf, torch.full_like(i_k, points.shape[0]), i_k)
    return ids, d_k * scale2


# -- phase 3: the rescan kernel and its plain version --------------------------

def rescan_splits(m: int, P: int, sms: int, per_sm: int) -> int:
    """Blocks a query of the rescan kernel's grid on a card of ``sms`` SMs
    holding ``per_sm`` rescan blocks each: the fewest splits of the
    query's P windows (at most 32 and P) whose m x s blocks fill at least
    7/8 of those block slots, then as few as give every split a window
    (split s takes windows ``[s * per, min((s + 1) * per, P))``, per =
    ceil(P / s)).  Unlike the rank kernel's :func:`~.exact.splits`, whose
    blocks hold an SM each, several rescan blocks share an SM and finish
    at different times, so the last wave's tail is not counted.  One at
    the serving shape (m = 1000), many for add_points' emit-all blocks of
    26 queries."""
    s = min(32, P, max(1, -(-7 * sms * per_sm // (8 * m))))
    per = -(-P // s)
    return -(-P // per)


def rescan_windows(points: torch.Tensor, q: torch.Tensor, starts: torch.Tensor,
                   seg: int, k: int | None, *, geometry: tuple[int, int] | None = None,
                   n_splits: int | None = None):
    """Phase 3 over windows ``[starts[i, p], starts[i, p] + seg)`` (start n =
    an exhausted pick; rows >= n do not exist): diff-form squared L2 of the
    queries ``q`` as the kernel multiplies them (quantised for int8).
    ``k`` <= 128: the k nearest, (ids (m, k) int32, distances) ascending,
    ties to the smaller id, (n, +inf) past the real rows.  ``k`` None: every
    window row, (ids (m, P*seg), distances), id n and +inf where a row does
    not exist.  The rescan kernel on a CUDA tensor,
    :func:`rescan_windows_plain` on a CPU tensor.  ``geometry`` (the row
    scorer's (V, G), :func:`~.exact.gather_geometry` by default) and
    ``n_splits`` (:func:`rescan_splits` by default) set the kernel's
    launch, for readings; the result does not depend on them."""
    _check(points, q, 1, None, "highest")
    _check_seg(seg)
    if k is not None and not 1 <= k <= KMAX:
        raise ValueError(f"the rescan selects 1 <= k <= {KMAX}, got {k}")
    if points.device.type == "cpu":
        return rescan_windows_plain(points, q, starts, seg, k)
    if points.device.type != "cuda":
        raise ValueError(f"rescan_windows runs on cuda or cpu, not {points.device}")
    if not points.is_contiguous():
        raise ValueError("points must be contiguous")
    n, d = points.shape
    m, P = starts.shape
    if starts.dtype != torch.int32 or starts.device != points.device or m != q.shape[0]:
        raise ValueError("starts must be an (m, P) int32 tensor on the points' device")
    if P * seg >= 2**31:
        raise ValueError(f"P * seg = {P * seg} windows rows do not fit int32")
    dev = points.device
    width = P * seg if k is None else k
    out_d = torch.empty((m, width), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, width), dtype=itype, device=dev)
    if m == 0:
        return out_i, out_d
    q = q.contiguous()
    starts = starts.contiguous()
    lib = _library("twophase_knn")
    vec, lanes = geometry or gather_geometry(d, points.element_size(), points.data_ptr())
    code = _DTYPE_CODE[points.dtype]
    if n_splits is None:
        per_sm = lib.twophase_rescan_blocks_per_sm(code, vec)
        if per_sm < 1:
            raise RuntimeError(f"twophase_rescan: no resident block at {vec}-byte loads")
        n_splits = rescan_splits(
            m, P, torch.cuda.get_device_properties(dev).multi_processor_count, per_sm)
    elif not 1 <= n_splits <= min(32, P):
        raise ValueError(f"n_splits must lie in [1, min(32, P) = {min(32, P)}], got {n_splits}")
    else:  # as few as give every split a window, at the same boundaries
        n_splits = -(-P // -(-P // n_splits))
    part_d = part_i = None
    if k is not None and n_splits > 1:  # the splits' lists, merged by the launcher
        part_d = torch.empty((m, n_splits, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((m, n_splits, k), dtype=itype, device=dev)
    err = lib.twophase_rescan_launch(
        device_index(dev), points.data_ptr(), code, q.data_ptr(), starts.data_ptr(), n, d, m,
        P, seg.bit_length() - 1, 0 if k is None else k, vec, lanes, n_splits,
        out_d.data_ptr(), out_i.data_ptr(), part_d.data_ptr() if part_d is not None else None,
        part_i.data_ptr() if part_i is not None else None,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise launch_error(lib, "twophase_rescan", err)
    launches["twophase_rescan_all" if k is None else "twophase_rescan"] += 1
    return out_i, out_d


def rescan_windows_plain_by_splits(points: torch.Tensor, q: torch.Tensor,
                                   starts: torch.Tensor, seg: int, k: int | None,
                                   n_splits: int):
    """The rescan's plain version as the kernel's grid runs it: each
    query's P windows in ``n_splits`` ranges of ceil(P / n_splits) (the
    kernel's split boundaries), each range rescanned on its own, then the
    ranges' ascending lists merged by (distance, id) (``k`` None: their
    window rows side by side, where the kernel writes them).  Ids are
    unique across windows, so this equals :func:`rescan_windows_plain`."""
    P = starts.shape[1]
    per = -(-P // n_splits)
    parts = [rescan_windows_plain(points, q, starts[:, lo: lo + per].contiguous(), seg, k)
             for lo in range(0, P, per)]
    ids = torch.cat([i for i, _ in parts], 1)
    dists = torch.cat([dd for _, dd in parts], 1)
    if k is None:
        return ids, dists
    d_k, i_k = smallest(dists, ids, k)
    return torch.where(torch.isinf(d_k), torch.full_like(i_k, points.shape[0]), i_k), d_k


def rescan_windows_plain(points: torch.Tensor, q: torch.Tensor,
                         starts: torch.Tensor, seg: int, k: int | None):
    """Plain PyTorch version of the rescan kernel, the gather form of the
    JAX package's ``rescan="xla"``: gather the window rows per query block,
    widen to fp32, ``sum((x - q)^2)``, and select with :func:`smallest`."""
    n, d = points.shape
    m, P = starts.shape
    if points.dtype in (torch.bfloat16, torch.float16):
        q = q.to(points.dtype)
    q = q.float()
    lane = torch.arange(seg, device=points.device, dtype=torch.int64)
    block = max(1, min(m, _BLOCK_ELEMS // max(1, P * seg * d)))
    out_i, out_d = [], []
    for lo in range(0, m, block):
        st = starts[lo: lo + block].long()
        rows = (st[..., None] + lane).reshape(st.shape[0], P * seg)
        valid = ((st[..., None] < n) & (st[..., None] + lane < n)).reshape(rows.shape)
        rows = torch.where(valid, rows, torch.full_like(rows, n))
        pc = points[torch.where(valid, rows, torch.zeros_like(rows))].float()
        diff = pc - q[lo: lo + block, None, :]
        dd = torch.where(valid, (diff * diff).sum(-1),
                         torch.full((), float("inf"), device=points.device))
        if k is None:
            out_i.append(rows.to(itype))
            out_d.append(dd)
            continue
        d_k, i_k = smallest(dd, rows, k)
        out_i.append(torch.where(torch.isinf(d_k), torch.full_like(i_k, n), i_k))
        out_d.append(d_k)
    if not out_i:
        w = P * seg if k is None else k
        return (torch.empty((0, w), dtype=itype, device=points.device),
                torch.empty((0, w), device=points.device))
    return torch.cat(out_i), torch.cat(out_d)


# -- the engine -----------------------------------------------------------------

def exact_knn_twophase(points, queries, k: int, *, seg: int | None = None,
                       pad_segments: int = 2, scale=None, rescan: str = "dma",
                       matmul_precision: str = "highest", device=None):
    """EXACT two-phase k-NN: emit per-segment minima, pick the
    ``k + pad_segments`` best segments per query, rescan their rows.
    Returns (ids (m, k) int32 ascending, squared distances (m, k) float32
    in diff form, times scale^2 for int8), ties to the smaller id, (n, +inf)
    past the real rows.  Any k: past 128 the rescan returns every window row
    and the final top-k runs in PyTorch.  Queries whose (query, segment)
    pairs pass :data:`BLOCK_PAIRS` run in blocks of :func:`query_block`
    queries, each its own emit, pick and rescan; a query's answer does not
    depend on its block.

    ``seg`` (a power of two) defaults to :func:`auto_seg`.  ``rescan``:
    "dma" runs the rescan kernel on a CUDA corpus (the name is the JAX
    package's); "xla" the gather form, which is also the kernel's plain
    version and what every CPU tensor runs.  Takes tensors or array-likes,
    placed as :func:`~.exact.exact_search` places them (``device``).  Emit,
    segment pick and rescan are the span ``exact.twophase``."""
    points, queries = place(points, queries, device)
    _check(points, queries, k, None, matmul_precision)
    if rescan not in ("dma", "xla"):
        raise ValueError(f"rescan must be 'dma' or 'xla', got {rescan!r}")
    if pad_segments < 0:
        raise ValueError(f"pad_segments must be >= 0, got {pad_segments}")
    n = points.shape[0]
    seg = auto_seg(n) if seg is None else seg
    _check_seg(seg)
    m = queries.shape[0]
    block = query_block(m, -(-n // seg))
    launches["twophase_calls"] += 1
    with span("exact.twophase", rows=m):
        if block >= m:
            return _twophase_block(points, queries, k, seg, pad_segments, scale, rescan,
                                   matmul_precision)
        parts = [_twophase_block(points, queries[lo: lo + block], k, seg, pad_segments,
                                 scale, rescan, matmul_precision)
                 for lo in range(0, m, block)]
        return torch.cat([i for i, _ in parts]), torch.cat([dd for _, dd in parts])


def _twophase_block(points, queries, k: int, seg: int, pad_segments: int, scale,
                    rescan: str, matmul_precision: str):
    """:func:`exact_knn_twophase` for one block of queries: emit, segment
    pick and rescan."""
    n = points.shape[0]
    P = k + pad_segments
    sel, _ = segment_merge(points, queries, P, seg, scale=scale,
                           matmul_precision=matmul_precision)
    # the picked segments are unique per query, so their windows are
    # disjoint; an exhausted pick (id n) starts at n and reads nothing
    starts = torch.where(sel < n, sel // seg * seg, torch.full_like(sel, n))
    q, _, scale2 = _prepare(points, queries, scale)
    fn = rescan_windows_plain if rescan == "xla" else rescan_windows
    if k <= KMAX:
        ids, dd = fn(points, q, starts, seg, k)
    else:
        # emit-all in query blocks that keep the (block, P*seg) pool and its
        # int64 selection keys near 256 MB each
        block = max(1, min(queries.shape[0], (32 << 20) // (P * seg)))
        parts_i, parts_d = [], []
        for lo in range(0, queries.shape[0], block):
            pos, dd_all = fn(points, q[lo: lo + block], starts[lo: lo + block], seg, None)
            d_k, i_k = smallest(dd_all, pos, k)
            parts_i.append(i_k)
            parts_d.append(d_k)
        ids = torch.cat(parts_i) if parts_i else torch.empty((0, k), dtype=itype,
                                                             device=points.device)
        dd = torch.cat(parts_d) if parts_d else torch.empty((0, k), device=points.device)
    inf = torch.isinf(dd)
    ids = torch.where(inf, torch.full_like(ids, n), ids)
    return ids, dd * scale2
