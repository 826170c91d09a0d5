"""Index build (port of ``approximatenn_tpu/engine/build.py``).

Pipeline: center the points, sample ``tries`` orthogonal transforms from a
``torch.Generator`` and materialise their bases, hash every point for
every table with one matmul, build the padded bucket tables, then compute
the kNN graph either exactly (the CUDA kernel with self-exclusion; the
float oracle on the CPU) or with the reference's hash pipeline (per-table
multiprobe + top-k, cross-table merge, one supercharge round).

The JAX package's host-chunked graph loop (``graph_stage_chunked``) and
its block-count trigger work around a TPU runtime limit and are not
ported: the graph stage here is one Python loop over tables and row
blocks, blocked only to bound the candidate-gather transient.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..config import itype
from ..index import ANNIndex
from ..ops.buckets import bucket_counts, build_tables, multiprobe_gather
from ..ops.distance import blocked_over_rows, candidate_dists, pick_block
from ..ops.hash import probe_codes_directed, query_codes
from ..ops.topk import dedup_topk
from ..ops.transforms import derive_dims, materialize_bases, sample_ortho_params_batch
from ..utils.profiling import build_stage


def resolve_capacity(counts: torch.Tensor, capacity) -> int:
    """Bucket capacity: None = exact max occupancy (reference semantics);
    int = pinned; "auto" = min(max, ceil(32 x mean), floor 8)."""
    if isinstance(capacity, str):
        if capacity != "auto":
            raise ValueError(f"capacity must be an int, None, or 'auto'; got {capacity!r}")
        c = counts.cpu().numpy()
        cap = max(32.0 * c.mean(), 8.0)
        return max(1, int(min(c.max(), np.ceil(cap))))
    if capacity is None:
        return max(1, int(counts.max()))
    return max(1, int(capacity))


def sample_bases(generator, d, d_short, tries, rb, rlb, ra, rla, dtype,
                 device=None):
    """Sample ``tries`` transforms and materialise their bases
    (tries, d_short, d)."""
    _, d_max = derive_dims(2, 1, d)
    params = sample_ortho_params_batch(generator, tries, d, d_max, rb, rlb, ra,
                                       rla, dtype, device)
    return materialize_bases(params, d, d_short, dtype)


def hash_points(xc: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """Sign-hash pre-centered points against all tables: codes (tries, n)."""
    zero = torch.zeros((), dtype=xc.dtype, device=xc.device)
    return query_codes(zero, bases, xc)[0].T.contiguous()


def hash_stage(points, generator, *, d_short, tries, rb, rlb, ra, rla, dtype,
               bases=None, row_means=None):
    """Center (on ``row_means`` when given, else the points' mean), sample
    (unless ``bases`` is given), hash.  Returns (row_means, bases, codes
    (tries, n), counts (tries, 2^d_short))."""
    points = points.to(dtype)
    if row_means is None:
        row_means = points.mean(0)
    if bases is None:
        bases = sample_bases(generator, points.shape[1], d_short, tries, rb, rlb,
                             ra, rla, dtype, points.device)
    codes = hash_points(points - row_means, bases)
    counts = torch.stack([bucket_counts(c, 1 << d_short) for c in codes])
    return row_means, bases, codes, counts


def graph_stage(points, codes, counts, *, k, d_short, tmax, block_rows,
                n_probes=None, row_means=None, bases=None):
    """The hash graph: bucket tables, per-table candidates + top-k, merge,
    one supercharge round.  Returns (tables, graph, dists)."""
    n = points.shape[0]
    tries = codes.shape[0]
    tables = build_tables(codes, 1 << d_short, tmax, n)
    rows_all = torch.arange(n, dtype=itype, device=points.device)
    if bases is None:
        bases = torch.zeros((tries, d_short, points.shape[1]), dtype=points.dtype,
                            device=points.device)

    tids, tdists = [], []
    for t in range(tries):
        table, basis = tables[t], bases[t]

        def stage(qb, rows, cb):
            if n_probes is None:
                cand = multiprobe_gather(table, cb, d_short)
            else:
                proj = (qb - row_means) @ basis.T
                probes = probe_codes_directed(cb, proj, n_probes)
                cand = table[probes.long()].reshape(qb.shape[0], -1)
            dd = candidate_dists(qb, points, cand, exclude_self=rows)
            return dedup_topk(cand, dd, k, n)

        ids_k, d_k = blocked_over_rows(stage, n, block_rows, points, rows_all,
                                       codes[t])
        tids.append(ids_k)
        tdists.append(d_k)

    # cross-table merge, table-major within each row
    g1, gd1 = dedup_topk(torch.cat(tids, dim=1), torch.cat(tdists, dim=1), k, n)
    del tids, tdists

    # supercharge: expand through the merged graph itself
    def final_stage(g1b, gd1b, rows):
        real = g1b < n
        safe = torch.where(real, g1b, torch.zeros_like(g1b)).long()
        exp = torch.where(real[..., None], g1[safe], torch.full_like(g1[safe], n))
        exp = exp.reshape(-1, k * k)
        cand = torch.cat([g1b, exp], dim=-1)
        dd_exp = candidate_dists(points[rows.long()], points, exp,
                                 exclude_self=rows)
        return dedup_topk(cand, torch.cat([gd1b, dd_exp], dim=-1), k, n)

    graph, gdists = blocked_over_rows(final_stage, n, block_rows, g1, gd1, rows_all)
    return tables, graph, gdists


def exact_graph_chunked(points: torch.Tensor, k: int, *, chunk_q: int = 65536,
                        progress=None, matmul_precision: str = "highest"):
    """The true kNN graph by exhaustive search: the CUDA kernel with
    ``exclude`` = each row's own id on a CUDA tensor and k <= 128, the
    float oracle (:func:`brute_force_knn_self`) otherwise, as the JAX
    package does.  Chunks of ``chunk_q`` query rows keep each launch to
    seconds."""
    from ..ops.distance import brute_force_knn_self
    from ..ops.exact import KMAX, exact_knn

    n = points.shape[0]
    if points.device.type != "cuda" or k > KMAX:
        return brute_force_knn_self(points, k)
    pts32 = points.float().contiguous()
    parts_i, parts_d = [], []
    for lo in range(0, n, chunk_q):
        m = min(chunk_q, n - lo)
        excl = torch.arange(lo, lo + m, dtype=torch.int32, device=points.device)
        ids_k, d_k = exact_knn(pts32, pts32[lo: lo + m], k, exclude=excl,
                               matmul_precision=matmul_precision)
        parts_i.append(ids_k)
        parts_d.append(d_k)
        if progress:
            progress(f"exact graph rows {lo + m}/{n}")
    return torch.cat(parts_i), torch.cat(parts_d)


def build(
    points,
    k: int,
    *,
    tries: int = 10,
    rots_before: int = 6,
    rot_len_before: int = 1,
    rots_after: int = 1,
    rot_len_after: int = 1,
    generator: torch.Generator | None = None,
    seed: int = 0,
    dtype=None,
    capacity=None,
    budget_bytes: int = 128 << 20,
    metric: str = "l2",
    store_points: bool | None = None,
    n_probes: int | None = None,
    graph_mode: str = "auto",
    graph_precision: str = "highest",
    device=None,
    stage_times=None,
) -> tuple[ANNIndex, torch.Tensor, torch.Tensor]:
    """Build an index over ``points`` (n, d); returns (index, graph, dists).

    Same options as the JAX ``build``; ``generator`` (a CPU
    ``torch.Generator``) replaces ``key`` and defaults to one seeded with
    ``seed``.  ``device`` defaults to the points' device for a tensor and
    to the CUDA card otherwise (see :func:`config.default_device`).
    ``graph_mode`` "auto" resolves to "exact" for n <= 16M and k <= 128, as
    in JAX.  ``stage_times``: a :class:`~..utils.profiling.StageTimes` that
    records the stages "hash" (centre, transforms, codes), "tables" (the
    per-table bucket sorts; inside "graph" for the hash graph) and "graph"
    (the kNN graph), each fenced.  Each stage is the span ``build.<stage>``
    whether or not ``stage_times`` is given.
    """
    from ..data.preprocess import prepare_points

    points = torch.as_tensor(points, device=config.default_device(points, device))
    n, d = points.shape
    if n >= 2**31:
        raise ValueError("n must fit in int32")
    dtype = dtype or config.ftype()
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    points = prepare_points(points.to(dtype), metric)
    if store_points is None:
        store_points = metric != "l2"
    d_short, _ = derive_dims(n, k, d)
    if d_short > 28:
        raise ValueError(f"d_short={d_short} too large (bucket table 2^{d_short})")

    def stage(name):
        return build_stage(name, stage_times, rows=n)

    with stage("hash") as sink:
        row_means, bases, codes, counts = hash_stage(
            points, generator, d_short=d_short, tries=tries, rb=rots_before,
            rlb=rot_len_before, ra=rots_after, rla=rot_len_after, dtype=dtype)
        sink.append(codes)
    tmax = resolve_capacity(counts, capacity)
    n_per_probe = d_short + 1 if n_probes is None else n_probes
    block_rows = pick_block(n, n_per_probe * tmax, d, points.element_size(),
                            budget_bytes)
    if graph_mode == "auto":
        graph_mode = "exact" if (n <= (1 << 24) and k <= 128) else "hash"
    if graph_mode not in ("exact", "hash"):
        raise ValueError(f"unknown graph_mode {graph_mode!r}")
    if graph_mode == "exact":
        with stage("tables") as sink:
            tables = build_tables(codes, 1 << d_short, tmax, n)
            sink.append(tables)
        with stage("graph") as sink:
            graph, gdists = exact_graph_chunked(points, k,
                                                matmul_precision=graph_precision)
            graph = graph.to(itype)
            gdists = gdists.to(dtype)
            sink.append(graph)
    else:
        # the hash graph builds its tables inside the graph stage
        with stage("graph") as sink:
            tables, graph, gdists = graph_stage(
                points, codes, counts, k=k, d_short=d_short, tmax=tmax,
                block_rows=block_rows, n_probes=n_probes, row_means=row_means,
                bases=bases)
            sink.append(graph)
    del codes
    index = ANNIndex(
        row_means=row_means, bases=bases, tables=tables, counts=counts,
        graph=graph, n=n, k=k, d=d, d_short=d_short, tries=tries, tmax=tmax,
        points=points if store_points else None, metric=metric,
    )
    return index, graph, gdists


def build_graph_only(points, k: int, **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """kNN graph without keeping the index (reference save=NULL path)."""
    _, graph, gdists = build(points, k, **kw)
    return graph, gdists
