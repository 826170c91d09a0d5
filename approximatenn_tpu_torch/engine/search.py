"""Batch query over the padded bucket tables (port of the table-layout path
of ``approximatenn_tpu/engine/search.py``).

Pipeline: center and project the queries against every table in one
matmul, multiprobe-gather candidates from every table (blind Hamming-1
set, or ``n_probes`` query-directed probes), squared L2 on the raw
coordinates, dedup + top-k, ``supercharge_rounds`` expansions through the
stored kNN graph, final top-k.  The JAX package's host-chunked search
(``_search_chunked``) exists for an XLA compile-memory limit and is not
ported; the packed layout (``search_packed*``) waits for a later slice.
"""

from __future__ import annotations

import torch

from ..config import itype
from ..index import ANNIndex
from ..ops.distance import blocked_over_rows, candidate_dists, pick_block
from ..ops.hash import probe_codes, probe_codes_directed, query_codes
from ..ops.topk import dedup_topk


def search_impl(index: ANNIndex, points, queries, block_rows: int,
                n_probes: int | None = None, supercharge_rounds: int = 1,
                rerank_width: int | None = None):
    """The search pipeline on prepared inputs; (ids (m, k) int32, dists)."""
    n, k, d_short, tries = index.n, index.k, index.d_short, index.tries
    # widened intermediate pool, cut to k at the end
    kk = k if rerank_width is None else max(int(rerank_width), k)
    q = queries.to(index.bases.dtype)
    codes, proj = query_codes(index.row_means, index.bases, q)
    table_idx = torch.arange(tries, device=q.device)[None, :, None]
    tables = index.tables
    graph = index.graph

    def stage(qb, cb, pb):
        if n_probes is None:
            probes = probe_codes(cb, d_short)  # (B, tries, ds+1)
        else:
            probes = probe_codes_directed(cb, pb, n_probes)
        cand = tables[table_idx, probes.long()]
        cand = cand.reshape(cand.shape[0], -1)  # (B, tries*P*tmax)
        t1, td1 = dedup_topk(cand, candidate_dists(qb, points, cand), kk, n)
        for _ in range(supercharge_rounds):
            real = t1 < n
            safe = torch.where(real, t1, torch.zeros_like(t1)).long()
            exp = torch.where(real[..., None], graph[safe],
                              torch.full_like(graph[safe], n)).reshape(-1, kk * k)
            cand2 = torch.cat([t1, exp], dim=-1)
            dd2 = torch.cat([td1, candidate_dists(qb, points, exp)], dim=-1)
            t1, td1 = dedup_topk(cand2, dd2, kk, n)
        if kk != k:
            t1, td1 = t1[:, :k], td1[:, :k]
        return t1, td1

    m = q.shape[0]
    if m == 0:
        return (torch.empty((0, k), dtype=itype, device=q.device),
                torch.empty((0, k), dtype=q.dtype, device=q.device))
    return blocked_over_rows(stage, m, block_rows, q, codes, proj)


def _as_corpus(points, dtype):
    """A bf16/f16 corpus stays as stored (candidate gathers promote to the
    query dtype); anything else is cast to the index dtype."""
    if points.dtype in (torch.bfloat16, torch.float16):
        return points
    return points.to(dtype)


def search(index: ANNIndex, points=None, queries=None, *,
           budget_bytes: int = 128 << 20, block_rows: int | None = None,
           n_probes: int | None = None, supercharge_rounds: int = 1,
           rerank_width: int | None = None):
    """The k approximate nearest neighbours of each query: (ids (m, k)
    int32 with sentinel n padding, squared distances).

    ``points`` is the build-time point matrix, or None to use the points
    the index stores (``search(index, queries)`` is the short form).
    ``n_probes``: None = own bucket + every Hamming-1 bucket per table; an
    int = that many query-directed probes.  ``supercharge_rounds``: graph
    expansions after the bucket candidates (0 disables).  ``rerank_width``:
    keep this many (>= k) candidates through merge and supercharge.
    """
    if queries is None:
        points, queries = None, points
    if points is None:
        if index.points is None:
            raise ValueError("index does not store points; pass the build-time "
                             "point matrix or build with store_points=True")
        points = index.points
    dev = index.device
    dtype = index.bases.dtype
    points = torch.as_tensor(points, device=dev)
    queries = torch.as_tensor(queries, device=dev).to(dtype)
    if index.metric != "l2":
        from ..data.preprocess import prepare_points

        queries = prepare_points(queries, index.metric)
    m = queries.shape[0]
    P = index.d_short + 1 if n_probes is None else n_probes
    if block_rows is None:
        block_rows = pick_block(m, index.tries * P * index.tmax, index.d,
                                index.bases.element_size(), budget_bytes)
    return search_impl(index, _as_corpus(points, dtype), queries,
                       block_rows=max(1, block_rows), n_probes=n_probes,
                       supercharge_rounds=supercharge_rounds,
                       rerank_width=rerank_width)
