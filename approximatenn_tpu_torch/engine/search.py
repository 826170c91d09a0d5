"""Batch query (port of ``approximatenn_tpu/engine/search.py``): over the
padded bucket tables (``search``) and over the packed bucket-CSR view
(``search_packed``, plain PyTorch; ``search_packed_fused``, whose
per-table candidate stage is the probe-window CUDA kernel).

Pipeline: center and project the queries against every table in one
matmul, pick probes in every table (blind Hamming-1 set, or ``n_probes``
query-directed probes), squared L2 of the candidates on the raw
coordinates, dedup + top-k, ``supercharge_rounds`` expansions through the
stored kNN graph, final top-k.  The JAX package's host-chunked search
(``_search_chunked``) exists for an XLA compile-memory limit and is not
ported, nor are the fused path's TPU knobs (``query_block``,
``interpret``, ``pos_mode``).
"""

from __future__ import annotations

import torch

from ..config import itype
from ..index import ANNIndex, PackedIndex
from ..ops.distance import blocked_over_rows, candidate_dists, pick_block
from ..ops.hash import probe_codes, probe_codes_directed, query_codes
from ..ops.topk import dedup_topk
from ..utils.profiling import span


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


def _probes(codes, proj, d_short: int, n_probes: int | None):
    if n_probes is None:
        return probe_codes(codes, d_short)  # (m, tries, d_short + 1)
    return probe_codes_directed(codes, proj, n_probes)


def search_packed_impl(pi: PackedIndex, points, queries, block_rows: int,
                       n_probes: int | None = None, supercharge_rounds: int = 1,
                       rerank_width: int | None = None):
    """The packed view's plain pipeline on prepared inputs.

    Each probe reads the ``rows_per_probe`` groups of ``super_width`` slots
    covering ``[start, start + window)``: the candidate vectors come
    straight from ``point_rows``.  The per-table top-k dedups by packed
    position (a point has one slot per table; overlapping reads carry the
    same slot at the same distance); positions >= ``live_bound`` are
    sentinels, masked before the top-k; real ids are looked up for the
    winners only, then merged across tables by id.  int8 rows rank in the
    quantized domain (q / scale), then the merged pool is re-scored against
    the float corpus."""
    n, k, d_short, tries = pi.n, pi.k, pi.d_short, pi.tries
    kk = k if rerank_width is None else max(int(rerank_width), k)
    w, d = pi.super_width, pi.d
    nrows = pi.n_rows
    n_pad = nrows * w
    rpp = pi.rows_per_probe()
    dtype = pi.bases.dtype
    cdtype = pi.point_rows.dtype
    dev = pi.device
    q = queries.to(dtype)
    codes, proj = query_codes(pi.row_means, pi.bases, q)
    table_idx = torch.arange(tries, device=dev)[None, :, None]
    slot_off = (torch.arange(tries, device=dev) * n_pad)[None, :, None]
    step = torch.arange(rpp, device=dev)
    ids_flat = pi.ids.reshape(-1)
    lane = torch.arange(w, device=dev)
    live = pi.live_bound
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)

    def stage(qb, cb, pb):
        B = qb.shape[0]
        start = pi.starts[table_idx, _probes(cb, pb, d_short, n_probes).long()]
        rows = torch.clamp(start[..., None] // w + step, max=nrows - 1)
        pos = (rows[..., None] * w + lane).reshape(B, tries, -1)  # (B, T, Lt)
        pc = pi.point_rows[(pos + slot_off).reshape(B, -1)].reshape(B, tries, -1, d)
        if pi.scale is not None:
            qbp = qb.float() / pi.scale  # int8 rows promote to float32
        else:
            qbp = qb.to(cdtype)
        diff = qbp[:, None, None, :] - pc
        dd = (diff * diff).sum(-1).to(dtype)
        if pi.scale is not None:
            dd = dd * (pi.scale * pi.scale).to(dtype)
        dd = torch.where(pos < live, dd, inf)
        tpos, tdist = dedup_topk(pos, dd, kk, n_pad)  # (B, T, kk) positional
        wids = ids_flat[torch.clamp(tpos + slot_off, max=ids_flat.shape[0] - 1).long()]
        wids = torch.where(torch.isinf(tdist), n, wids)
        tdist = torch.where(wids == n, inf, tdist)
        t1, td1 = dedup_topk(wids.reshape(B, -1), tdist.reshape(B, -1), kk, n)
        return _finish(pi, points, qb, t1, td1, kk, supercharge_rounds)

    m = q.shape[0]
    if m == 0:
        return (torch.empty((0, k), dtype=itype, device=dev),
                torch.empty((0, k), dtype=dtype, device=dev))
    return blocked_over_rows(stage, m, block_rows, q, codes, proj)


def _finish(pi: PackedIndex, points, q, t1, td1, kk: int, supercharge_rounds: int):
    """After the cross-table merge: the int8 tier's re-score against the
    float corpus, the supercharge rounds, the cut to k.  ``points`` may be a
    staged (n + 1, d) buffer: its +inf sentinel row scores id n at +inf."""
    n, k = pi.n, pi.k
    if pi.scale is not None:
        t1, td1 = dedup_topk(t1, candidate_dists(q, points, t1), kk, n)
    for _ in range(supercharge_rounds):
        real = t1 < n
        safe = torch.where(real, t1, torch.zeros_like(t1)).long()
        exp = torch.where(real[..., None], pi.graph[safe],
                          torch.full_like(pi.graph[safe], n)).reshape(-1, kk * k)
        cand2 = torch.cat([t1, exp], dim=-1)
        dd2 = torch.cat([td1, candidate_dists(q, points, exp).to(td1.dtype)], dim=-1)
        t1, td1 = dedup_topk(cand2, dd2, kk, n)
    return t1[:, :k], td1[:, :k]


def probe_starts(pi: PackedIndex, q, n_probes: int | None, window: int):
    """Window starts of every probe, (m, tries, P) int32, clipped to
    ``n_pad - window`` (the fused path's candidate windows before the probe
    kernel's alignment widening)."""
    codes, proj = query_codes(pi.row_means, pi.bases, q)
    table_idx = torch.arange(pi.tries, device=pi.device)[None, :, None]
    start = pi.starts[table_idx, _probes(codes, proj, pi.d_short, n_probes).long()]
    return torch.clamp(start, max=pi.n_pad - window)


def search_packed_fused_impl(pi: PackedIndex, points, queries,
                             n_probes: int | None = None, window: int | None = None,
                             supercharge_rounds: int = 1,
                             rerank_width: int | None = None):
    """The packed view with the probe kernel (:func:`~..ops.probe.probe_topk`)
    as the per-table candidate stage: each probe reads exactly its window
    ``[start, start + window)`` (widened to the kernel's alignment), the
    per-table distance and top-k run in the kernel, and only the ``tries *
    kk`` winners per query come back for the id lookup, the cross-table
    merge and supercharge, in PyTorch as in the JAX package.  The four
    stages are the spans ``search.codes``, ``search.probe``,
    ``search.merge`` and ``search.supercharge``."""
    from ..ops.probe import probe_topk

    n, k, tries = pi.n, pi.k, pi.tries
    kk = k if rerank_width is None else max(int(rerank_width), k)
    n_pad = pi.n_pad
    window = max(1, min(int(pi.window if window is None else window), n_pad))
    dev = pi.device
    m = queries.shape[0]
    with span("search.codes", rows=m):
        q = queries.to(pi.bases.dtype)
        start = probe_starts(pi, q, n_probes, window)
    with span("search.probe", rows=m):
        # int8 rows: the kernel ranks q / scale against round(x / scale) and
        # one multiply by scale^2 restores the true distances
        qp = q if pi.scale is None else q.float() / pi.scale
        pos, dd = probe_topk(pi.point_rows, qp, start, k=kk, n=pi.live_bound, n_pad=n_pad,
                             window=window)
        if pi.scale is not None:
            dd = dd * (pi.scale * pi.scale)
    with span("search.merge", rows=m):
        slot_off = (torch.arange(tries, device=dev) * n_pad)[None, :, None]
        ids_flat = pi.ids.reshape(-1)
        wids = ids_flat[torch.clamp(pos + slot_off, max=ids_flat.shape[0] - 1).long()]
        wids = torch.where(torch.isinf(dd), n, wids)
        dd = torch.where(wids == n, float("inf"), dd)
        t1, td1 = dedup_topk(wids.reshape(m, -1), dd.reshape(m, -1), kk, n)
    with span("search.supercharge", rows=m):
        return _finish(pi, points, q, t1, td1, kk, supercharge_rounds)


def _packed_inputs(pindex: PackedIndex, points, queries):
    """(corpus, queries) of a packed search: the view's stored corpus when
    ``points`` is None, on the view's device; queries metric-prepared in
    the index dtype."""
    if queries is None:
        points, queries = None, points
    if points is None:
        if pindex.points is None:
            raise ValueError("packed view does not store points; pass the build-time "
                             "point matrix or pack with store_points=True")
        points = pindex.points
    dtype = pindex.bases.dtype
    points = torch.as_tensor(points, device=pindex.device)
    queries = torch.as_tensor(queries, device=pindex.device).to(dtype)
    if pindex.metric != "l2":
        from ..data.preprocess import prepare_points

        queries = prepare_points(queries, pindex.metric)
    return _as_corpus(points, dtype), queries


def search_packed(pindex: PackedIndex, points=None, queries=None, *,
                  budget_bytes: int = 128 << 20, block_rows: int | None = None,
                  n_probes: int | None = None, supercharge_rounds: int = 1,
                  rerank_width: int | None = None):
    """Search over a packed view (``index.packed()``) in plain PyTorch: the
    contract of :func:`search` ((ids, squared distances), sentinel n), with
    the packed candidate superset (a probe reads whole ``super_width``-slot
    groups, so neighbouring buckets' slots join the pool).  Knobs:
    ``pindex.with_window(w)`` (read depth), ``n_probes``, ``rerank_width``;
    ``block_rows``/``budget_bytes`` bound the gather transient."""
    points, queries = _packed_inputs(pindex, points, queries)
    m = queries.shape[0]
    if block_rows is None:
        P = pindex.d_short + 1 if n_probes is None else n_probes
        ltot = pindex.tries * P * pindex.rows_per_probe() * pindex.super_width
        block_rows = pick_block(m, ltot, pindex.d, pindex.bases.element_size(),
                                budget_bytes)
    return search_packed_impl(pindex, points, queries, block_rows=max(1, block_rows),
                              n_probes=n_probes, supercharge_rounds=supercharge_rounds,
                              rerank_width=rerank_width)


def search_packed_fused(pindex: PackedIndex, points=None, queries=None, *,
                        n_probes: int | None = None, window: int | None = None,
                        supercharge_rounds: int = 1, rerank_width: int | None = None):
    """:func:`search_packed` with the probe-window kernel as the candidate
    stage (same contract).  On a CUDA view it launches the kernel; on a CPU
    view its plain version runs.  ``window`` overrides the view's read
    depth; ``rerank_width`` (<= 128 here: the kernel's selection width)
    widens the per-table and merged pools."""
    points, queries = _packed_inputs(pindex, points, queries)
    return search_packed_fused_impl(pindex, points, queries, n_probes=n_probes,
                                    window=window, supercharge_rounds=supercharge_rounds,
                                    rerank_width=rerank_width)


def _as_corpus(points, dtype):
    """A bf16/f16 corpus stays as stored (candidate gathers promote to the
    query dtype); anything else is cast to the index dtype."""
    if points.dtype in (torch.bfloat16, torch.float16):
        return points
    return points.to(dtype)


def search(index: ANNIndex, points=None, queries=None, *,
           budget_bytes: int = 128 << 20, block_rows: int | None = None,
           n_probes: int | None = None, supercharge_rounds: int = 1,
           rerank_width: int | None = None, chunked: bool | None = None):
    """The k approximate nearest neighbours of each query: (ids (m, k)
    int32 with sentinel n padding, squared distances).

    ``points`` is the build-time point matrix, or None to use the points
    the index stores (``search(index, queries)`` is the short form).
    ``n_probes``: None = own bucket + every Hamming-1 bucket per table; an
    int = that many query-directed probes.  ``supercharge_rounds``: graph
    expansions after the bucket candidates (0 disables).  ``rerank_width``:
    keep this many (>= k) candidates through merge and supercharge.
    ``chunked`` is the JAX package's switch between its one-program and
    host-chunked search loops, whose results are identical; it is accepted
    and ignored (there is one loop here).
    """
    if queries is None:
        points, queries = None, points
    index._need_tables("this index serves through its packed view only "
                       "(search_packed / search_packed_fused)")
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
