"""Dedup-by-id + top-k selection (port of ``approximatenn_tpu/ops/topk.py``).

``dedup_topk`` is k passes of masked argmin: emit the row minimum, then
+inf out every entry carrying the winning id (dedup and removal in one
mask).  ``torch.argmin`` returns the first minimum, so ties resolve to the
lowest position exactly as ``jnp.argmin`` does, and the surviving copy of a
duplicated id is its minimum distance.  ``dedup_topk_sort`` is the
sort-based oracle form with the same results.
"""

from __future__ import annotations

import torch

# above this k the k-pass argmin loop gives way to one sort
_ITER_K_MAX = 128

_INT32_MAX = 2**31 - 1


def _inf_like(x: torch.Tensor) -> torch.Tensor:
    return torch.full((), float("inf"), dtype=x.dtype, device=x.device)


def dedup_topk(ids: torch.Tensor, dists: torch.Tensor, k: int,
               sentinel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row dedup by id, then top-k ascending by distance.

    ids, dists: ``(..., L)``; masked entries must already carry +inf.
    Returns ``(ids_k, dists_k)`` of shape ``(..., k)``; rows with fewer than
    k unique real candidates are padded with (sentinel, +inf).
    """
    if k > _ITER_K_MAX or k >= ids.shape[-1]:
        return dedup_topk_sort(ids, dists, k, sentinel)
    sent = torch.tensor(sentinel, dtype=ids.dtype, device=ids.device)
    inf = _inf_like(dists)
    out_i, out_d = [], []
    cur = dists
    for _ in range(k):
        j = torch.argmin(cur, dim=-1, keepdim=True)
        dmin = torch.gather(cur, -1, j)
        imin = torch.gather(ids, -1, j)
        # an +inf minimum means the row is exhausted -> sentinel padding
        imin = torch.where(torch.isinf(dmin), sent, imin)
        out_i.append(imin)
        out_d.append(dmin)
        cur = torch.where(ids == imin, inf, cur)
    return torch.cat(out_i, dim=-1), torch.cat(out_d, dim=-1)


def _lexsort2(primary: torch.Tensor, secondary: torch.Tensor):
    """Sort the last axis by (primary, secondary) with both keys ascending;
    returns the permutation (two stable sorts, minor key first)."""
    o1 = torch.sort(secondary, dim=-1, stable=True).indices
    p1 = torch.gather(primary, -1, o1)
    o2 = torch.sort(p1, dim=-1, stable=True).indices
    return torch.gather(o1, -1, o2)


def dedup_topk_sort(ids: torch.Tensor, dists: torch.Tensor, k: int,
                    sentinel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dedup + top-k: sort by (id, distance) so the surviving
    copy of each id is its minimum distance, mask the duplicates to
    (sentinel, +inf), keep the k nearest (lowest position on ties).  Pads
    with (sentinel, +inf) columns when k exceeds the list length."""
    L = ids.shape[-1]
    kk = min(k, L)
    perm = _lexsort2(ids, dists)
    sid = torch.gather(ids, -1, perm)
    sdist = torch.gather(dists, -1, perm)
    prev = torch.cat([torch.full_like(sid[..., :1], -1), sid[..., :-1]], dim=-1)
    dup = sid == prev
    sdist = torch.where(dup, _inf_like(sdist), sdist)
    sid = torch.where(dup, torch.full_like(sid, sentinel), sid)
    vals, idx = torch.sort(sdist, dim=-1, stable=True)
    out_d, out_i = vals[..., :kk], torch.gather(sid, -1, idx[..., :kk])
    if k > kk:
        shape = out_i.shape[:-1] + (k - kk,)
        out_i = torch.cat([out_i, torch.full(shape, sentinel, dtype=out_i.dtype,
                                             device=out_i.device)], dim=-1)
        out_d = torch.cat([out_d, torch.full(shape, float("inf"), dtype=out_d.dtype,
                                             device=out_d.device)], dim=-1)
    return out_i, out_d


def merge_topk(ids_a, dists_a, ids_b, dists_b, k: int, sentinel: int):
    """Merge two candidate lists and keep the k nearest unique ids."""
    return dedup_topk(torch.cat([ids_a, ids_b], dim=-1),
                      torch.cat([dists_a, dists_b], dim=-1), k, sentinel)


def topk_no_dedup(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Plain top-k (ascending distance) without dedup, for merges where ids
    are unique.  Padding past the list length is (int32 max, +inf)."""
    L = dists.shape[-1]
    if k <= _ITER_K_MAX and k < L:
        idx, d = topk_iter(dists, k)
        return torch.gather(ids, -1, idx.long()), d
    kk = min(k, L)
    vals, idx = torch.sort(dists, dim=-1, stable=True)
    out_i, out_d = torch.gather(ids, -1, idx[..., :kk]), vals[..., :kk]
    if k > kk:
        shape = out_i.shape[:-1] + (k - kk,)
        out_i = torch.cat([out_i, torch.full(shape, _INT32_MAX, dtype=out_i.dtype,
                                             device=out_i.device)], dim=-1)
        out_d = torch.cat([out_d, torch.full(shape, float("inf"), dtype=out_d.dtype,
                                             device=out_d.device)], dim=-1)
    return out_i, out_d


def topk_iter(dists: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest entries per row as (int32 positions, values), ascending,
    ties to the lowest position.

    k passes of argmin with positional masking, as the JAX twin: once a
    row's finite entries run out, argmin keeps returning the lowest +inf
    position, which the tests compare bit for bit.  Above ``_ITER_K_MAX``
    one stable sort replaces the loop and positions past the row length
    pad with ``L`` and +inf.
    """
    L = dists.shape[-1]
    if k > _ITER_K_MAX:
        kk = min(k, L)
        vals, j = torch.sort(dists, dim=-1, stable=True)
        j, d = j[..., :kk].to(torch.int32), vals[..., :kk]
        if kk < k:
            shape = j.shape[:-1] + (k - kk,)
            j = torch.cat([j, torch.full(shape, L, dtype=torch.int32,
                                         device=j.device)], dim=-1)
            d = torch.cat([d, torch.full(shape, float("inf"), dtype=d.dtype,
                                         device=d.device)], dim=-1)
        return j, d
    if k == 0:
        return (torch.empty(dists.shape[:-1] + (0,), dtype=torch.int32,
                            device=dists.device), dists[..., :0])
    inf = _inf_like(dists)
    out_j, out_d = [], []
    cur = dists
    for _ in range(k):
        j = torch.argmin(cur, dim=-1, keepdim=True)
        out_j.append(j.to(torch.int32))
        out_d.append(torch.gather(cur, -1, j))
        cur = cur.scatter(-1, j, inf.expand_as(j))
    return torch.cat(out_j, dim=-1), torch.cat(out_d, dim=-1)


def sentinel_pad(ids: torch.Tensor, dists: torch.Tensor, sentinel: int):
    """Force masked entries (id >= sentinel) to (sentinel, +inf)."""
    mask = ids >= sentinel
    return (torch.where(mask, torch.full_like(ids, sentinel), ids),
            torch.where(mask, _inf_like(dists), dists))
