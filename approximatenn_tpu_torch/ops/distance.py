"""Candidate distances and the exact oracle (port of
``approximatenn_tpu/ops/distance.py``).

Distances are **squared** L2 on the raw (uncentered) coordinates.
Sentinel candidates (id >= n) and, during the build, self-matches get +inf
through explicit masks.  ``blocked_over_rows`` is a Python loop over row
blocks: it bounds the (B, L, d) gather transient, the one thing the JAX
``lax.map`` form bought besides compilation.
"""

from __future__ import annotations

import torch

from .topk import topk_iter


def candidate_dists(q: torch.Tensor, points: torch.Tensor, cand: torch.Tensor,
                    *, exclude_self: torch.Tensor | None = None,
                    method: str = "diff",
                    point_sqnorms: torch.Tensor | None = None) -> torch.Tensor:
    """Squared L2 distances from each row of ``q`` (m, d) to its candidate
    ids ``cand`` (m, L) in ``points`` (n, d); ids >= n and ids equal to
    ``exclude_self`` (m,) get +inf.  ``method`` 'diff' = sum((q - p)^2),
    'dot' = |q|^2 + |p|^2 - 2 q.p."""
    n = points.shape[0]
    valid = cand < n
    if exclude_self is not None:
        valid = valid & (cand != exclude_self[:, None])
    safe = torch.where(valid, cand, torch.zeros_like(cand)).long()
    pc = points[safe]  # (m, L, d)
    if method == "dot":
        if point_sqnorms is None:
            point_sqnorms = (points * points).sum(-1)
        qn = (q * q).sum(-1)
        dots = torch.einsum("mld,md->ml", pc.to(q.dtype), q)
        dd = qn[:, None] + point_sqnorms[safe] - 2.0 * dots
    else:
        diff = q[:, None, :] - pc
        dd = (diff * diff).sum(-1)
    return torch.where(valid, dd, torch.full((), float("inf"), dtype=dd.dtype,
                                             device=dd.device))


def pick_block(m: int, l: int, d: int, itemsize: int = 4,
               budget_bytes: int = 128 << 20) -> int:
    """Row-block size keeping the (B, L, d) gather transient under budget."""
    per_row = max(1, l * d * itemsize)
    return min(m, max(1, budget_bytes // per_row))


def blocked_over_rows(fn, m: int, block: int, *row_args):
    """Apply ``fn(*blocks) -> out | (out0, ...)`` over row blocks of the
    leading axis and concatenate.  The last block is simply shorter (no
    padding: eager torch has no static shapes to keep)."""
    outs = []
    for lo in range(0, m, block):
        outs.append(fn(*(a[lo: lo + block] for a in row_args)))
    if not isinstance(outs[0], tuple):
        return torch.cat(outs)
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _oracle_block(m: int, n: int, block: int | None) -> int:
    if block is not None:
        return max(1, min(block, m))
    # keep the (B, n) score block near 256 MB
    return max(1, min(m, (64 << 20) // max(1, n), 4096))


def brute_force_knn(points: torch.Tensor, queries: torch.Tensor, k: int,
                    block: int | None = None):
    """Exact kNN of queries against points: (ids (m, k) int32, squared
    distances).  The recall oracle, in the points' dtype (float64 works);
    ties go to the lowest position."""
    pn = (points * points).sum(-1)
    # the product runs in the promoted dtype, as jnp.matmul's promotion does
    cdt = torch.promote_types(points.dtype, queries.dtype)
    pt = points.to(cdt).T

    def one(qb):
        qn = (qb * qb).sum(-1)
        dd = qn[:, None] + pn[None, :] - 2.0 * (qb.to(cdt) @ pt)
        return topk_iter(dd, k)

    m = queries.shape[0]
    return blocked_over_rows(one, m, _oracle_block(m, points.shape[0], block),
                             queries)


def brute_force_knn_self(points: torch.Tensor, k: int, block: int | None = None):
    """Exact kNN graph of a point set against itself, self-match excluded."""
    n = points.shape[0]
    pn = (points * points).sum(-1)
    pt = points.T
    cols = torch.arange(n, device=points.device)

    def one(qb, rows):
        qn = (qb * qb).sum(-1)
        dd = qn[:, None] + pn[None, :] - 2.0 * (qb @ pt)
        dd = dd.masked_fill(cols[None, :] == rows[:, None], float("inf"))
        return topk_iter(dd, k)

    return blocked_over_rows(one, n, _oracle_block(n, n, block), points, cols)
