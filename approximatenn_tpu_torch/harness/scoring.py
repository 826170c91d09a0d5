"""Quality scoring against an exact oracle (port of
``approximatenn_tpu/harness/scoring.py``: numpy, the port's native
``rank_guesses``, and ``ids_agree`` for comparing two engines).

The reference harness's metrics (its ``test_correctness.c:134-140,
169-262``):

- mean excess rank  = (mean sum-of-true-ranks per query - k(k-1)/2) / k
- "Prob correct"    = fraction of guesses whose true rank < k  (recall@k)
- max index score   = worst true rank seen / k

Ranks are 0-based positions in the exact distance ordering; in index
(self-query) mode the self-match is excluded from the ranking.  Sentinel
guesses (id == n, emitted when candidates run out) are scored at the worst
rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Score:
    mean_excess_rank: float
    prob_correct: float
    max_rank_over_k: float

    def __str__(self) -> str:
        return (
            f"excess_rank={self.mean_excess_rank:.4g} "
            f"prob_correct={self.prob_correct:.4g} "
            f"max_rank/k={self.max_rank_over_k:.4g}"
        )


def _sq_dists(y: np.ndarray, points: np.ndarray) -> np.ndarray:
    y = np.asarray(y, np.float64)
    p = np.asarray(points, np.float64)
    return (
        (y * y).sum(1)[:, None] + (p * p).sum(1)[None, :] - 2.0 * (y @ p.T)
    )


def true_ranks(points: np.ndarray, y: np.ndarray | None) -> np.ndarray:
    """(m, n) matrix of each point's 0-based rank for each query.

    y=None is index mode: queries are the points themselves and self-matches
    are pushed to the end (rank n-1).
    """
    if y is None:
        dd = _sq_dists(points, points)
        np.fill_diagonal(dd, np.inf)
    else:
        dd = _sq_dists(y, points)
    order = np.argsort(dd, axis=1, kind="stable")
    inv = np.empty_like(order)
    m, n = order.shape
    inv[np.arange(m)[:, None], order] = np.arange(n)[None, :]
    return inv


def score_guesses(
    points: np.ndarray, y: np.ndarray | None, guess: np.ndarray, k: int
) -> Score:
    """Score one run's guesses (role of the reference's ``cscore``).

    Large problems (m*n > 5e7, where the (m, n) rank matrix stops fitting)
    route to the multithreaded native scorer, which counts strictly-closer
    points per guess: identical up to distance ties.
    """
    m = len(points) if y is None else len(y)
    if m * len(points) > 50_000_000:
        from ..native import rank_guesses

        rank_sum, miss, mx = rank_guesses(
            points,
            points if y is None else y,
            np.asarray(guess)[:, :k],
            exclude_self_offset=0 if y is None else -1,
        )
        mean_excess = (rank_sum.mean() - k * (k - 1) / 2) / k
        return Score(
            float(mean_excess),
            float(1.0 - miss.sum() / (m * k)),
            float(mx.max() / k),
        )
    inv = true_ranks(points, y)
    m, n = inv.shape
    guess = np.asarray(guess)[:, :k]
    sent = guess >= n
    ranks = inv[np.arange(m)[:, None], np.where(sent, 0, guess)]
    ranks = np.where(sent, n, ranks).astype(np.float64)
    mean_excess = (ranks.sum(1).mean() - k * (k - 1) / 2) / k
    prob_correct = float((ranks < k).mean())
    return Score(float(mean_excess), prob_correct, float(ranks.max() / k))


def recall_at_k(true_ids: np.ndarray, guess: np.ndarray, k: int) -> float:
    """Set recall@k against a ground-truth id matrix (equivalent to 'Prob
    correct' up to distance ties at the k boundary)."""
    true_ids = np.asarray(true_ids)[:, :k]
    guess = np.asarray(guess)[:, :k]
    hits = sum(
        len(set(map(int, t)) & set(map(int, g))) for t, g in zip(true_ids, guess)
    )
    return hits / (true_ids.shape[0] * k)


def ids_agree(ids_a, ids_b, d_ref, rtol: float = 1e-5) -> tuple[bool, int]:
    """Ids equal position by position, except where the reference's
    distances at that position and a neighbour (k + 1 entries given) lie
    within ``rtol``: a near-tie the two summation orders may break either
    way.  Returns (ok, rows exempted by a near-tie)."""
    k = ids_a.shape[1]
    diff = ids_a != ids_b
    rows = torch.nonzero(diff.any(1)).squeeze(1)
    if rows.numel() == 0:
        return True, 0
    d = torch.as_tensor(d_ref)[rows].double()
    gap = (d[:, 1:] - d[:, :-1]).abs() <= rtol * d[:, 1:].abs().clamp_min(1e-30)
    near = torch.zeros((rows.numel(), k), dtype=torch.bool, device=d.device)
    nxt = min(k, gap.shape[1])
    near[:, :nxt] |= gap[:, :nxt]  # tie with the next entry (k-th vs (k+1)-th)
    prv = min(k - 1, gap.shape[1])
    near[:, 1: 1 + prv] |= gap[:, :prv]  # tie with the previous entry
    ok = bool((~diff[rows] | near).all())
    return ok, int(rows.numel())
