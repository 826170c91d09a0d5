"""Quality scoring against an exact oracle (the numpy ``recall_at_k`` of
``approximatenn_tpu/harness/scoring.py``, copied so the port never imports
the JAX package)."""

from __future__ import annotations

import numpy as np
import torch


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
