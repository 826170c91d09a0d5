"""Synthetic vector generators (a copy of
``approximatenn_tpu/data/synthetic.py``, numpy only, so the port never
imports the JAX package).  The same generator state gives the same array
as the JAX package's functions.

``gaussian`` is iid N(0, 1) test data.  ``clustered_gaussian`` adds the
skewed, clustered structure of real embedding corpora, which iid Gaussian
lacks (and which exercises bucket occupancy realistically).
"""

from __future__ import annotations

import numpy as np


def gaussian(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    return rng.standard_normal((n, d)).astype(np.float32)


def clustered_gaussian(
    rng: np.random.Generator,
    n: int,
    d: int,
    *,
    n_clusters: int = 64,
    spread: float = 4.0,
    zipf: float = 1.2,
) -> np.ndarray:
    """Mixture of Gaussians with Zipf-distributed cluster sizes.

    Cluster centers ~ N(0, spread^2); members ~ N(center, 1).  Generated in
    blocks to bound host memory for multi-million-point corpora.
    """
    centers = spread * rng.standard_normal((n_clusters, d)).astype(np.float32)
    weights = 1.0 / np.arange(1, n_clusters + 1) ** zipf
    weights /= weights.sum()
    assign = rng.choice(n_clusters, size=n, p=weights)
    out = np.empty((n, d), np.float32)
    block = 1 << 20
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        out[lo:hi] = centers[assign[lo:hi]] + rng.standard_normal(
            (hi - lo, d)
        ).astype(np.float32)
    return out
