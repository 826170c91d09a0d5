"""Corpus and query pool of a configuration, drawn on the device from the
run's seed.

The mixture is the one of ``data/synthetic.py:clustered_gaussian`` (cluster
centres ~ N(0, spread^2), Zipf(zipf) cluster weights, members ~ N(centre,
1)), rewritten to draw with a ``torch.Generator`` on the device in a few
large calls.  The query pool is further draws of the same mixture, after
the corpus: held out, not corpus rows.  The same seed gives the same
corpus and pool on the same device and shapes.
"""

from __future__ import annotations

import torch

_BLOCK_ROWS = 1 << 22


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any int up to 2**63)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def _draw(gen, centers, cdf, n: int) -> torch.Tensor:
    d = centers.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=centers.device)
    for lo in range(0, n, _BLOCK_ROWS):
        hi = min(lo + _BLOCK_ROWS, n)
        u = torch.rand(hi - lo, generator=gen, device=centers.device, dtype=torch.float64)
        assign = torch.searchsorted(cdf, u).clamp_(max=centers.shape[0] - 1)
        out[lo:hi] = torch.randn((hi - lo, d), generator=gen, device=centers.device)
        out[lo:hi] += centers[assign]
    return out


def draw(config: dict, seed: int, device, n: int | None = None,
         n_queries: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(corpus (n, d) float32, queries (n_queries, d) float32) on
    ``device``, from ``config["data"]`` and ``seed``.  ``n``/``n_queries``
    override the configuration's sizes (tests)."""
    spec = config["data"]
    if spec["kind"] != "clustered_gaussian":
        raise ValueError(f"unknown data kind {spec['kind']!r}")
    n = config["n"] if n is None else n
    nq = config["n_queries"] if n_queries is None else n_queries
    d = config["d"]
    gen = generator(seed, device)
    nc = int(spec["n_clusters"])
    centers = float(spec["spread"]) * torch.randn((nc, d), generator=gen, device=device)
    w = 1.0 / torch.arange(1, nc + 1, dtype=torch.float64, device=device) ** float(spec["zipf"])
    cdf = torch.cumsum(w / w.sum(), 0)
    corpus = _draw(gen, centers, cdf, n)
    queries = _draw(gen, centers, cdf, nq)
    return corpus, queries
