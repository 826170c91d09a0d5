"""Metric preprocessing (port of ``approximatenn_tpu/data/preprocess.py``).

Angular search is L2 search on unit-normalised rows: for unit u, v,
``|u - v|^2 = 2 - 2 cos``, a monotone map.
"""

from __future__ import annotations

import numpy as np
import torch

METRICS = ("l2", "angular")


def normalize(x, eps: float = 1e-30):
    """Unit-normalise rows of a numpy array or a tensor."""
    if isinstance(x, np.ndarray):
        nrm = np.sqrt((x.astype(np.float64) ** 2).sum(-1, keepdims=True))
        return (x / np.maximum(nrm, eps)).astype(x.dtype)
    nrm = torch.sqrt((x * x).sum(-1, keepdim=True))
    return x / torch.clamp(nrm, min=eps)


def prepare_points(points, metric: str):
    """Apply the metric's preprocessing to a point or query matrix."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; want one of {METRICS}")
    return normalize(points) if metric == "angular" else points
