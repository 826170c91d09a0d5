"""Serving facade (port of ``approximatenn_tpu/engine/serving.py``).

``Server`` picks the engine for a corpus: **exact** (the exact-kNN CUDA
kernel at every n on the card, the float oracle on the CPU) or **hash**
(the reference algorithm over the padded tables).  ``mode="auto"`` picks
exact up to ``exact_max_n`` points and hash beyond.

The routing thresholds are injectable.  Their defaults are the JAX
package's, which were measured on a TPU v5e and are not evidence for this
card: they stand only until the port measures its own.  The two-phase
exact engine (and with it the JAX package's 500k-point route and lane
padding) is not ported yet, so exact mode always runs the rank kernel and
needs k <= 128 on CUDA.  ``layout="packed"`` waits for the packed slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

# the JAX package's v5e-measured defaults (see the module docstring)
EXACT_MAX_N_DEFAULT = 8_000_000


@dataclass
class Server:
    """One-stop serving handle over a point corpus.

    >>> srv = Server.build(points, k=10)          # picks the engine by size
    >>> ids, dists = srv.search(queries)
    >>> srv.describe()
    """

    points: Any
    k: int
    mode: str
    metric: str = "l2"
    index: Any = None  # ANNIndex when mode == "hash"
    n_probes: int | None = None
    scale: float | None = None  # int8 storage tier's quantization step

    @classmethod
    def build(cls, points, k: int, *, mode: str = "auto", metric: str = "l2",
              exact_max_n: int | None = None, layout: str = "table",
              n_probes: int | None = None, storage_dtype=None, device=None,
              **build_kw) -> "Server":
        """``storage_dtype``: torch.bfloat16 / float16 store the corpus at
        half width (exact engine streams it as stored); torch.int8
        quantizes symmetrically (exact mode only, scale kept on the
        server).  ``device`` defaults to the points' device."""
        if layout != "table":
            raise NotImplementedError(
                "layout='packed' is not ported to the PyTorch package yet "
                "(ROADMAP queue A, item 9)")
        if device is None:
            device = points.device if isinstance(points, torch.Tensor) else "cpu"
        points = torch.as_tensor(points, device=device)
        from ..data.preprocess import prepare_points

        quantized = storage_dtype == torch.int8
        scale = None
        if quantized:
            if metric != "l2":
                # normalize BEFORE quantizing: the grid covers the unit sphere
                points = prepare_points(points.float(), metric)
            from ..ops.exact import quantize_corpus

            points, s = quantize_corpus(points)
            scale = float(s)
        elif storage_dtype is not None:
            points = points.to(storage_dtype)
        n = points.shape[0]
        if exact_max_n is None:
            exact_max_n = EXACT_MAX_N_DEFAULT
            if points.element_size() <= 2:
                exact_max_n *= 2
            if points.element_size() == 1:
                exact_max_n *= 2
        if mode == "auto":
            # the JAX rule, k > 128 included (on CUDA that search raises
            # until the two-phase kernels are ported)
            mode = ("exact" if quantized
                    or (n <= exact_max_n and (k <= 128 or n >= 8 * (k + 2)))
                    else "hash")
        if mode not in ("exact", "hash"):
            raise ValueError(f"unknown mode {mode!r}")
        if quantized and mode != "exact":
            raise ValueError("storage_dtype=int8 serves the exact engine only")
        if metric != "l2" and not quantized:
            points = prepare_points(points, metric)
        srv = cls(points=points, k=k, mode=mode, metric=metric,
                  n_probes=n_probes, scale=scale)
        if mode == "hash":
            from .build import build

            srv.index, _, _ = build(points, k, metric=metric, store_points=True,
                                    **build_kw)
        return srv

    def search(self, queries, k: int | None = None, **kw):
        """k exact or approximate nearest neighbours per query row: (ids
        int32, squared distances), sentinel n past the real candidates."""
        k = self.k if k is None else k
        queries = torch.as_tensor(queries, device=self.points.device)
        if self.mode == "exact":
            from ..ops.exact import exact_search

            if self.metric != "l2":
                from ..data.preprocess import prepare_points

                qdt = torch.float32 if self.points.dtype == torch.int8 else self.points.dtype
                queries = prepare_points(queries.to(qdt), self.metric)
            return exact_search(self.points, queries, k, scale=self.scale, **kw)
        from .search import search

        kw.setdefault("n_probes", self.n_probes)
        return search(self.index, queries=queries, **kw)

    def exact_engine(self) -> str | None:
        """The engine a plain ``search`` runs in exact mode: "cuda-rank" (the
        hand-written kernel) on a CUDA corpus, "oracle" on the CPU."""
        if self.mode != "exact":
            return None
        return "cuda-rank" if self.points.device.type == "cuda" else "oracle"

    def add_points(self, *a, **kw):
        raise NotImplementedError("Server.add_points is not ported to the "
                                  "PyTorch package yet (ROADMAP queue A, item 10)")

    def remove_points(self, *a, **kw):
        raise NotImplementedError("Server.remove_points is not ported to the "
                                  "PyTorch package yet (ROADMAP queue A, item 10)")

    def describe(self) -> dict:
        d = {
            "mode": self.mode,
            "n": int(self.points.shape[0]),
            "d": int(self.points.shape[1]),
            "k": self.k,
            "metric": self.metric,
            # 1.0 only for full-precision exact; a rounded corpus is exact
            # over its stored values, not the originals
            "recall": (1.0 if self.mode == "exact" and self.points.element_size() >= 4
                       else None),
            "storage_dtype": str(self.points.dtype).replace("torch.", ""),
            "device": str(self.points.device),
        }
        if self.mode == "exact":
            d["exact_engine"] = self.exact_engine()
        if self.index is not None:
            d["layout"] = "table"
            d["index_mb"] = round(self.index.memory_bytes() / 2**20, 1)
        return d
