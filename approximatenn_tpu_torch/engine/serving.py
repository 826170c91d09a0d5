"""Serving facade (port of ``approximatenn_tpu/engine/serving.py``).

``Server`` picks the engine for a corpus: **exact** or **hash** (the
reference algorithm over the padded tables).  ``mode="auto"`` picks exact
up to ``exact_max_n`` points and hash beyond.  Exact mode on a CUDA corpus
runs the JAX package's routing: the two-phase engine (emit + rescan
kernels, ``ops/twophase.py``) from ``twophase_min_n`` points when k + 2 <=
128, and for every k > 128 unless k is close to n; the rank kernel
otherwise.  On the CPU it runs the float oracle.

The routing thresholds are injectable.  Their defaults are the JAX
package's, which were measured on a TPU v5e and are not evidence for this
card; PERF.md records the H100 crossover to retune them from.
The JAX package's lane-padded corpus is TPU layout and is not ported.
``layout="packed"`` waits for the packed slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..config import default_device
from ..ops.exact import KMAX, exact_search
from ..ops.twophase import TWOPHASE_MIN_N
from ..ops.twophase import TWOPHASE_ONLY_KW as _TWOPHASE_ONLY_KW
from ..ops.twophase import exact_knn_twophase, route

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
    twophase_min_n: int = TWOPHASE_MIN_N
    # exact mode from twophase_min_n points with k + 2 <= 128 (set at build)
    _twophase: bool = False

    @classmethod
    def build(cls, points, k: int, *, mode: str = "auto", metric: str = "l2",
              exact_max_n: int | None = None, layout: str = "table",
              n_probes: int | None = None, storage_dtype=None,
              twophase_min_n: int | None = None, device=None,
              **build_kw) -> "Server":
        """``storage_dtype``: torch.bfloat16 / float16 store the corpus at
        half width (exact engine streams it as stored); torch.int8
        quantizes symmetrically (exact mode only, scale kept on the
        server).  ``twophase_min_n`` overrides ``TWOPHASE_MIN_N``.
        ``device`` defaults to a tensor's own device and to the CUDA card
        otherwise (see :func:`config.default_device`)."""
        if layout != "table":
            raise NotImplementedError(
                "layout='packed' is not ported to the PyTorch package yet "
                "(ROADMAP queue A, item 9)")
        points = torch.as_tensor(points, device=default_device(points, device))
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
            # the JAX rule: k > 128 stays exact where the two-phase
            # engine's big-k route applies
            mode = ("exact" if quantized
                    or (n <= exact_max_n and (k <= 128 or n >= 8 * (k + 2)))
                    else "hash")
        if mode not in ("exact", "hash"):
            raise ValueError(f"unknown mode {mode!r}")
        if quantized and mode != "exact":
            raise ValueError("storage_dtype=int8 serves the exact engine only")
        if metric != "l2" and not quantized:
            points = prepare_points(points, metric)
        tp_min = TWOPHASE_MIN_N if twophase_min_n is None else twophase_min_n
        srv = cls(points=points, k=k, mode=mode, metric=metric,
                  n_probes=n_probes, scale=scale, twophase_min_n=tp_min,
                  _twophase=(mode == "exact" and n >= tp_min and k + 2 <= KMAX
                             and points.element_size() <= 4))
        if mode == "hash":
            from .build import build

            srv.index, _, _ = build(points, k, metric=metric, store_points=True,
                                    **build_kw)
        return srv

    def _route_twophase(self, k: int, no_twophase: bool = False,
                        skw: dict | None = None) -> bool:
        """Whether an exact-mode search with these knobs runs the two-phase
        engine: the one predicate ``search`` and ``describe`` share.  On a
        CUDA corpus it is :func:`~..ops.twophase.route` with the build's
        ``twophase_min_n``, where k <= 128 also needs the build to have
        enabled the engine (``_twophase``).  The JAX package sends
        ``Server`` k > 128 to brute force, because the ``no_twophase`` it
        forwards fails ``exact_search``'s big-k keyword gate (its
        ``engine/serving.py:328``, ``ops/pallas_exact.py:1635``); the port
        serves it as intended."""
        if self.points.device.type != "cuda":
            return False
        return route(self.points.shape[0], k, skw or {}, no_twophase or not self._twophase,
                     min_n=self.twophase_min_n) == "twophase"

    def search(self, queries, k: int | None = None, **kw):
        """k exact or approximate nearest neighbours per query row: (ids
        int32, squared distances), sentinel n past the real candidates."""
        k = self.k if k is None else k
        queries = torch.as_tensor(queries, device=self.points.device)
        if self.mode == "exact":
            if self.metric != "l2":
                from ..data.preprocess import prepare_points

                qdt = torch.float32 if self.points.dtype == torch.int8 else self.points.dtype
                queries = prepare_points(queries.to(qdt), self.metric)
            skw = dict(kw)
            # popped whichever way routing goes: neither engine takes it
            no_tp = bool(skw.pop("no_twophase", False))
            if self._route_twophase(k, no_tp, skw):
                # a float64 corpus runs the kernels in float32, as exact_search does
                pts = self.points if self.points.element_size() <= 4 else self.points.float()
                return exact_knn_twophase(pts, queries.float().contiguous(), k,
                                          scale=self.scale, **skw)
            for key in _TWOPHASE_ONLY_KW:
                skw.pop(key, None)
            # the Server made the routing decision: exact_search must not
            # re-make it with its own threshold
            return exact_search(self.points, queries, k, scale=self.scale,
                                no_twophase=True, **skw)
        from .search import search

        kw.setdefault("n_probes", self.n_probes)
        return search(self.index, queries=queries, **kw)

    def exact_engine(self) -> str | None:
        """The engine a plain ``search`` runs in exact mode:
        "cuda-twophase" or "cuda-rank" (the hand-written kernels) on a CUDA
        corpus, "oracle" on the CPU and for brute force on the card (k >
        128 close to n)."""
        if self.mode != "exact":
            return None
        if self._route_twophase(self.k):
            return "cuda-twophase"
        if self.points.device.type == "cuda" and self.k <= KMAX:
            return "cuda-rank"
        return "oracle"

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
