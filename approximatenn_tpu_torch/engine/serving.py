"""Serving facade (port of ``approximatenn_tpu/engine/serving.py``).

``Server`` picks the engine for a corpus: **exact** or **hash** (the
reference algorithm, over the padded tables with ``layout="table"`` or
over the packed bucket-CSR view with ``layout="packed"``).
``mode="auto"`` picks exact up to ``exact_max_n`` points and hash beyond
(:func:`serving_mode`).  Exact mode on a CUDA corpus runs the JAX
package's routing rule, ``ops/twophase.py:route``: the two-phase engine
(emit + rescan kernels) from ``twophase_min_n`` points when k + 2 <= 128
and past k = 128, else the rank kernel family.  On the CPU it runs the
float oracle.  Packed hash serving on a CUDA view runs
``search_packed_fused`` (the probe-window kernel) from ``fused_min_batch``
queries (0: always, the JAX default on an accelerator), the plain
``search_packed`` otherwise and on the CPU.

The routing thresholds are injectable.  ``twophase_min_n``'s default is
measured on this card (``ops/twophase.py:TWOPHASE_MIN_N``); the others are
the JAX package's values, not yet measured here (PERF.md).
The JAX package's lane-padded corpus is TPU layout and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from ..config import default_device
from ..ops.exact import KMAX, exact_kernel, exact_search, stream_dtype
from ..ops.twophase import (TWOPHASE_MIN_N, big_k_route, exact_knn_twophase, route,
                            takes_twophase)
from ..utils.profiling import build_stage, span

# the JAX package's defaults (see the module docstring)
EXACT_MAX_N_DEFAULT = 8_000_000
# packed serving takes the probe kernel from this batch size on a CUDA view
FUSED_MIN_BATCH = 0
# the fused path's TPU knobs, which have no counterpart here
_TPU_ONLY_KW = frozenset({"query_block", "interpret", "pos_mode"})


def fused_min_batch(n: int) -> int:
    """Smallest batch that packed serving sends to the probe kernel for an
    n-point view: ``FUSED_MIN_BATCH`` at every n, as in the JAX package."""
    return FUSED_MIN_BATCH


def default_exact_max_n(itemsize: int) -> int:
    """Auto mode's default ``exact_max_n`` for stored rows of ``itemsize``
    bytes a value: x2 for 2-byte rows, x4 for 1-byte rows."""
    return EXACT_MAX_N_DEFAULT * {1: 4, 2: 2}.get(itemsize, 1)


def serving_mode(mode: str, n: int, k: int, exact_max_n: int, quantized: bool) -> str:
    """The mode of a server of n rows (a shard's on a mesh): "auto" is exact
    for int8 and up to ``exact_max_n`` rows where k <= 128 or the big-k
    route applies (the JAX rule), else hash; int8 is exact only."""
    if mode == "auto":
        fits = n <= exact_max_n and (k <= KMAX or big_k_route(n, k))
        mode = "exact" if quantized or fits else "hash"
    if mode not in ("exact", "hash"):
        raise ValueError(f"unknown mode {mode!r}")
    if quantized and mode != "exact":
        raise ValueError("storage_dtype=int8 serves the exact engine only; pass mode='exact'")
    return mode


def packed_route(n: int, batch: int, on_card: bool, min_batch: int | None = None) -> str:
    """The engine a plain packed ``Server.search`` runs: "fused" (the probe
    kernel) on a CUDA view from ``min_batch`` (default
    :func:`fused_min_batch`) queries, else "plain" (``search_packed``; the
    JAX package calls it "xla")."""
    thr = fused_min_batch(n) if min_batch is None else min_batch
    return "fused" if on_card and batch >= thr else "plain"


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
    packed: Any = None  # PackedIndex when layout == "packed"
    n_probes: int | None = None
    scale: float | None = None  # int8 storage tier's quantization step
    # search knobs pinned on the handle (a tuned rerank_width, stream=True,
    # ...): merged under every call's keywords, which override them
    _search_kw: dict = field(default_factory=dict)
    twophase_min_n: int = TWOPHASE_MIN_N
    # packed serving's batch threshold for the probe kernel (None: default)
    fused_min_batch: int | None = None
    # exact mode's ops.twophase.takes_twophase at build
    _twophase: bool = False

    @classmethod
    def build(cls, points, k: int, *, mode: str = "auto", metric: str = "l2",
              exact_max_n: int | None = None, layout: str = "table",
              window: int | None = None, n_probes: int | None = None,
              storage_dtype=None, packed_dtype=None,
              twophase_min_n: int | None = None, fused_min_batch: int | None = None,
              device=None, **build_kw) -> "Server":
        """``storage_dtype``: torch.bfloat16 / float16 store the corpus at
        half width (exact engine streams it as stored); torch.int8
        quantizes symmetrically (exact mode only, scale kept on the
        server).  ``layout="packed"`` serves hash mode through the packed
        view (``window`` read depth, ``packed_dtype`` row type, see
        :meth:`ANNIndex.packed`).  ``twophase_min_n`` and
        ``fused_min_batch`` override the routing defaults.  ``device``
        defaults to a tensor's own device and to the CUDA card otherwise
        (see :func:`config.default_device`).  A ``stage_times`` build
        keyword (:class:`~..utils.profiling.StageTimes`) also records the
        packed view's stage, "pack".  The call is the root span
        ``server.build``, each stage the span ``build.<stage>``."""
        if layout not in ("table", "packed"):
            raise ValueError(f"unknown layout {layout!r}")
        with span("server.build", rows=len(points)):
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
                exact_max_n = default_exact_max_n(points.element_size())
            mode = serving_mode(mode, n, k, exact_max_n, quantized)
            if metric != "l2" and not quantized:
                points = prepare_points(points, metric)
            tp_min = TWOPHASE_MIN_N if twophase_min_n is None else twophase_min_n
            srv = cls(points=points, k=k, mode=mode, metric=metric,
                      n_probes=n_probes, scale=scale, twophase_min_n=tp_min,
                      fused_min_batch=fused_min_batch,
                      _twophase=(mode == "exact"
                                 and takes_twophase(n, k, points.element_size(), tp_min)))
            if mode == "hash":
                from .build import build

                srv.index, _, _ = build(points, k, metric=metric, store_points=True,
                                        **build_kw)
                if layout == "packed":
                    with build_stage("pack", build_kw.get("stage_times"), rows=n) as sink:
                        srv.packed = srv.index.packed(window=window, dtype=packed_dtype)
                        sink.append(srv.packed.point_rows)
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
        int32, squared distances), sentinel n past the real candidates.
        The call is the root span ``server.search``."""
        with span("server.search", rows=len(queries)):
            return self._search(queries, k, kw)

    def _search(self, queries, k: int | None, kw: dict):
        k = self.k if k is None else k
        queries = torch.as_tensor(queries, device=self.points.device)
        if self.mode == "exact":
            if self.metric != "l2":
                from ..data.preprocess import prepare_points

                qdt = torch.float32 if self.points.dtype == torch.int8 else self.points.dtype
                queries = prepare_points(queries.to(qdt), self.metric)
            skw = {**self._search_kw, **kw}
            # popped whichever way routing goes: neither engine takes it
            no_tp = bool(skw.pop("no_twophase", False))
            # a per-call or pinned scale overrides the stored one, as in the
            # JAX Server, whose scale lives in _search_kw
            scale = skw.pop("scale", self.scale)
            if self._route_twophase(k, no_tp, skw):
                # a float64 corpus runs the kernels in float32, as exact_search does
                pts = self.points if self.points.element_size() <= 4 else self.points.float()
                return exact_knn_twophase(pts, queries.float().contiguous(), k,
                                          scale=scale, **skw)
            # the Server made the routing decision: exact_search must not
            # re-make it with its own threshold
            return exact_search(self.points, queries, k, scale=scale,
                                no_twophase=True, **skw)
        kw = {**self._search_kw, **kw}
        kw.setdefault("n_probes", self.n_probes)
        if self.packed is not None:
            return self._search_packed(queries, kw)
        from .search import search

        return search(self.index, queries=queries, **kw)

    def _search_packed(self, queries, kw: dict):
        """Packed hash serving: the probe kernel by ``packed_route`` unless
        ``block_rows``/``budget_bytes`` pin the plain path; ``window``
        reaches both.  The TPU kernel's knobs raise rather than being
        ignored."""
        from .search import search_packed, search_packed_fused

        given = {key for key, v in kw.items() if v is not None}
        tpu_only = sorted(_TPU_ONLY_KW & given)
        if tpu_only:
            raise ValueError(f"{tpu_only}: TPU-kernel knobs of the JAX package, with "
                             "no counterpart on this package's probe kernel")
        for key in _TPU_ONLY_KW:
            kw.pop(key, None)
        window = kw.pop("window", None)
        plain_only = {"budget_bytes", "block_rows"} & given
        on_card = self.packed.device.type == "cuda"
        if not plain_only and packed_route(self.packed.n, queries.shape[0], on_card,
                                           self.fused_min_batch) == "fused":
            return search_packed_fused(self.packed, queries=queries, window=window, **kw)
        pv = self.packed if window is None else self.packed.with_window(window)
        return search_packed(pv, queries=queries, **kw)

    def exact_engine(self, **kw) -> str | None:
        """The engine ``search(queries, **kw)`` runs in exact mode (pinned
        knobs under ``kw``, as ``search`` merges them): "cuda-twophase",
        "cuda-rank", "cuda-rescan", "cuda-stream" or "cuda-segment-merge"
        (``merge="twophase"``; the hand-written kernels) on a CUDA corpus, "oracle" on the CPU and for brute force
        on the card (k > 128 close to n)."""
        if self.mode != "exact":
            return None
        skw = {**self._search_kw, **kw}
        no_tp = bool(skw.pop("no_twophase", False))
        if self._route_twophase(self.k, no_tp, skw):
            return "cuda-twophase"
        if self.points.device.type == "cuda" and self.k <= KMAX:
            kernel = exact_kernel(skw.get("merge", "rank"), skw.get("stream", False))
            return "cuda-" + ("segment-merge" if kernel == "twophase" else kernel)
        return "oracle"

    def _repack(self) -> None:
        if self.packed is not None:
            self.packed = self.index.packed(window=self.packed.window,
                                            dtype=self.packed.point_rows.dtype)

    def add_points(self, new_points) -> "Server":
        """Append rows with ids n..n+m-1, in place (returns self).  Exact
        mode: the rows are metric-prepared (the angular normalisation in
        float32), converted straight to the stored tier (int8 through
        float32 with the server's scale; values past the grid clip) and
        appended.  Hash mode: :meth:`ANNIndex.add_points`, then a re-pack
        of the packed view at its window and row type."""
        new_points = torch.as_tensor(new_points, device=self.points.device)
        if self.mode == "exact":
            from ..data.preprocess import prepare_points

            if self.metric != "l2":
                new_points = prepare_points(new_points.float(), self.metric)
            if self.points.dtype == torch.int8:
                new_points = torch.clamp(torch.round(new_points.float() / self.scale),
                                         -127, 127)
            self.points = torch.cat([self.points, new_points.to(self.points.dtype)])
            return self
        self.index = self.index.add_points(new_points)
        self.points = self.index.points
        with span("add_points: re-pack", rows=len(new_points)):
            self._repack()
        return self

    def remove_points(self, ids) -> "Server":
        """Remove rows by id, in place (returns self).  Exact mode compacts
        the corpus (rows keep their order; ids above a removed row shift
        down) and raises ``ValueError`` for an id outside [0, n).  Hash
        mode tombstones through :meth:`ANNIndex.remove_points` (ids stay
        stable) and re-packs."""
        if self.mode == "exact":
            n = self.points.shape[0]
            uids = torch.unique(torch.as_tensor(ids).reshape(-1).long())
            if uids.numel() and (int(uids[0]) < 0 or int(uids[-1]) >= n):
                raise ValueError(f"ids to remove must lie in [0, {n})")
            keep = torch.ones(n, dtype=torch.bool, device=self.points.device)
            keep[uids.to(self.points.device)] = False
            self.points = self.points[keep]
            return self
        self.index = self.index.remove_points(ids)
        self._repack()
        return self

    def describe(self, **kw) -> dict:
        """What the handle serves; ``kw``: the knobs of a ``search`` call
        (``no_twophase``, ``merge``, ``stream``, ``compute_dtype``, ...)
        over the pinned ones, for the exact engine that call runs and, on a
        CUDA kernel of the rank family, the type its corpus streams at."""
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
            engine = self.exact_engine(**kw)
            d["exact_engine"] = engine
            if engine in ("cuda-rank", "cuda-rescan", "cuda-stream"):
                cdt = stream_dtype(self.points.dtype,
                                   {**self._search_kw, **kw}.get("compute_dtype"))
                d["compute_dtype"] = str(cdt).replace("torch.", "")
        if self.index is not None:
            d["layout"] = "packed" if self.packed is not None else "table"
            d["index_mb"] = round((self.packed or self.index).memory_bytes() / 2**20, 1)
        return d
