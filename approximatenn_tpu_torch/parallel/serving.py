"""The serving surface over a sharded corpus (port of
``approximatenn_tpu/parallel/serving.py``): :class:`ShardedServer` and the
tuner :func:`tune_sharded`, on the port's sharded layer (one rank a shard,
``parallel/sharded.py``).

``ShardedServer`` applies the single-card ``Server``'s routing decisions
per shard, as the JAX class does:

- **engine**: exact or hash by the rank's slice size ``n_local``, by the
  single-card rule (``engine/serving.py:serving_mode``), which keeps k >
  128 exact where ``n_local >= 8 * (k + 2)`` (the JAX class sends every k
  > 128 to hash, its ``parallel/serving.py:138-140``);
- **storage tiers**: bf16/f16 rows, or int8 with ONE global scale (the max
  over every rank, one all-reduce), so quantized distances compare across
  shards and the merge is unchanged;
- **two-phase exact**: each shard takes the single-card route
  (``ops/twophase.py:route``) on a CUDA mesh, the rank route on a CPU mesh
  (as the single-card ``Server`` runs the oracle on the CPU).  The corpus
  keeps width d: the JAX class's
  128-lane padding is TPU layout and is not ported;
- **packed hash serving**: the probe kernel (``search_packed_fused_sharded``)
  on a CUDA mesh from ``fused_min_batch`` queries, the plain packed search
  otherwise (``engine/serving.py:packed_route``).

Every method is a collective: every rank calls it with the same global
arguments and gets the same result.  The JAX kernels' TPU knobs
(``interpret``, ``query_block``) raise ``ValueError``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..data.preprocess import prepare_points
from ..engine.serving import default_exact_max_n, packed_route, serving_mode
from ..engine.tuning import _TIER_DTYPES, Trial, _measure_qps, _sample_queries
from ..harness.scoring import recall_at_k
from ..index import _stash, _unstash
from ..ops.exact import KMAX, abs_max, check_tpu_knobs, quantize_corpus
from ..ops.twophase import TWOPHASE_MIN_N, route, takes_twophase
from ..utils.profiling import span
from .checkpoint import (_check_format, _check_one_host, _dtype_name, _read_scale,
                         _write_files, load_sharded_index, load_sharded_packed,
                         save_sharded_index, save_sharded_packed)
from .sharded import (LocalRows, Mesh, ShardedIndex, ShardedPacked, _all_reduce_max,
                      _gather_stacked, _shard_points, build_sharded, packed_sharded,
                      search_exact_sharded, search_packed_fused_sharded,
                      search_packed_sharded, search_sharded)


@dataclass
class ShardedServer:
    """One-stop serving handle over a mesh-sharded corpus.

    >>> srv = ShardedServer.build(points, k=10, mesh=mesh)
    >>> ids, dists = srv.search(queries)      # global ids
    >>> srv.describe()

    ``mode``: "exact", "hash" or "auto" (the slice size decides).  Hash
    build options pass through ``**build_kw`` (tries, capacity, seed,
    graph_mode, bases, ...); ``layout="packed"`` (the default) serves the
    per-shard bucket-CSR views.
    """

    mesh: Mesh
    k: int
    mode: str
    metric: str = "l2"
    n: int = 0
    d_logical: int = 0
    points: Any = None  # exact mode: this rank's rows (n_local, d), zero pad rows last
    # the int8 tier's scale, the same on every rank: a float, as the
    # single-card Server keeps it (a card tensor would sync every search)
    scale: float | None = None
    sidx: ShardedIndex | None = None
    spk: ShardedPacked | None = None
    _search_kw: dict = field(default_factory=dict)
    _twophase: bool = False
    _fused_min_batch: int | None = None

    @classmethod
    def build(cls, points, k: int, *, mesh: Mesh, mode: str = "auto", metric: str = "l2",
              storage_dtype=None, layout: str = "packed", window: int | None = None,
              packed_dtype=None, n_probes: int | None = None, exact_max_n: int | None = None,
              twophase_min_n: int | None = None, fused_min_batch: int | None = None,
              n_true: int | None = None, **build_kw) -> "ShardedServer":
        """Shard the global ``points`` (n, d), pick the per-shard engine and
        stage the serving state: the span ``sharded.build``.  ``points`` may
        be this rank's rows already (:class:`~.sharded.LocalRows`).
        ``storage_dtype`` (exact mode): torch.bfloat16 / float16 halve each
        shard's corpus, torch.int8 quarters it; each rank makes its stored
        rows from its own, a chunk at a time, and keeps rows already in the
        stored form as they are (a bf16 shard served in bf16 is not
        copied).  ``n_true`` (exact mode): the real row count of a corpus
        the caller padded to the shard count, its zero pad rows last.
        ``packed_dtype`` is the packed rows' type (hash)."""
        with span("sharded.build", rows=int(points.shape[0])):
            if layout not in ("table", "packed"):
                raise ValueError(f"unknown layout {layout!r}")
            s = mesh.size
            n, d = points.shape
            n_local = -(-n // s)
            if exact_max_n is None:  # rows are stored as float32 unless storage_dtype
                exact_max_n = default_exact_max_n((storage_dtype or torch.float32).itemsize)
            mode = serving_mode(mode, n_local, k, exact_max_n, storage_dtype == torch.int8)
            if n_true is not None and (mode != "exact" or not n - s < n_true <= n):
                raise ValueError(f"n_true={n_true}: the real row count of an exact corpus of "
                                 f"{n} rows padded to {s} shards")
            srv = cls(mesh=mesh, k=k, mode=mode, metric=metric,
                      n=n if n_true is None else n_true, d_logical=d,
                      _fused_min_batch=fused_min_batch)
            if mode == "hash":
                srv.sidx = build_sharded(points, k, mesh=mesh, metric=metric, store_points=True,
                                         n_probes=n_probes, **build_kw)
                if n_probes is not None:
                    srv._search_kw["n_probes"] = n_probes
                if layout == "packed":
                    srv.spk = packed_sharded(srv.sidx, mesh=mesh, window=window,
                                             dtype=packed_dtype)
                return srv

            pts, srv.scale = _stored_shard(_shard_points(points, mesh), mesh, metric,
                                           storage_dtype)
            tp_min = TWOPHASE_MIN_N if twophase_min_n is None else twophase_min_n
            srv._twophase = takes_twophase(n_local, k, pts.element_size(), tp_min)
            srv.points = pts
            return srv

    def _route_twophase(self, k: int, no_twophase: bool = False) -> bool:
        """Whether an exact search at ``k`` runs the per-shard two-phase
        engine, for ``search`` and ``describe``: the single-card route on a
        CUDA mesh (the JAX class's "interpret or on the accelerator"), over
        this rank's slice, ``_twophase`` its size half, past k = 128 at the
        local k that ``search_exact_sharded`` widens by the pad rows."""
        if self.mode != "exact" or self.mesh.device.type != "cuda":
            return False
        n_local = self.points.shape[0]
        if k > KMAX:
            k = min(k + n_local * self.mesh.size - self.n, n_local)
        return route(n_local, k, {}, no_twophase or not self._twophase, min_n=0) == "twophase"

    def search(self, queries, k: int | None = None, **kw):
        """k nearest neighbours per query row: (global ids (m, k) int32,
        sentinel n; squared distances), the same on every rank.  Per-call
        knobs: hash paths take ``n_probes`` / ``window`` / ``rerank_width`` /
        ``supercharge_rounds``; exact takes ``matmul_precision`` /
        ``no_twophase`` / ``scale`` and, on the two-phase route, ``seg`` /
        ``pad_segments`` / ``rescan`` (ignored on the rank route).  The span
        ``sharded.search`` is the root of the engine's spans and of the
        merge's (``sharded.merge``)."""
        with span("sharded.search", rows=len(queries)):
            check_tpu_knobs(kw)
            for key in ("interpret", "query_block"):
                kw.pop(key, None)
            k = self.k if k is None else k
            queries = torch.as_tensor(queries, device=self.mesh.device)
            skw = {**self._search_kw, **kw}
            if self.mode == "exact":
                queries = prepare_points(queries.float(), self.metric)
                tp = self._route_twophase(k, bool(skw.pop("no_twophase", False)))
                scale = skw.pop("scale", self.scale)
                corpus = LocalRows(self.points, (self.points.shape[0] * self.mesh.size,
                                                 self.points.shape[1]))
                return search_exact_sharded(corpus, queries, k, mesh=self.mesh, scale=scale,
                                            twophase=tp, n_true=self.n, **skw)
            if self.spk is None:
                return search_sharded(self.sidx, None, queries, mesh=self.mesh, **skw)
            window = skw.pop("window", None)
            path = packed_route(self.sidx.n_local, queries.shape[0],
                                self.mesh.device.type == "cuda", self._fused_min_batch)
            fn = search_packed_fused_sharded if path == "fused" else search_packed_sharded
            return fn(self.sidx, self.spk, None, queries, mesh=self.mesh, window=window, **skw)

    def save(self, path) -> None:
        """Persist the serving state in the JAX package's npz layout (a
        collective: every rank calls it).  Exact mode: ``server.json`` and
        the stacked corpus (+ scale) in ``arrays.npz``; hash mode: the
        index and packed checkpoints under ``index/`` and ``packed/``."""
        path = Path(path)
        meta = {"mode": self.mode, "k": self.k, "metric": self.metric, "n": self.n,
                "d_logical": self.d_logical, "twophase": self._twophase,
                "fused_min_batch": self._fused_min_batch,
                "search_kw": dict(self._search_kw)}
        if self.mode == "exact":
            _check_one_host(self.mesh)
            rows = _gather_stacked(self.mesh, self.points, rank0_only=True)
            arrays = None
            if rows is not None:  # rank 0
                rows = rows.reshape(-1, self.points.shape[1])
                meta.update(points_shape=list(rows.shape), points_dtype=_dtype_name(rows.dtype),
                            has_scale=self.scale is not None, format="npz")
                arrays = {}
                _stash(arrays, "points", rows)
                if self.scale is not None:
                    _stash(arrays, "scale", torch.tensor(self.scale, dtype=torch.float32))
            _write_files(self.mesh, path, meta, arrays, meta_file="server.json")
            return
        save_sharded_index(self.sidx, path / "index", self.mesh)
        if self.spk is not None:
            save_sharded_packed(self.spk, path / "packed", self.mesh)
        meta["has_packed"] = self.spk is not None
        _write_files(self.mesh, path, meta, meta_file="server.json")

    @classmethod
    def load(cls, path, *, mesh: Mesh) -> "ShardedServer":
        """Restore onto ``mesh``, ready to serve: a checkpoint of
        :meth:`save` or of the JAX ``ShardedServer.save`` without orbax.
        Index and packed checkpoints need the shard count of the save; an
        exact corpus any count that divides its padded rows.  Lanes past
        the logical d (the JAX package's two-phase and packed padding) are
        dropped."""
        path = Path(path)
        meta = json.loads((path / "server.json").read_text())
        srv = cls(mesh=mesh, k=meta["k"], mode=meta["mode"], metric=meta["metric"],
                  n=meta["n"], d_logical=meta["d_logical"], _twophase=meta["twophase"],
                  _fused_min_batch=meta["fused_min_batch"],
                  _search_kw=dict(meta.get("search_kw") or {}))
        if srv.mode == "hash":
            srv.sidx = load_sharded_index(path / "index", mesh)
            if meta["has_packed"]:
                srv.spk = load_sharded_packed(path / "packed", mesh, d=srv.d_logical)
            return srv
        _check_format(meta, path)
        rows = meta["points_shape"][0]
        if rows % mesh.size:
            raise ValueError(f"the saved corpus has {rows} rows, which {mesh.size} shards "
                             "do not divide")
        per = rows // mesh.size
        with np.load(path / "arrays.npz") as z:
            pts = _unstash(z, "points", None)
            scale = _read_scale(z, "cpu")
        srv.points = pts[mesh.rank * per: (mesh.rank + 1) * per, : srv.d_logical].contiguous() \
            .to(mesh.device)
        srv.scale = None if scale is None else float(scale)
        return srv

    def describe(self) -> dict:
        """What the handle serves, with the JAX class's keys and values."""
        out = {"mode": self.mode, "n": self.n, "d": self.d_logical, "k": self.k,
               "metric": self.metric, "n_shards": self.mesh.size}
        if self.mode == "exact":
            out["n_local"] = self.points.shape[0]
            out["storage_dtype"] = _dtype_name(self.points.dtype)
            big_k = self.k > KMAX and self.mesh.device.type == "cuda"
            out["exact_engine"] = ("twophase" if self._route_twophase(self.k)
                                   else "oracle" if big_k else "rank")
            out["recall"] = 1.0 if self.points.element_size() >= 4 else None
        else:
            out["n_local"] = self.sidx.n_local
            out["layout"] = "packed" if self.spk is not None else "table"
            if self.spk is not None:
                # the whole view, every rank's the same size
                out["index_mb"] = round(self.spk.memory_bytes() * self.mesh.size / 2**20, 1)
                out["packed_dtype"] = _dtype_name(self.spk.point_rows.dtype)
        return out


# rows of a shard widened to float32 at a time while its stored rows are made
_CHUNK_ROWS = 1 << 20


def _stored_shard(local: torch.Tensor, mesh: Mesh, metric: str, storage_dtype):
    """(this rank's rows as an exact shard serves them, the int8 tier's
    scale or None): the rows metric-prepared in float32 (angular: unit rows;
    zero pad rows stay zero, normalize's eps guard) and narrowed to
    ``storage_dtype`` (float32 when None), a chunk of rows at a time, so
    that no float32 copy of a 16-bit shard is made; rows already in that
    form (l2, the stored type) are kept as they are.  int8 takes ONE global
    scale, the max over every rank (one all-reduce), so quantized distances
    compare across shards."""
    dtype = torch.float32 if storage_dtype is None else storage_dtype
    if metric == "l2" and local.dtype == dtype:
        return local.contiguous(), None
    n = local.shape[0]

    def prepared(lo):
        return prepare_points(local[lo: lo + _CHUNK_ROWS].float(), metric)

    scale = None
    if dtype == torch.int8:
        mx = torch.zeros((), dtype=torch.float32, device=local.device)
        for lo in range(0, n, _CHUNK_ROWS):
            mx = torch.maximum(mx, abs_max(prepared(lo)))
        scale = float(_all_reduce_max(mesh, mx) / 127.0)
    out = torch.empty(local.shape, dtype=dtype, device=local.device)
    for lo in range(0, n, _CHUNK_ROWS):
        x = prepared(lo)
        out[lo: lo + _CHUNK_ROWS] = quantize_corpus(x, scale)[0] if scale is not None \
            else x.to(dtype)
    return out, scale


@dataclass
class ShardedTuneReport:
    """What :func:`tune_sharded` learned; ``server()`` is the production
    handle pinned to the winner (the hash trials' build and pack reused,
    an exact winner built anew at its storage tier)."""

    best: Any  # engine.tuning.Trial
    trials: list
    k: int
    metric: str
    target_recall: float
    measured: bool
    batch: int
    _points: Any = field(repr=False, default=None)
    _mesh: Any = field(repr=False, default=None)
    _srv_hash: ShardedServer | None = field(repr=False, default=None)

    def server(self) -> ShardedServer:
        if self.best.engine == "exact":
            return ShardedServer.build(self._points, self.k, mesh=self._mesh, mode="exact",
                                       metric=self.metric,
                                       storage_dtype=_TIER_DTYPES[
                                           self.best.knobs.get("storage_dtype")])
        srv = self._srv_hash
        for key in ("n_probes", "window", "rerank_width"):
            v = self.best.knobs.get(key)
            if v is not None:
                srv._search_kw[key] = v
        return srv

    def as_dict(self) -> dict:
        return {"best": self.best.as_dict(), "k": self.k, "metric": self.metric,
                "target_recall": self.target_recall, "measured": self.measured,
                "batch": self.batch, "sharded": True,
                "trials": [t.as_dict() for t in self.trials]}


def tune_sharded(points, k: int, *, mesh: Mesh, queries=None, n_queries: int = 256,
                 batch: int | None = None, target_recall: float = 0.9, metric: str = "l2",
                 include_exact: bool = True, probe_grid=(None, 18), window_grid=(32, 96),
                 rerank_grid=(None, 50), exact_tiers=(None,), packed_dtype=None,
                 measure: bool | None = None, measure_all: bool = False, seed: int = 0,
                 verbose: bool = False, **build_kw) -> ShardedTuneReport:
    """The tuner over a mesh: every trial runs through
    :meth:`ShardedServer.search`, so what is measured is the sharded
    production path; recall@k is scored against ``search_exact_sharded``
    (global brute force) on every query of the sample, run in batches of
    ``batch`` rows (the JAX tuner scores only the first batch, its
    ``parallel/serving.py:502-503``).  ``measure=None`` times the trials
    on a CUDA mesh (``engine/tuning.py:_measure_qps``, fenced) and ranks
    them by the single-card tuner's candidate-rows cost proxy on a CPU
    mesh; ``measure_all`` times every trial, not only those that meet the
    target.  One hash build and one pack serve every hash trial.  The exact
    tiers are tried one at a time, each timed before the next is built and
    then freed, so at most one tier's sharded corpus is resident (the JAX
    tuner keeps them all, its ``parallel/serving.py:516-535``); a tier is
    timed even when it misses the target, since it cannot be later."""
    points = torch.as_tensor(points)
    points = points if points.dtype == torch.float32 else points.float()
    dev = mesh.device
    if queries is None:
        queries = _sample_queries(points, n_queries, seed)
    queries = torch.as_tensor(queries, device=dev).float()
    m = queries.shape[0]
    batch = m if batch is None else max(1, min(int(batch), m))
    on_card = dev.type == "cuda"
    if measure is None:
        measure = on_card
    pts_m, q_m = prepare_points(points, metric), prepare_points(queries, metric)
    true_ids = search_exact_sharded(pts_m, q_m, k, mesh=mesh)[0].cpu().numpy()
    batches = [(lo, min(lo + batch, m)) for lo in range(0, m, batch)]

    def score(run_on, qs) -> float:
        ids = [run_on(qs[lo:hi])[0].cpu().numpy() for lo, hi in batches]
        return recall_at_k(true_ids, np.concatenate(ids), k)

    trials: list = []
    runners: list = []  # (trial, a replayable first-batch call, or None once freed)

    def note(t):
        trials.append(t)
        if verbose:
            print(f"  {t.engine:6s} {t.knobs} recall={t.recall:.3f} cost={t.cost:.0f}")

    def timed(t, run):
        t.qps = _measure_qps(run, batch, dev)
        if verbose:
            print(f"  measured {t.engine} {t.knobs}: {t.qps:.0f} QPS")

    if include_exact and k <= KMAX:
        for tier in exact_tiers:
            if tier not in _TIER_DTYPES:
                raise ValueError(f"unknown exact tier {tier!r}")
            srv_e = ShardedServer.build(pts_m, k, mesh=mesh, mode="exact",
                                        storage_dtype=_TIER_DTYPES[tier])
            knobs = {} if tier is None else {"storage_dtype": tier}
            if srv_e.describe()["exact_engine"] == "twophase":
                knobs["exact_engine"] = "twophase"
            cost = float(points.shape[0]) / {None: 1, "bf16": 2, "int8": 4}[tier]
            t = Trial("exact", knobs, score(srv_e.search, q_m), cost)
            note(t)
            if measure:
                timed(t, lambda: srv_e.search(q_m[:batch]))
            runners.append((t, None))
            del srv_e  # the next tier is built only once this one is freed

    srv_h = ShardedServer.build(points, k, mesh=mesh, mode="hash", metric=metric,
                                layout="packed", window=max(window_grid),
                                packed_dtype=packed_dtype, seed=seed, **build_kw)
    sw = srv_h.spk.super_width
    path = packed_route(srv_h.sidx.n_local, batch, on_card)
    for P in probe_grid:
        p_eff = P if P is not None else srv_h.sidx.d_short + 1
        for w in window_grid:
            for rw in rerank_grid:
                def run_on(qs, P=P, w=w, rw=rw):
                    return srv_h.search(qs, n_probes=P, window=w, rerank_width=rw)

                cost = srv_h.sidx.tries * p_eff * w * sw
                cost *= 1.0 + (0.0 if rw is None else rw / (2.0 * k))
                t = Trial("packed", {"n_probes": P, "window": w, "rerank_width": rw,
                                     "path": path}, score(run_on, queries), cost)
                note(t)
                runners.append((t, lambda run_on=run_on: run_on(queries[:batch])))

    qualified = [(t, r) for t, r in runners if t.recall >= target_recall]
    if qualified:
        cands = qualified
    else:
        best = max(trials, key=lambda t: t.recall)
        cands = [(t, r) for t, r in runners if t is best]
    if measure:
        for t, run in (runners if measure_all else cands):
            if run is not None and t.qps is None:
                timed(t, run)
        best = max((t for t, _ in cands), key=lambda t: t.qps)
    else:
        best = min((t for t, _ in cands), key=lambda t: t.cost)
    return ShardedTuneReport(best=best, trials=trials, k=k, metric=metric,
                             target_recall=target_recall, measured=measure, batch=batch,
                             _points=points, _mesh=mesh, _srv_hash=srv_h)
