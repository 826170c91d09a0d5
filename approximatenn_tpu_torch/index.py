"""The ANN index structure and its packed serving view (port of
``approximatenn_tpu/index.py``).

``ANNIndex`` holds the same fields as the JAX dataclass, as tensors on one
device: ``row_means (d,)``, ``bases (tries, d_short, d)``, ``tables
(tries, 2^d_short, tmax)`` int32 with sentinel n, ``counts (tries,
2^d_short)`` int32, ``graph (n, k)`` int32, optional stored ``points`` and
the ``dead`` tombstone mask.  Its updates (``add_points``,
``remove_points``, ``with_depth``, ``drop_tables``) return new indexes.
``PackedIndex`` is the bucket-CSR view :meth:`ANNIndex.packed` makes for
``search_packed`` and ``search_packed_fused``.

``save``/``load`` write and read the JAX package's npz layout byte for
byte, including the ``<key>_dtype`` tags that carry half-precision floats
as raw uint16 words.  :meth:`ANNIndex.from_numpy` is the weight carrier: it
takes those arrays as numpy (an ``np.load`` of a JAX-saved index, or the
JAX index's leaves) and returns the port's index on the CUDA card, or on
the device the caller names (``device="cpu"`` for the CPU), as the JAX
loaders land their arrays on the accelerator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from .config import default_device, itype
from .utils.profiling import span

_HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_TORCH_NAME = {torch.bfloat16: "bfloat16", torch.float16: "float16"}


def stage_points(points, dtype=None) -> torch.Tensor:
    """Stage a corpus for :meth:`ANNIndex.packed(..., staged=True)`: (n, d)
    -> (n + 1, d) in ``dtype`` (default: the corpus's) with a +inf sentinel
    row at index n.  Use it when the raw corpus and the packed rows should
    not both stay resident: stage, free the raw corpus, then pack."""
    points = torch.as_tensor(points)
    return _storage_points(points, points.dtype if dtype is None else dtype)


def _storage_points(points: torch.Tensor, dtype) -> torch.Tensor:
    """(n, d) -> (n + 1, d) copy in the storage type with a +inf sentinel row
    at index n: a sentinel slot (id n) gathers a row whose distance to any
    query is +inf.  Rows keep width d: zero pad lanes add nothing to a
    distance, so the TPU layout's 128-lane padding is not kept."""
    n, d = points.shape
    out = torch.empty((n + 1, d), dtype=dtype, device=points.device)
    out[:n] = points
    out[n] = float("inf")
    return out


def _quantize_points(points: torch.Tensor, scale=None):
    """(n, d) float -> ((n + 1, d) int8 rows, () float32 scale): the exact
    engine's convention (:func:`~.ops.exact.quantize_corpus`, rows
    round(x / scale) clipped to [-127, 127], scale max|x| / 127 unless one
    is given) plus a zero sentinel row, which int8 cannot make +inf:
    sentinel and dead slots are masked by position instead
    (``PackedIndex.live_bound``)."""
    from .ops.exact import quantize_corpus

    q, scale = quantize_corpus(points, scale)
    out = torch.zeros((q.shape[0] + 1, q.shape[1]), dtype=torch.int8, device=q.device)
    out[:-1] = q
    return out, scale


def hash_codes(row_means, bases: torch.Tensor, points: torch.Tensor,
               chunk: int = 1 << 20) -> torch.Tensor:
    """(n, tries) int32 bucket codes of ``points`` against every table, in
    chunks of ``chunk`` rows (bounds the centred copy and the projection)."""
    from .ops.hash import query_codes

    n = points.shape[0]
    if bases.shape[1] == 0:
        return torch.zeros((n, bases.shape[0]), dtype=itype, device=points.device)
    return torch.cat([query_codes(row_means, bases, points[lo: min(lo + chunk, n)])[0]
                      for lo in range(0, n, chunk)])


def to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str | None]:
    """(numpy array, half-float tag or None): bf16/f16 travel as raw uint16
    words, because npz (and numpy) have no bfloat16."""
    t = t.detach().cpu()
    tag = _TORCH_NAME.get(t.dtype)
    if tag is not None:
        return t.view(torch.int16).numpy().view(np.uint16), tag
    return t.numpy(), None


def from_numpy(a: np.ndarray, tag: str | None = None, device=None) -> torch.Tensor:
    """Inverse of :func:`to_numpy`; also accepts ml_dtypes half arrays as
    ``np.asarray`` returns them from a JAX bf16 array."""
    a = np.asarray(a)
    if tag is None and a.dtype.itemsize == 2 and a.dtype.kind not in "iuf":
        tag = str(a.dtype)  # ml_dtypes bfloat16 and friends
        a = a.view(np.uint16)
    if tag is not None and a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16).copy()).view(_HALF[tag])
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t if device is None else t.to(device)


def _stash(arrays: dict, key: str, t: torch.Tensor) -> None:
    a, tag = to_numpy(t)
    arrays[key] = a
    if tag is not None:
        arrays[key + "_dtype"] = np.array(tag)


def _unstash(z, key: str, device):
    if key not in z:
        return None
    tk = key + "_dtype"
    return from_numpy(z[key], str(z[tk]) if tk in z else None, device)


@dataclasses.dataclass(frozen=True)
class ANNIndex:
    row_means: Any  # (d,) float
    bases: Any  # (tries, d_short, d) float
    tables: Any  # (tries, 2^d_short, tmax) int32, sentinel = n
    counts: Any  # (tries, 2^d_short) int32 true occupancy
    graph: Any  # (n, k) int32, sentinel = n
    n: int
    k: int
    d: int
    d_short: int
    tries: int
    tmax: int
    points: Any = None  # (n, d) float or None
    dead: Any = None  # (n + 1,) bool tombstones or None
    metric: str = "l2"

    @property
    def n_buckets(self) -> int:
        return 1 << self.d_short

    @property
    def device(self) -> torch.device:
        return self.bases.device

    def par_maxes(self) -> np.ndarray:
        """Per-table max occupancy, capped by the stored capacity."""
        if self.counts is None:
            raise ValueError("tables dropped (drop_tables); par_maxes needs the "
                             "build-time occupancy counts")
        return np.minimum(self.counts.max(dim=1).values.cpu().numpy(), self.tmax)

    def memory_bytes(self, ragged: bool = True) -> int:
        """Index memory; ragged=True prices the tables at the reference's
        ragged layout, False at the padded layout actually held; 0 for
        dropped tables."""
        f = self.row_means.element_size()
        base = (self.row_means.numel() * f + self.bases.numel() * f
                + self.graph.numel() * 4)
        if self.tables is None:
            tables = 0
        elif ragged:
            tables = int(self.par_maxes().sum()) * self.n_buckets * 4
        else:
            tables = self.tables.numel() * 4
        pts = 0 if self.points is None else self.points.numel() * f
        return int(base + tables + pts)

    # -- streaming updates (each returns a new index) -----------------------
    def _need_tables(self, why: str = "updates need the padded tables; keep the "
                                      "original index for add/remove") -> None:
        if self.tables is None:
            raise ValueError(f"tables dropped (drop_tables): {why}")

    def add_points(self, new_points, points=None, *,
                   repair_reverse_edges: bool = True) -> "ANNIndex":
        """Insert ``new_points`` (m, d) with ids n..n+m-1.

        The hash transforms stay frozen: new points are coded with the
        build-time bases and appended to their buckets (first free slot; a
        full bucket drops the entry for that table only, as a
        capacity-limited build does, while ``counts`` keeps the true
        occupancy).  Their graph rows are exact over the grown corpus
        (:func:`~.ops.exact.exact_search`, widened by the tombstone count so
        removed rows cannot crowd out live neighbours).
        ``repair_reverse_edges`` re-ranks every old row that a new point
        claims as a neighbour over (its edges + all new points), so old rows
        reach new points through supercharge.  Needs stored points or
        ``points``."""
        from .data.preprocess import prepare_points
        from .ops.distance import blocked_over_rows, candidate_dists, pick_block
        from .ops.exact import exact_search
        from .ops.hash import query_codes
        from .ops.topk import dedup_topk

        self._need_tables()
        if points is None:
            points = self.points
        if points is None:
            raise ValueError("add_points needs the current point matrix: pass it "
                             "or build with store_points=True")
        dev = self.device
        dtype = self.bases.dtype
        points = torch.as_tensor(points, device=dev)
        new_points = prepare_points(torch.as_tensor(new_points, device=dev).to(dtype),
                                    self.metric)
        m, d = new_points.shape
        n_old, n_new = self.n, self.n + m
        all_points = torch.cat([points.to(dtype), new_points])

        # sentinel rewrite: every n_old sentinel becomes n_new
        tables = torch.where(self.tables == n_old, n_new, self.tables)
        graph = torch.where(self.graph == n_old, n_new, self.graph)

        # bulk append per table: rank each new point within its bucket
        # (stable sort + searchsorted) and write slot counts[b] + rank;
        # slots past the capacity are dropped
        with span("add_points: bucket append", rows=m):
            codes, _ = query_codes(self.row_means, self.bases, new_points)
            counts = self.counts.clone()
            arange_m = torch.arange(m, device=dev)
            for t in range(self.tries):
                ct = codes[:, t]
                order = torch.argsort(ct, stable=True)
                sc = ct[order]
                first = torch.searchsorted(sc, sc, side="left")
                slot = counts[t, sc.long()].long() + (arange_m - first)
                keep = slot < self.tmax
                tables[t, sc[keep].long(), slot[keep]] = (n_old + order[keep]).to(itype)
                counts[t] += torch.bincount(ct.long(), minlength=self.n_buckets).to(itype)

        # exact graph rows: k + 1 (the self-match) + one per tombstone, then
        # the self-match and removed rows masked by id and the row re-sorted
        n_dead = 0 if self.dead is None else int(self.dead.sum())
        kk = min(self.k + 1 + n_dead, n_new)
        with span("add_points: exact rows", rows=m):
            gnew, gd = exact_search(all_points, new_points, kk)
        gnew, gd = gnew.to(itype), gd.float()
        own = (n_old + torch.arange(m, dtype=itype, device=dev))[:, None]
        drop = gnew == own
        if self.dead is not None:
            drop |= self.dead[gnew.clamp(0, n_old).long()] & (gnew < n_old)
        gd = torch.where(drop, float("inf"), gd)
        gnew = torch.where(drop, n_new, gnew)
        gd, perm = torch.sort(gd, dim=-1, stable=True)
        gnew = gnew.gather(-1, perm)[:, : self.k]
        if gnew.shape[1] < self.k:
            gnew = torch.cat([gnew, gnew.new_full((m, self.k - gnew.shape[1]), n_new)], 1)
        graph = torch.cat([graph, gnew])

        if repair_reverse_edges:
            with span("add_points: reverse-edge repair", rows=m):
                aff = torch.unique(gnew)
                aff = aff[aff < n_old]
                if self.dead is not None and aff.numel():
                    aff = aff[~self.dead[aff.long()]]
                if aff.numel():
                    new_ids = n_old + torch.arange(m, dtype=itype, device=dev)

                    def repair_stage(qb, curb, rr):
                        cand = torch.cat([curb, new_ids[None].expand(qb.shape[0], m)], -1)
                        dd = candidate_dists(qb, all_points, cand, exclude_self=rr)
                        return dedup_topk(cand, dd, self.k, n_new)[0]

                    block = pick_block(aff.numel(), self.k + m, d, 4)
                    rows = aff.long()
                    graph[rows] = blocked_over_rows(
                        repair_stage, aff.numel(), max(1, min(block, aff.numel())),
                        all_points[rows], graph[rows], aff)

        dead = self.dead
        if dead is not None:  # new points are live; slot n_new is the sentinel
            dead = torch.cat([dead[:n_old], torch.zeros(m + 1, dtype=torch.bool,
                                                         device=dev)])
        return dataclasses.replace(
            self, tables=tables, counts=counts, graph=graph, n=n_new,
            points=all_points if self.points is not None else None, dead=dead)

    def remove_points(self, ids) -> "ANNIndex":
        """Tombstone point ids: they leave every bucket and graph edge and
        never return, through later :meth:`packed` views and
        :meth:`add_points` graph rows too (both read ``dead``).  n and the
        live ids are unchanged.  Ids are clipped to [0, n], as in the JAX
        package."""
        self._need_tables()
        dev = self.device
        ids = torch.as_tensor(ids, device=dev).reshape(-1).long()
        dead = (torch.zeros(self.n + 1, dtype=torch.bool, device=dev)
                if self.dead is None else self.dead.clone())
        dead[ids.clamp(0, self.n)] = True
        dead[self.n] = False  # slot n is the sentinel, never dead
        tables = torch.where(dead[self.tables.long()], self.n, self.tables)
        graph = torch.where(dead[self.graph.long()], self.n, self.graph)
        # the dead points' own rows are unreachable but cleared anyway
        graph = torch.where(dead[: self.n, None], self.n, graph)
        return dataclasses.replace(self, tables=tables, graph=graph, dead=dead)

    def with_depth(self, depth: int) -> "ANNIndex":
        """A view whose bucket reads stop at ``depth`` slots (one sliced copy
        of the tables; the speed side of the capacity/recall knob)."""
        if depth >= self.tmax:
            return self
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        return dataclasses.replace(self, tables=self.tables[:, :, :depth].contiguous(),
                                   tmax=depth)

    def drop_tables(self) -> "ANNIndex":
        """The index without its padded tables, for packed-serving-only
        flows: :meth:`packed` recomputes the CSR from codes.  The copy cannot
        run ``search``, be updated or be saved."""
        return dataclasses.replace(self, tables=None, counts=None)

    def packed(self, points=None, *, window: int | None = None, super_width: int = 2,
               dtype=None, store_points: bool = True,
               staged: bool = False) -> "PackedIndex":
        """The packed serving view: each table's point vectors stored
        contiguously by bucket (CSR, exactly n slots per table, no capacity
        padding, no overflow drops), one point per row.

        ``window``: per-probe read depth in slots (default ``tmax``).
        ``super_width``: the plain path's read granularity (a probe reads
        whole ``super_width``-slot groups).  ``dtype``: storage type of the
        rows (default the points'); torch.bfloat16/float16 halve them;
        torch.int8 quantizes symmetrically (scale = max|x| / 127, kept on
        the view; pair it with ``rerank_width`` and a float corpus).
        ``store_points`` keeps the corpus on the view for supercharge.
        ``staged``: ``points`` is a :func:`stage_points` buffer ((n + 1, d)
        in the storage type, +inf sentinel row), which is then kept as the
        view's corpus.  Hash codes are recomputed from the stored bases.

        Removed points (``dead``) get a past-the-end bucket code, so the
        stable sort puts them after every live slot: positions >= ``n_live``
        are sentinels, masked by position before any per-table top-k.  Each
        table holds ``n_pad`` slots, n + 1 rounded up to lcm(super_width,
        8), or lcm(super_width, 32) for int8: the probe reads round window
        starts down to that alignment, so it decides which slots are
        candidates, as in the JAX package."""
        from .ops.buckets import pack_tables

        if points is None:
            points = self.points
        if points is None:
            raise ValueError("packed() needs the build-time points: pass them or "
                             "build with store_points=True")
        points = torch.as_tensor(points, device=self.device)
        window = max(1, int(self.tmax if window is None else window))
        w = max(1, int(super_width))
        d = self.d
        quantize = dtype == torch.int8
        if staged:
            if points.dtype == torch.int8:
                raise ValueError("staged int8 buffers cannot be re-packed (hash codes "
                                 "need the float values); stage to bf16/f32 and pass "
                                 "dtype=torch.int8")
            dtype = torch.int8 if quantize else points.dtype
            n = points.shape[0] - 1
        else:
            dtype = points.dtype if dtype is None else dtype
            n = points.shape[0]
        align = math.lcm(w, 32 if quantize else 8)
        n_pad = -(-(n + 1) // align) * align

        codes = hash_codes(self.row_means, self.bases, points[:n])
        n_live = n
        if self.dead is not None:
            dead_rows = self.dead[:n]
            n_live = n - int(dead_rows.sum())
            codes = torch.where(dead_rows[:, None], self.n_buckets, codes)
        order, starts = pack_tables(codes.T.contiguous(), self.n_buckets)
        del codes
        ids = torch.cat([order, order.new_full((self.tries, n_pad - n), n)], dim=1)
        if self.dead is not None:
            ids = torch.where(self.dead[ids.clamp(0, n).long()], n, ids)

        scale = None
        if quantize:
            pts_s, scale = _quantize_points(points[:-1] if staged else points)
        else:
            pts_s = points if staged else _storage_points(points, dtype)
        # one table's gather at a time: the transient is a table, not all
        rows = torch.empty((self.tries * n_pad, d), dtype=pts_s.dtype, device=self.device)
        for t in range(self.tries):
            rows[t * n_pad: (t + 1) * n_pad] = pts_s[ids[t].clamp(max=n).long()]
        del pts_s
        return PackedIndex(
            row_means=self.row_means, bases=self.bases, point_rows=rows, ids=ids,
            starts=starts, graph=self.graph, points=points if store_points else None,
            scale=scale, n=n, k=self.k, d=d, d_short=self.d_short, tries=self.tries,
            window=window, super_width=w, metric=self.metric, n_live=n_live)

    # -- persistence -----------------------------------------------------------
    def to_numpy_dict(self) -> dict:
        """The index as the JAX package's npz arrays."""
        if self.tables is None:
            raise ValueError("tables dropped (drop_tables); a serving-only index is "
                             "not saveable: save before dropping")
        arrays = dict(
            tables=self.tables.cpu().numpy(),
            counts=self.counts.cpu().numpy(),
            graph=self.graph.cpu().numpy(),
            meta=np.array([self.n, self.k, self.d, self.d_short, self.tries,
                           self.tmax]),
            metric=np.array(self.metric),
        )
        _stash(arrays, "row_means", self.row_means)
        _stash(arrays, "bases", self.bases)
        if self.points is not None:
            _stash(arrays, "points", self.points)
        if self.dead is not None:
            arrays["dead"] = self.dead.cpu().numpy()
        return arrays

    def save(self, path: str) -> None:
        np.savez_compressed(path, **self.to_numpy_dict())

    @classmethod
    def from_numpy(cls, arrays, device=None) -> "ANNIndex":
        """Build the port's index from the JAX index's arrays (the npz keys:
        tables, counts, graph, meta, metric, row_means, bases, optional
        points and dead, with ``<key>_dtype`` tags for half floats) on
        ``device``: the CUDA card by default, raising without one unless
        ``device="cpu"`` is given (:func:`config.default_device`)."""
        device = default_device(None, device)
        n, k, d, d_short, tries, tmax = (int(v) for v in arrays["meta"])
        return cls(
            row_means=_unstash(arrays, "row_means", device),
            bases=_unstash(arrays, "bases", device),
            tables=from_numpy(arrays["tables"], device=device),
            counts=from_numpy(arrays["counts"], device=device),
            graph=from_numpy(arrays["graph"], device=device),
            n=n, k=k, d=d, d_short=d_short, tries=tries, tmax=tmax,
            points=_unstash(arrays, "points", device),
            dead=from_numpy(arrays["dead"], device=device) if "dead" in arrays else None,
            metric=str(arrays["metric"]) if "metric" in arrays else "l2",
        )

    @classmethod
    def load(cls, path: str, device=None) -> "ANNIndex":
        """Read an npz index onto ``device`` (see :meth:`from_numpy`: the
        card by default)."""
        with np.load(path) as z:
            return cls.from_numpy(z, device)


@dataclasses.dataclass(frozen=True)
class PackedIndex:
    """The packed serving view of an :class:`ANNIndex` (see
    :meth:`ANNIndex.packed`).

    ``point_rows (tries * n_pad, d)``: every table's point vectors in
    bucket-CSR order, one point per row, table t at rows ``[t * n_pad, (t +
    1) * n_pad)``.  Scoring dedups by packed position, and real ids are
    looked up only for the per-table winners through ``ids (tries, n_pad)``
    int32 (sentinel n in the tail).  ``starts (tries, 2^d_short)``: each
    bucket's first slot.  ``row_means``, ``bases``, ``graph`` and the
    optional corpus ``points`` serve the query side and supercharge.
    ``scale``: the int8 tier's () float32 step (distances in the quantized
    domain times scale^2 are true distances), None for float rows.
    """

    row_means: Any
    bases: Any  # (tries, d_short, d)
    point_rows: Any  # (tries * n_pad, d)
    ids: Any  # (tries, n_pad) int32, sentinel n past the slots
    starts: Any  # (tries, 2^d_short) int32
    graph: Any  # (n, k) int32
    points: Any  # (n, d), a (n + 1, d) staged buffer, or None
    n: int
    k: int
    d: int
    d_short: int
    tries: int
    window: int
    super_width: int
    metric: str = "l2"
    # live (not removed) points: packed() moves dead slots to each table's
    # tail, so positions >= n_live are sentinels.  0 = none removed
    n_live: int = 0
    scale: Any = None

    @property
    def live_bound(self) -> int:
        """Positions >= this are sentinel slots (tail padding and relocated
        tombstones)."""
        return self.n_live or self.n

    @property
    def n_buckets(self) -> int:
        return 1 << self.d_short

    @property
    def device(self) -> torch.device:
        return self.point_rows.device

    @property
    def n_pad(self) -> int:
        """Slots per table (n + 1 rounded up to the alignment)."""
        return self.point_rows.shape[0] // self.tries

    @property
    def n_rows(self) -> int:
        """``super_width``-slot groups per table (the plain path's reads)."""
        return self.n_pad // self.super_width

    def rows_per_probe(self, window: int | None = None) -> int:
        """Groups covering ``[start, start + window)`` for any start:
        ceil(window / super_width) + 1."""
        window = self.window if window is None else window
        return min(-(-window // self.super_width) + 1, self.n_rows)

    def with_window(self, window: int) -> "PackedIndex":
        """The same view with another per-probe read depth (free)."""
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        return dataclasses.replace(self, window=window)

    def memory_bytes(self) -> int:
        f = self.row_means.element_size()
        base = (self.row_means.numel() * f + self.bases.numel() * f
                + self.graph.numel() * 4)
        packed = (self.point_rows.numel() * self.point_rows.element_size()
                  + self.ids.numel() * 4 + self.starts.numel() * 4)
        pts = 0 if self.points is None else self.points.numel() * f
        return int(base + packed + pts)

    # -- persistence -----------------------------------------------------------
    def to_numpy_dict(self) -> dict:
        """The view as the JAX package's npz arrays.  ``d_pad`` is written
        as 0, which the JAX loader reads as "rows are d wide"; half-float
        rows travel as uint16 words with the ``row_dtype`` tag."""
        rows, tag = to_numpy(self.point_rows)
        arrays = dict(
            point_rows=rows,
            row_dtype=np.array(tag or str(rows.dtype)),
            ids=self.ids.cpu().numpy(),
            starts=self.starts.cpu().numpy(),
            graph=self.graph.cpu().numpy(),
            meta=np.array([self.n, self.k, self.d, self.d_short, self.tries,
                           self.window, self.super_width, 0, self.n_live]),
            metric=np.array(self.metric),
        )
        _stash(arrays, "row_means", self.row_means)
        _stash(arrays, "bases", self.bases)
        if self.points is not None:
            _stash(arrays, "points", self.points)
        if self.scale is not None:
            arrays["scale"] = np.asarray(self.scale.cpu().numpy(), np.float32)
        return arrays

    def save(self, path: str) -> None:
        np.savez_compressed(path, **self.to_numpy_dict())

    @classmethod
    def from_numpy(cls, arrays, device=None) -> "PackedIndex":
        """The port's view from a JAX packed view's arrays (the npz keys, or
        the same built from its leaves) on ``device``, placed as
        :meth:`ANNIndex.from_numpy` places an index (the card by default).
        The TPU layout's pad lanes (rows and a staged corpus wider than d)
        are sliced off."""
        device = default_device(None, device)
        meta = [int(v) for v in arrays["meta"]]
        if len(meta) == 8:  # views saved before n_live existed
            meta.append(0)
        n, k, d, d_short, tries, window, w, _, n_live = meta
        rows = np.asarray(arrays["point_rows"])
        row_dt = str(arrays["row_dtype"])
        tag = row_dt if row_dt in _HALF and rows.dtype == np.uint16 else None
        point_rows = from_numpy(rows, tag, device)[:, :d].contiguous()
        points = _unstash(arrays, "points", device)
        if points is not None and points.shape[1] != d:
            points = points[:, :d].contiguous()
        scale = None
        if "scale" in arrays:
            scale = torch.tensor(np.asarray(arrays["scale"], np.float32), device=device)
        return cls(
            row_means=_unstash(arrays, "row_means", device),
            bases=_unstash(arrays, "bases", device),
            point_rows=point_rows,
            ids=from_numpy(arrays["ids"], device=device),
            starts=from_numpy(arrays["starts"], device=device),
            graph=from_numpy(arrays["graph"], device=device),
            points=points, scale=scale, n=n, k=k, d=d, d_short=d_short, tries=tries,
            window=window, super_width=w,
            metric=str(arrays["metric"]) if "metric" in arrays else "l2",
            n_live=n_live,
        )

    @classmethod
    def load(cls, path: str, device=None) -> "PackedIndex":
        """Read an npz view onto ``device`` (see :meth:`from_numpy`)."""
        with np.load(path) as z:
            return cls.from_numpy(z, device)
