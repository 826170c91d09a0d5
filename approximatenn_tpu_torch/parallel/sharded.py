"""Distributed index build and query (port of
``approximatenn_tpu/parallel/sharded.py``) on ``torch.distributed``.

SPMD, one process (rank) a shard: every rank calls the same function with
the same global arguments, keeps its own rows of the corpus and returns
the merged result, the same on every rank (the JAX package's replicated
``out_specs=P()``).  The corpus is zero-padded to ``n_local * S`` rows and
rank r holds rows ``[r * n_local, (r + 1) * n_local)``; its bucket tables
and kNN graph hold local ids with sentinel ``n_local``, and the row means
and hash bases are replicated.  Queries are replicated: each rank searches
its sub-index with the single-card pipeline, maps local ids to global ones
(offset ``r * n_local``; sentinels and pad rows become ``(n, +inf)``), and
one all-gather of the per-rank top-k and a top-k over the gathered lists,
concatenated in rank order so that ties go to the lower shard, merge them.
Every point lives on one rank, so the merge needs no dedup.

The collectives that XLA inserts implicitly in the JAX package are explicit
here, in three helpers (``_all_gather_stacked``, ``_all_reduce_sum``,
``_all_reduce_max``): the global mean, the global bucket capacity (the max
and mean over every rank's counts, so every rank's tables have one width)
and the int8 packed tier's one scale.  Under gloo, whose all-gather takes
CPU tensors only, a card tensor is staged through host memory for the
collective (``Mesh.host_staged``); the compute stays on the card.

The kernels are reached through the single-card entry points, nothing
added to them: the exact graph per shard through
``engine/build.py:exact_graph_chunked`` (rank kernel), ``search_exact_sharded``
through ``exact_search`` (rank kernel) or ``exact_knn_twophase`` (emit and
rescan), the fused packed search through ``search_packed_fused_impl``
(probe kernel).  A CPU mesh runs their plain versions.  The JAX package's
host-chunked drivers (``chunked=``) work around a TPU runtime limit: the
switch is accepted and there is one loop here.  Its TPU kernel knobs
(``query_block``, ``interpret``) raise ``ValueError``, and the packed rows
keep width d (no 128-lane padding).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .. import config
from ..config import itype
from ..index import ANNIndex, PackedIndex, _stash, _storage_points, _unstash, from_numpy
from ..ops.topk import topk_no_dedup
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The shards: one rank of a process group each, all on ``device``
    (this rank's card, or the CPU)."""

    group: Any  # the process group (None: the default group)
    rank: int
    size: int
    device: torch.device

    @property
    def host_staged(self) -> bool:
        """Whether collectives of this mesh's tensors go through host memory:
        card tensors under gloo, whose all-gather takes CPU tensors only."""
        return self.device.type == "cuda" and dist.get_backend(self.group) == "gloo"


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh of the initialized default process group, one shard a rank.
    ``n_devices`` is None or the world size.  ``device`` defaults to card
    ``rank % device_count``; ``"cpu"`` is the caller asking for the CPU,
    and without a card and without that request this raises."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call parallel.multihost.initialize() "
                           "on every rank before make_mesh")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices}: the mesh is the whole process group "
                         f"of {size} ranks, one shard a rank")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: pass device='cpu' to shard on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(group=None, rank=rank, size=size, device=torch.device(device))


# -- the collectives (every rank calls each one, in the same order) ----------

def _all_gather_stacked(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (same shape and type on all), stacked in rank
    order: (S, *t.shape) on ``t``'s device.  One flat buffer, gathered in
    place (host memory when ``mesh.host_staged``)."""
    src = t.detach().reshape(-1)
    if mesh.host_staged:
        src = src.cpu()
    out = src.new_empty(mesh.size * src.numel())
    dist.all_gather_into_tensor(out, src.contiguous(), group=mesh.group)
    return out.view(mesh.size, *t.shape).to(t.device)


def _gather_stacked(mesh: Mesh, t: torch.Tensor, rank0_only: bool = False):
    """Every rank's ``t`` (same shape and type on all) stacked in rank
    order, on the host; gathered as bytes, so that any type travels.
    ``rank0_only``: rank 0 alone gets them (None on the others), each rank
    sending its shard and rank 0 taking one at a time, so that its device
    holds one more shard and the other ranks nothing more (a save)."""
    t = t.detach().contiguous()
    if mesh.size == 1:
        return t[None].cpu()
    raw = t.reshape(-1).view(torch.uint8)
    if not rank0_only:
        out = _all_gather_stacked(mesh, raw).cpu()
    else:
        if mesh.host_staged:
            raw = raw.cpu()

        def peer(r):  # send/recv take global ranks
            return r if mesh.group is None else dist.get_global_rank(mesh.group, r)

        if mesh.rank != 0:
            dist.send(raw, dst=peer(0), group=mesh.group)
            return None
        out = torch.empty((mesh.size, raw.numel()), dtype=torch.uint8)
        out[0] = raw.cpu()
        buf = torch.empty_like(raw)
        for r in range(1, mesh.size):
            dist.recv(buf, src=peer(r), group=mesh.group)
            out[r] = buf.cpu()
    return out.view(t.dtype).view(mesh.size, *t.shape)


def _all_reduce(mesh: Mesh, t: torch.Tensor, op) -> torch.Tensor:
    """The reduction of every rank's ``t``, in a copy (host memory when
    ``mesh.host_staged``) so that ``t`` is left as it was."""
    buf = t.detach().to("cpu" if mesh.host_staged else t.device, copy=True).contiguous()
    dist.all_reduce(buf, op=op, group=mesh.group)
    return buf.to(t.device)


def _all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return _all_reduce(mesh, t, dist.ReduceOp.SUM)


def _all_reduce_max(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return _all_reduce(mesh, t, dist.ReduceOp.MAX)


@dataclasses.dataclass(frozen=True)
class LocalRows:
    """This rank's rows of a row-sharded global corpus, as
    :func:`~.multihost.process_local_array` makes them: ``data`` holds rows
    ``[rank * n / S, (rank + 1) * n / S)`` of the global ``shape`` (n, d),
    which must be pre-padded to a multiple of the shard count."""

    data: Any  # (n / S, d) tensor
    shape: tuple

    @property
    def dtype(self):
        return self.data.dtype


@dataclasses.dataclass(frozen=True)
class ShardedIndex:
    """One rank's shard of a row-sharded index.

    ``tables (tries, 2^d_short, tmax)``, ``counts (tries, 2^d_short)`` and
    ``graph (n_local, k)`` cover this rank's slice in local ids (sentinel
    ``n_local``); ``row_means`` and ``bases`` are replicated.  ``n`` is the
    TRUE corpus size: ``n_local * n_shards`` may exceed it by up to
    ``n_shards - 1`` zero pad rows, which every search masks.  ``points``
    is this rank's metric-prepared slice when stored."""

    row_means: Any  # (d,)
    bases: Any  # (tries, d_short, d)
    tables: Any  # (tries, 2^d_short, tmax) int32 local ids
    counts: Any  # (tries, 2^d_short) int32
    graph: Any  # (n_local, k) int32 local ids
    n: int
    n_local: int
    k: int
    d: int
    d_short: int
    tries: int
    tmax: int
    n_shards: int
    rank: int
    points: Any = None  # (n_local, d), metric-prepared
    metric: str = "l2"

    def local_index(self) -> ANNIndex:
        """This rank's shard as a standalone single-card index over its slice."""
        return ANNIndex(row_means=self.row_means, bases=self.bases, tables=self.tables,
                        counts=self.counts, graph=self.graph, n=self.n_local, k=self.k,
                        d=self.d, d_short=self.d_short, tries=self.tries, tmax=self.tmax)

    @property
    def n_padded(self) -> int:
        return self.n_local * self.n_shards

    def to_numpy(self, mesh: Mesh | None = None, rank0_only: bool = False) -> dict | None:
        """The whole index as the JAX ``ShardedIndex``'s stacked arrays:
        ``tables (S, tries, 2^d_short, tmax)``, ``counts``, ``graph (S,
        n_local, k)``, ``points (S * n_local, d)`` when stored, the
        replicated ``row_means`` and ``bases``, ``meta`` = [n, n_local, k,
        d, d_short, tries, tmax, n_shards] and ``metric``.  A collective
        past one shard: every rank calls it with the index's ``mesh``.
        ``rank0_only``: rank 0 alone gathers them, the other ranks get
        None (:func:`_gather_stacked`)."""
        if mesh is None and self.n_shards > 1:
            raise ValueError("to_numpy of a sharded index gathers every rank's shard: "
                             "pass the mesh, on every rank")
        fields = ("tables", "counts", "graph") + (("points",) if self.points is not None else ())
        parts = {f: getattr(self, f).detach()[None].cpu() if self.n_shards == 1
                 else _gather_stacked(mesh, getattr(self, f), rank0_only) for f in fields}
        if parts["tables"] is None:
            return None
        arrays = dict(
            tables=parts["tables"].numpy(),
            counts=parts["counts"].numpy(),
            graph=parts["graph"].numpy(),
            meta=np.array([self.n, self.n_local, self.k, self.d, self.d_short, self.tries,
                           self.tmax, self.n_shards]),
            metric=np.array(self.metric),
        )
        _stash(arrays, "row_means", self.row_means)
        _stash(arrays, "bases", self.bases)
        if self.points is not None:
            _stash(arrays, "points", parts["points"].reshape(-1, self.d))
        return arrays

    @classmethod
    def from_numpy(cls, arrays, mesh: Mesh) -> "ShardedIndex":
        """This rank's shard of a stacked index (the keys of
        :meth:`to_numpy`; a JAX ``ShardedIndex``'s leaves as numpy carry
        across the same way) on ``mesh.device``.  The shard count must be
        the mesh's."""
        n, n_local, k, d, d_short, tries, tmax, s = (int(v) for v in arrays["meta"])
        if s != mesh.size:
            raise ValueError(f"mesh has {mesh.size} shards but the index was built "
                             f"with {s}")
        r, dev = mesh.rank, mesh.device
        points = _unstash(arrays, "points", None)
        if points is not None:
            points = points[r * n_local: (r + 1) * n_local].to(dev)
        return cls(
            row_means=_unstash(arrays, "row_means", dev), bases=_unstash(arrays, "bases", dev),
            tables=from_numpy(np.asarray(arrays["tables"])[r], device=dev),
            counts=from_numpy(np.asarray(arrays["counts"])[r], device=dev),
            graph=from_numpy(np.asarray(arrays["graph"])[r], device=dev),
            n=n, n_local=n_local, k=k, d=d, d_short=d_short, tries=tries, tmax=tmax,
            n_shards=s, rank=r, points=points,
            metric=str(arrays["metric"]) if "metric" in arrays else "l2",
        )


def _shard_points(points, mesh: Mesh, n_local: int | None = None, dtype=None) -> torch.Tensor:
    """This rank's rows of ``points`` on ``mesh.device`` (in ``dtype`` when
    given): the corpus zero-padded to a multiple of the shard count (to
    ``n_local * S`` when the index's ``n_local`` is given, so a search-time
    corpus matches the build layout).  Only this rank's rows are moved.  A
    :class:`LocalRows` corpus is this rank's rows already."""
    s = mesh.size
    if isinstance(points, LocalRows):
        n = points.shape[0]
        if n % s:
            raise ValueError(f"multi-host corpus n={n} must be pre-padded to the shard "
                             f"count {s} (see multihost.process_local_array)")
        if n_local is not None and n != n_local * s:
            raise ValueError(f"corpus has {n} rows but the index was built over "
                             f"{n_local * s}")
        local = torch.as_tensor(points.data, device=mesh.device)
        return local if dtype is None else local.to(dtype)
    n = points.shape[0]
    n_pad = -(-n // s) * s if n_local is None else n_local * s
    if n_pad < n:
        raise ValueError(f"corpus has {n} rows but the index was built over {n_pad}")
    per = n_pad // s
    lo = mesh.rank * per
    local = torch.as_tensor(points[min(lo, n): min(lo + per, n)], device=mesh.device)
    if dtype is not None:
        local = local.to(dtype)
    if local.shape[0] < per:
        pad = local.new_zeros((per - local.shape[0], points.shape[1]))
        local = torch.cat([local, pad])
    return local.contiguous()


def _global_capacity(mesh: Mesh, counts: torch.Tensor, capacity) -> int:
    """``engine/build.py:resolve_capacity`` over every rank's counts: the
    max and the mean come from all ranks, so every shard's tables have one
    width."""
    if isinstance(capacity, str):
        if capacity != "auto":
            raise ValueError(f"capacity must be an int, None, or 'auto'; got {capacity!r}")
        mx = int(_all_reduce_max(mesh, counts.max().to(torch.int64)))
        total = int(_all_reduce_sum(mesh, counts.sum(dtype=torch.int64)))
        cap = max(32.0 * total / (counts.numel() * mesh.size), 8.0)
        return max(1, int(min(mx, math.ceil(cap))))
    if capacity is None:
        return max(1, int(_all_reduce_max(mesh, counts.max().to(torch.int64))))
    return max(1, int(capacity))


def _mask_pad_locals(tables, graph, *, rank: int, n: int, n_local: int):
    """Zero pad rows out of every candidate source: local ids past the
    shard's true row count become the local sentinel in the tables and the
    graph, so a pad row (the zero vector, near the data of a centred
    corpus) cannot take a top-k slot or re-enter through supercharge."""
    valid = min(max(n - rank * n_local, 0), n_local)
    return (torch.where(tables >= valid, n_local, tables),
            torch.where(graph >= valid, n_local, graph))


def build_sharded(
    points,
    k: int,
    *,
    mesh: Mesh,
    tries: int = 10,
    rots_before: int = 6,
    rot_len_before: int = 1,
    rots_after: int = 1,
    rot_len_after: int = 1,
    generator: torch.Generator | None = None,
    seed: int = 0,
    dtype=None,
    capacity=None,
    budget_bytes: int = 128 << 20,
    metric: str = "l2",
    n_probes: int | None = None,
    store_points: bool | None = None,
    graph_mode: str = "auto",
    graph_precision: str = "highest",
    chunked: bool | None = None,
    chunk_rows: int | None = None,
    progress=None,
    bases=None,
) -> ShardedIndex:
    """Distributed index build: this rank's shard of the index over the
    global ``points`` (n, d), or over a :class:`LocalRows` corpus.

    The options are the single-card ``build``'s; ``generator`` (a CPU
    ``torch.Generator``, default seeded with ``seed``) draws the same
    transforms on every rank, and ``bases`` (tries, d_short, d) replaces
    the draw.  ``d_short`` follows the slice size ``n_local``.  The mean is
    global: every rank's mean weighted by its share of the true n (pad rows
    are zero), so one shard gives the single-card mean bit for bit.
    ``capacity`` is resolved over every rank's counts.  ``graph_mode``
    "exact" is each shard's true local kNN graph (the rank kernel with
    ``exclude`` = own rows, ``chunk_rows`` queries a launch), "hash" the
    reference's multiprobe graph, "auto" exact for n_local <= 16M and k <=
    128.  ``chunked`` is accepted and changes nothing (one loop here)."""
    from ..data.preprocess import METRICS, prepare_points
    from ..engine.build import exact_graph_chunked, graph_stage, hash_stage
    from ..ops.buckets import build_tables
    from ..ops.distance import pick_block
    from ..ops.transforms import derive_dims

    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; want one of {METRICS}")
    if graph_mode not in ("auto", "exact", "hash"):
        raise ValueError(f"unknown graph_mode {graph_mode!r}")
    n, d = points.shape
    if n >= 2**31:
        raise ValueError("n must fit in int32")
    dtype = dtype or config.ftype()
    # angular: unit rows (zero pad rows stay zero: normalize's eps guard)
    local = prepare_points(_shard_points(points, mesh, dtype=dtype), metric)
    if store_points is None:
        store_points = metric != "l2"
    n_local = local.shape[0]
    d_short, _ = derive_dims(n_local, k, d)
    if d_short > 28:
        raise ValueError(f"d_short={d_short} too large (bucket table 2^{d_short})")
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    if bases is not None:
        bases = torch.as_tensor(bases, device=mesh.device).to(dtype)
    row_means = _all_reduce_sum(mesh, local.mean(0) * (n_local / n))
    row_means, bases, codes, counts = hash_stage(
        local, generator, d_short=d_short, tries=tries, rb=rots_before, rlb=rot_len_before,
        ra=rots_after, rla=rot_len_after, dtype=dtype, bases=bases, row_means=row_means)
    tmax = _global_capacity(mesh, counts, capacity)
    n_per_probe = d_short + 1 if n_probes is None else n_probes
    block_rows = pick_block(n_local, n_per_probe * tmax, d, local.element_size(), budget_bytes)
    if graph_mode == "auto":
        graph_mode = "exact" if (n_local <= (1 << 24) and k <= 128) else "hash"
    if graph_mode == "exact":
        tables = build_tables(codes, 1 << d_short, tmax, n_local)
        chunk = {} if chunk_rows is None else {"chunk_q": chunk_rows}
        graph, _ = exact_graph_chunked(local, k, progress=progress,
                                       matmul_precision=graph_precision, **chunk)
        graph = graph.to(itype)
    else:
        tables, graph, _ = graph_stage(local, codes, counts, k=k, d_short=d_short, tmax=tmax,
                                       block_rows=block_rows, n_probes=n_probes,
                                       row_means=row_means, bases=bases)
    del codes
    if n_local * mesh.size != n:
        tables, graph = _mask_pad_locals(tables, graph, rank=mesh.rank, n=n, n_local=n_local)
    return ShardedIndex(
        row_means=row_means, bases=bases, tables=tables, counts=counts, graph=graph, n=n,
        n_local=n_local, k=k, d=d, d_short=d_short, tries=tries, tmax=tmax,
        n_shards=mesh.size, rank=mesh.rank, points=local if store_points else None,
        metric=metric)


def _to_global(ids_l, dists, n_local: int, n: int, offset: int):
    """Local ids -> global ids: the local sentinel and zero pad rows
    (global id >= the true n) become the global sentinel n at +inf."""
    g = ids_l.long() + offset
    valid = (ids_l < n_local) & (g < n)
    return (torch.where(valid, g, n).to(itype),
            torch.where(valid, dists, torch.full_like(dists, float("inf"))))


def _merge(mesh: Mesh, ids_l, dists, n_local: int, n: int, k: int):
    """Every rank's local top lists -> the global top-k, on every rank:
    global ids, one all-gather of the distances and ids side by side (the
    distances' bits viewed as an integer type of their width, at least 32
    bits), the lists in rank order ((m, S * width), as the JAX ``moveaxis``
    + ``reshape``), top-k.  Ties go to the lower shard.  The span
    ``sharded.merge``."""
    with span("sharded.merge", rows=int(ids_l.shape[0])):
        gids, dd = _to_global(ids_l, dists, n_local, n, mesh.rank * n_local)
        m = gids.shape[0]
        wide = dd if dd.element_size() >= 4 else dd.float()
        bits = {4: torch.int32, 8: torch.int64}[wide.element_size()]
        both = torch.stack([wide.contiguous().view(bits), gids.to(bits)], dim=-1)
        both = _all_gather_stacked(mesh, both).transpose(0, 1).reshape(m, -1, 2)
        all_dd = both[..., 0].contiguous().view(wide.dtype).to(dd.dtype)
        return topk_no_dedup(all_dd, both[..., 1].to(gids.dtype), k)


def _resolve_corpus(sidx: ShardedIndex, points, mesh: Mesh) -> torch.Tensor:
    """This rank's search-time corpus: the stored slice when ``points`` is
    None, else the caller's corpus sharded to the build layout, in the
    index dtype, normalized for angular."""
    if points is None:
        if sidx.points is None:
            raise ValueError("index does not store points; pass the build-time point "
                             "matrix or build with store_points=True")
        return sidx.points
    from ..data.preprocess import prepare_points

    local = _shard_points(points, mesh, n_local=sidx.n_local, dtype=sidx.bases.dtype)
    return prepare_points(local, sidx.metric)


def _prep_queries(sidx: ShardedIndex, queries, mesh: Mesh) -> torch.Tensor:
    from ..data.preprocess import prepare_points

    return prepare_points(torch.as_tensor(queries, device=mesh.device).to(sidx.bases.dtype),
                          sidx.metric)


def search_sharded(sidx: ShardedIndex, points=None, queries=None, *, mesh: Mesh,
                   budget_bytes: int = 128 << 20, block_rows: int | None = None,
                   n_probes: int | None = None, supercharge_rounds: int = 1,
                   rerank_width: int | None = None, chunked: bool | None = None):
    """Distributed batch query over the padded tables: every rank searches
    its shard (``engine/search.py:search_impl``), then the all-gather
    merge.  Returns (global ids (m, k) int32, sentinel n; squared
    distances), the same on every rank.  ``points=None`` (or the short form
    ``search_sharded(sidx, queries, mesh=...)``) uses the stored corpus.
    Knobs as the single-card ``search``; ``chunked`` is accepted and
    changes nothing."""
    from ..engine.search import search_impl
    from ..ops.distance import pick_block

    if queries is None:
        points, queries = None, points
    queries = _prep_queries(sidx, queries, mesh)
    m = queries.shape[0]
    if block_rows is None:
        nprb = sidx.d_short + 1 if n_probes is None else n_probes
        block_rows = pick_block(m, sidx.tries * nprb * sidx.tmax, sidx.d,
                                sidx.bases.element_size(), budget_bytes)
    corpus = _resolve_corpus(sidx, points, mesh)
    ids_l, dd = search_impl(sidx.local_index(), corpus, queries, max(1, block_rows), n_probes,
                            supercharge_rounds=supercharge_rounds, rerank_width=rerank_width)
    return _merge(mesh, ids_l, dd, sidx.n_local, sidx.n, sidx.k)


@dataclasses.dataclass(frozen=True)
class ShardedPacked:
    """One rank's packed (bucket-CSR) serving view, the layout of the
    single-card :class:`~..index.PackedIndex` over this rank's slice:
    ``point_rows (tries * n_pad_l, d)`` one point a row, ``ids (tries,
    n_pad_l)`` local ids (sentinel ``n_local``), ``starts (tries,
    2^d_short)``.  The int8 tier's ``scale`` is one for every shard, so
    quantized distances compare across shards."""

    point_rows: Any
    ids: Any
    starts: Any
    scale: Any = None  # () float32, replicated
    n_pad_l: int = 0
    window: int = 0
    super_width: int = 1

    def memory_bytes(self) -> int:
        return int(self.point_rows.numel() * self.point_rows.element_size()
                   + self.ids.numel() * 4 + self.starts.numel() * 4)

    def local_view(self, sidx: ShardedIndex) -> PackedIndex:
        """This rank's view as a single-card packed index over its slice."""
        return PackedIndex(
            row_means=sidx.row_means, bases=sidx.bases, point_rows=self.point_rows,
            ids=self.ids, starts=self.starts, graph=sidx.graph, points=None,
            scale=self.scale, n=sidx.n_local, k=sidx.k, d=sidx.d, d_short=sidx.d_short,
            tries=sidx.tries, window=self.window, super_width=self.super_width,
            metric=sidx.metric)


def packed_sharded(sidx: ShardedIndex, points=None, *, mesh: Mesh, window: int | None = None,
                   super_width: int = 2, dtype=None) -> ShardedPacked:
    """Every rank packs its slice into bucket-CSR order (exactly n_local
    slots a table, no capacity padding, no overflow drops), as
    :meth:`~..index.ANNIndex.packed` does on one card.  Pad rows' slots
    read the sentinel row.  ``dtype=torch.int8`` quantizes with ONE scale,
    max|x| / 127 over the whole corpus (an all-reduce MAX), with the zero
    sentinel row of the single-card tier.  ``window`` defaults to
    ``tmax``."""
    from ..index import _quantize_points, hash_codes
    from ..ops.buckets import pack_tables
    from ..ops.exact import abs_max

    w = max(1, int(super_width))
    n_local, tries = sidx.n_local, sidx.tries
    dtype = sidx.bases.dtype if dtype is None else dtype
    quantize = dtype == torch.int8
    align = math.lcm(w, 32 if quantize else 8)
    n_pad_l = -(-(n_local + 1) // align) * align
    local = _resolve_corpus(sidx, points, mesh)
    codes = hash_codes(sidx.row_means, sidx.bases, local)
    order, starts = pack_tables(codes.T.contiguous(), 1 << sidx.d_short)
    del codes
    ids = torch.cat([order, order.new_full((tries, n_pad_l - n_local), n_local)], dim=1)
    if sidx.n_padded != sidx.n:
        valid = min(max(sidx.n - mesh.rank * n_local, 0), n_local)
        ids = torch.where(ids >= valid, n_local, ids)
    scale = None
    if quantize:
        scale = _all_reduce_max(mesh, abs_max(local)) / 127.0
        pts_s, scale = _quantize_points(local, scale)
    else:
        pts_s = _storage_points(local, dtype)
    rows = torch.empty((tries * n_pad_l, sidx.d), dtype=pts_s.dtype, device=local.device)
    for t in range(tries):
        rows[t * n_pad_l: (t + 1) * n_pad_l] = pts_s[ids[t].clamp(max=n_local).long()]
    return ShardedPacked(point_rows=rows, ids=ids, starts=starts, scale=scale,
                         n_pad_l=n_pad_l, window=int(window) if window else sidx.tmax,
                         super_width=w)


def search_packed_sharded(sidx: ShardedIndex, spk: ShardedPacked, points=None, queries=None,
                          *, mesh: Mesh, budget_bytes: int = 128 << 20,
                          block_rows: int | None = None, n_probes: int | None = None,
                          supercharge_rounds: int = 1, rerank_width: int | None = None,
                          window: int | None = None):
    """Distributed packed query in plain PyTorch: every rank runs
    ``engine/search.py:search_packed_impl`` over its view, then the
    all-gather merge.  Knobs as the single-card ``search_packed``;
    ``window`` overrides the view's read depth for this call."""
    from ..engine.search import search_packed_impl
    from ..ops.distance import pick_block

    if queries is None:
        points, queries = None, points
    if window is not None:
        spk = dataclasses.replace(spk, window=int(window))
    queries = _prep_queries(sidx, queries, mesh)
    pv = spk.local_view(sidx)
    if block_rows is None:
        nprb = sidx.d_short + 1 if n_probes is None else n_probes
        ltot = sidx.tries * nprb * pv.rows_per_probe() * spk.super_width
        block_rows = pick_block(queries.shape[0], ltot, sidx.d, sidx.bases.element_size(),
                                budget_bytes)
    corpus = _resolve_corpus(sidx, points, mesh)
    ids_l, dd = search_packed_impl(pv, corpus, queries, max(1, block_rows), n_probes,
                                   supercharge_rounds=supercharge_rounds,
                                   rerank_width=rerank_width)
    return _merge(mesh, ids_l, dd, sidx.n_local, sidx.n, sidx.k)


def search_packed_fused_sharded(sidx: ShardedIndex, spk: ShardedPacked, points=None,
                                queries=None, *, mesh: Mesh, n_probes: int | None = None,
                                window: int | None = None, supercharge_rounds: int = 1,
                                rerank_width: int | None = None, query_block=None,
                                interpret=None):
    """:func:`search_packed_sharded` with the probe kernel as every rank's
    candidate stage (``engine/search.py:search_packed_fused_impl``; its
    plain version on a CPU mesh), then the all-gather merge.  int8 views
    rank in the quantized domain and re-score against the rank's float
    slice.  ``query_block`` and ``interpret`` (TPU kernel knobs) raise
    ``ValueError``."""
    from ..engine.search import search_packed_fused_impl
    from ..ops.exact import check_tpu_knobs

    check_tpu_knobs({"query_block": query_block, "interpret": interpret})
    if queries is None:
        points, queries = None, points
    queries = _prep_queries(sidx, queries, mesh)
    corpus = _resolve_corpus(sidx, points, mesh)
    ids_l, dd = search_packed_fused_impl(spk.local_view(sidx), corpus, queries,
                                         n_probes=n_probes, window=window,
                                         supercharge_rounds=supercharge_rounds,
                                         rerank_width=rerank_width)
    return _merge(mesh, ids_l, dd, sidx.n_local, sidx.n, sidx.k)


def search_exact_sharded(points, queries, k: int, *, mesh: Mesh,
                         scale=None, matmul_precision: str = "highest",
                         twophase: bool | None = None, n_true: int | None = None,
                         seg: int | None = None, pad_segments: int = 2, rescan: str = "dma",
                         interpret=None, query_block=None):
    """Distributed exact kNN: every rank's exact top-kk over its slice,
    then the all-gather merge.  Equal to global brute force: each shard's
    local top-k holds every true global top-k member on that shard.

    A bf16/f16 corpus is searched at its stored width and an int8 one
    (``quantize_corpus``; pass its ``scale``) in the quantized domain, the
    one scale making distances comparable across shards.  A float64 corpus
    runs the float64 oracle on a CPU mesh; on a card mesh it is ranked by
    the float32 kernels, as the JAX package ranks it on the TPU.  Zero pad
    rows may sit on the last shard, so the local k widens by the pad
    count, ``kk = min(k + n_local * S - n, n_local)``; ``n_true`` is the
    real row count of a corpus the caller padded already.  Per rank:
    ``exact_knn_twophase`` when ``twophase`` is set (None: on a card where
    ``takes_twophase(n_local, kk)``), else ``exact_search`` routed as on
    one card with ``no_twophase``.  ``seg``, ``pad_segments`` and ``rescan``
    reach the two-phase engine wherever it runs (the JAX
    ``ShardedServer.search`` forwards them to a function without them, its
    ``parallel/serving.py:225-235``; here they are taken).  ``interpret`` and
    ``query_block`` raise ``ValueError``.  The JAX package's ``block`` (its
    CPU oracle's query block) is not taken: the port's oracle sizes its
    own."""
    from ..ops.exact import check_tpu_knobs, exact_search
    from ..ops.twophase import exact_knn_twophase, takes_twophase

    check_tpu_knobs({"query_block": query_block, "interpret": interpret})
    if not isinstance(points, LocalRows):
        points = torch.as_tensor(points)
    quant = points.dtype == torch.int8
    if quant and scale is None:
        raise ValueError("int8 corpus requires its quantization scale (see quantize_corpus)")
    f64 = points.dtype == torch.float64
    n = points.shape[0] if n_true is None else n_true
    local = _shard_points(points, mesh)
    n_local = local.shape[0]
    q = torch.as_tensor(queries, device=mesh.device)
    q = q if f64 and q.dtype == torch.float64 else q.float()
    kk = min(k + (n_local * mesh.size - n), n_local)
    if twophase is None:
        twophase = mesh.device.type == "cuda" and takes_twophase(n_local, kk)
    kw = dict(scale=scale if quant else None, matmul_precision=matmul_precision, seg=seg,
              pad_segments=pad_segments, rescan=rescan)
    if twophase and not f64:
        ids_l, dd = exact_knn_twophase(local, q.contiguous(), kk, **kw)
    else:
        ids_l, dd = exact_search(local, q, kk, no_twophase=True, **kw)
    return _merge(mesh, ids_l, dd, n_local, n, k)


def global_graph_sharded(sidx: ShardedIndex, points, *, mesh: Mesh, **kw):
    """Approximate global kNN graph: every point queried against every
    shard and merged, self-matches dropped (``kw`` as
    :func:`search_sharded`)."""
    ids, dd = search_sharded(sidx, points, points, mesh=mesh, **kw)
    own = ids == torch.arange(ids.shape[0], dtype=ids.dtype, device=ids.device)[:, None]
    dd = torch.where(own, torch.full_like(dd, float("inf")), dd)
    ids = torch.where(own, sidx.n, ids)
    return topk_no_dedup(dd, ids, sidx.k)
