"""approximatenn_tpu_torch -- the PyTorch and CUDA port of approximatenn_tpu.

Same algorithm and public names as the JAX package: randomized
orthogonal-projection sign hashing with multiprobe lookup, multi-table
merge and kNN-graph "supercharge", plus an exact engine whose top-k runs in
hand-written CUDA kernels on an NVIDIA Hopper card.  Imports torch only,
never jax.

    index, graph, dists = build(points, k, tries=..., generator=...)  # precomp
    ids, dists = search(index, points, queries)                       # query
    ids, dists = exact_search(points, queries, k)                     # exact
    pv = index.packed(dtype=torch.bfloat16, window=96)               # packed view
    ids, dists = search_packed_fused(pv, queries, n_probes=18)       # probe kernel
    report = tune(points, k, target_recall=0.9)                      # operating point
    srv = report.server()
"""

from .config import ftype, itype, set_ftype
from .engine.build import build, build_graph_only
from .engine.search import search, search_packed, search_packed_fused
from .engine.serving import Server
from .engine.tuning import TuneReport, tune
from .index import ANNIndex, PackedIndex, stage_points
from .ops.distance import brute_force_knn, brute_force_knn_self
from .ops.exact import exact_search, quantize_corpus
from .ops.twophase import exact_knn_twophase

__version__ = "0.1.0"


def precomp(points, k: int, *, tries: int = 10, rots_before: int = 6,
            rot_len_before: int = 1, rots_after: int = 1,
            rot_len_after: int = 1, generator=None, seed: int = 0,
            save: bool = True, **kw):
    """Reference-shaped build: returns ``(graph, dists, index)``; ``index``
    is None when ``save`` is False."""
    index, graph, dists = build(
        points, k, tries=tries, rots_before=rots_before,
        rot_len_before=rot_len_before, rots_after=rots_after,
        rot_len_after=rot_len_after, generator=generator, seed=seed, **kw,
    )
    return graph, dists, (index if save else None)


def query(index: ANNIndex, points, y, **kw):
    """Reference-shaped batch query: returns (ids, dists)."""
    return search(index, points, y, **kw)


__all__ = [
    "ANNIndex", "PackedIndex", "Server", "build", "build_graph_only", "search",
    "search_packed", "search_packed_fused", "stage_points", "precomp",
    "query", "brute_force_knn", "brute_force_knn_self", "exact_search",
    "exact_knn_twophase", "quantize_corpus", "ftype", "itype", "set_ftype",
    "tune", "TuneReport",
]
