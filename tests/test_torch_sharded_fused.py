"""The port's sharded fused packed search (through the probe kernel's plain
version) and the per-shard exact graph (the rank kernel's), against the
JAX package on the CPU.

The JAX side runs on a 2-device CPU mesh (n = 64 * 2 + 1, d = 16, 8
queries, k = 4, 2 tables, capacity 16) with its Pallas kernels in interpret
mode, each reference computed once; the port in 2 gloo processes
(``tests/torch_sharded_ranks.py``).  The fused search runs on the JAX
index carried across with ``ShardedIndex.from_numpy``; the exact graph does
not depend on the hash bases and is compared on the port's own build.

Tolerance (``torch_sharded_ranks.assert_parity``): ids the same set per row
outside near-ties (adjacent reference distances within 1e-5 relative),
every distance within 1024 float32 ULPs.
"""

import numpy as np
import pytest
import torch

from approximatenn_tpu.parallel import sharded as jsh
from approximatenn_tpu_torch.harness.scoring import recall_at_k
from approximatenn_tpu_torch.parallel import sharded as sh
from torch_sharded_ranks import (CAP, D, K, M, N, TRIES, assert_parity, brute, edge_dists,
                                 jax_arrays, ok, start_suite)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Y = rng.standard_normal((M, D)).astype(np.float32)
    mesh = jsh.make_mesh(2)
    jx = jsh.build_sharded(X, K, mesh=mesh, tries=TRIES, capacity=CAP, seed=0,
                           graph_mode="exact", chunk_rows=24)
    return dict(X=X, Y=Y, jx=jx, mesh=mesh)


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    inputs = dict(X=data["X"], Y=data["Y"], **jax_arrays(data["jx"], "jx_"))
    return start_suite("fused", inputs, tmp_path_factory.mktemp("fused"))


@pytest.fixture(scope="module")
def ref(data, ranks):
    X, Y, jx, mesh = data["X"], data["Y"], data["jx"], data["mesh"]
    spk = jsh.packed_sharded(jx, X, mesh=mesh)
    return dict(
        data,
        fused=jsh.search_packed_fused_sharded(jx, spk, X, Y, mesh=mesh, window=spk.window))


@pytest.fixture(scope="module")
def port(ranks):
    outs = ranks.result()
    for out in outs:
        ok(out, "fused")
    return outs


def test_exact_graph_matches_jax(ref, port):
    """Each rank's exact graph (the rank kernel's plain version, chunks of
    24 queries) against the JAX shard's, judged by float64 edge distances;
    the last shard's pad row (local id 64) is the sentinel in both."""
    jx = ref["jx"]
    for r, out in enumerate(port):
        pg, jg = out["fused.graph"], np.asarray(jx.graph)[r]
        assert_parity(pg, edge_dists(ref["X"], pg, r, jx.n_local), jg,
                      edge_dists(ref["X"], jg, r, jx.n_local))
    assert not (port[1]["fused.graph"] == jx.n - jx.n_local).any()


def test_exact_graph_rows_are_true_local_knn(ref, port):
    """The first shard's graph is the float64 kNN of its own slice, self
    excluded (the last shard's rows lose the zero pad row, which the
    origin-centred Gaussian puts near many of them, to the sentinel, as in
    the JAX package)."""
    X = ref["X"]
    n_local = ref["jx"].n_local
    for r, out in enumerate(port):
        assert tuple(out["fused.layout"]) == (N, n_local, r)
    sl = X[:n_local].astype(np.float64)
    d2 = ((sl[:, None] - sl[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    true = np.argsort(d2, 1, kind="stable")[:, :K]
    assert recall_at_k(true, port[0]["fused.graph"], K) == 1.0


def test_graph_precision_knob_accepted(port):
    """``graph_precision="default"`` reaches the exact graph; the CPU ranks
    at "highest" either way, so the graphs are equal."""
    for out in port:
        assert out["fused.precision_same"]


def test_search_packed_fused_sharded_matches_jax(ref, port):
    """The probe stage per rank (the kernel's plain version here, the JAX
    Pallas kernel in interpret mode there), then the merge."""
    for out in port:
        assert_parity(out["fused.fused_ids"], out["fused.fused_dd"], *ref["fused"])
        assert (out["fused.fused_ids"] < N).all()


def test_fused_int8_view_rescores_true_distances(ref, port):
    """Port only: the int8 view ranks in the quantized domain and re-scores
    on the float slice, so its distances are the float64 distances of its
    ids, and its recall@4 is near the float view's."""
    X, Y = ref["X"].astype(np.float64), ref["Y"].astype(np.float64)
    true, _ = brute(X, Y, K)
    for out in port:
        ids, dd = out["fused.fused8_ids"], out["fused.fused8_dd"]
        want = ((Y[:, None] - X[ids]) ** 2).sum(-1)
        np.testing.assert_allclose(dd, want, rtol=1e-5)
        assert recall_at_k(true, ids, K) >= recall_at_k(true, out["fused.fused_ids"], K) - 0.1


def test_fused_rejects_tpu_knobs():
    one = sh.Mesh(group=None, rank=0, size=1, device=torch.device("cpu"))
    for kw in ({"query_block": 32}, {"interpret": True}):
        with pytest.raises(ValueError, match="TPU"):
            sh.search_packed_fused_sharded(None, None, None, None, mesh=one, **kw)
