"""The port's sharded build, table search and angular metric
(``approximatenn_tpu_torch/parallel/sharded.py``) against the JAX package's
(``approximatenn_tpu/parallel/sharded.py``) on the CPU.

The port runs in 2 gloo processes (``tests/torch_sharded_ranks.py``, one
launch for the whole file); the JAX package on a 2-device CPU mesh, each
reference computed once.  Shapes are the dry run's: n = 64 * 2 + 1 (one
zero pad row on the last shard), d = 16, 8 queries, k = 4, 2 tables,
capacity 16.  ``jax.random`` cannot be reproduced in torch, so the port's
hash build takes the JAX build's bases, and the table search runs on the
JAX index carried across with ``ShardedIndex.from_numpy``.

Tolerance (``torch_sharded_ranks.assert_parity``): ids the same set per row
outside near-ties (adjacent reference distances within 1e-5 relative),
every distance within 1024 float32 ULPs (under one unit of
``harness/compare_results.py:ulp_units``); tables, counts and capacities
equal; row means and stored angular rows within 1e-6.  Cases without a JAX counterpart hold the
port to a float64 brute force, stated in each.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from approximatenn_tpu.engine.build import resolve_capacity as j_resolve_capacity
from approximatenn_tpu.ops.hash import query_codes as j_query_codes
from approximatenn_tpu.parallel import sharded as jsh
from approximatenn_tpu_torch.harness.scoring import recall_at_k
from approximatenn_tpu_torch.ops.hash import query_codes as t_query_codes
from approximatenn_tpu_torch.parallel import sharded as sh
from torch_sharded_ranks import (CAP, D, K, M, N, TRIES, assert_parity, brute, edge_dists,
                                 jax_arrays, ok, start_suite)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Y = rng.standard_normal((M, D)).astype(np.float32)
    Y0 = (0.01 * rng.standard_normal((M, D))).astype(np.float32)
    Xs = (rng.standard_normal((19, D)) + 3.0).astype(np.float32)
    mesh = jsh.make_mesh(2)
    jh = jsh.build_sharded(X, K, mesh=mesh, tries=TRIES, capacity=CAP, seed=0,
                           graph_mode="hash")
    ja = jsh.build_sharded(X, K, mesh=mesh, tries=TRIES, seed=0, metric="angular",
                           graph_mode="exact")
    return dict(X=X, Y=Y, Y0=Y0, Xs=Xs, jh=jh, ja=ja, mesh=mesh)


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    # the first shard's rows all one point: the ranks' bucket maxima differ
    Xskew = np.concatenate([np.repeat(data["X"][:1], N // 2 + 1, 0), data["X"][N // 2 + 1:]])
    inputs = dict(X=data["X"], Y=data["Y"], Y0=data["Y0"], Xs=data["Xs"], Xskew=Xskew,
                  bases=np.asarray(data["jh"].bases),
                  **jax_arrays(data["jh"], "jh_"), **jax_arrays(data["ja"], "ja_"))
    return start_suite("build", inputs, tmp_path_factory.mktemp("build"))


@pytest.fixture(scope="module")
def ref(data, ranks):
    X, Y, jh, mesh = data["X"], data["Y"], data["jh"], data["mesh"]
    r = dict(data)
    r["search"] = jsh.search_sharded(jh, X, Y, mesh=mesh, rerank_width=8,
                                     supercharge_rounds=2)
    r["angular"] = jsh.search_sharded(data["ja"], None, Y, mesh=mesh)
    return r


@pytest.fixture(scope="module")
def port(ranks):
    return ranks.result()


def test_shard_layout_matches_jax(ref, port):
    jh = ref["jh"]
    for r, out in enumerate(port):
        ok(out, "build")
        n, n_local, s, rank, tmax, d_short, n_padded = out["build.layout"]
        assert (n, n_local, s, rank) == (jh.n, jh.n_local, jh.n_shards, r)
        assert (tmax, d_short, n_padded) == (jh.tmax, jh.d_short, jh.n_padded) == (16, 5, 130)


def test_row_means_match_jax(ref, port):
    for out in port:
        np.testing.assert_allclose(out["build.row_means"], np.asarray(ref["jh"].row_means),
                                   rtol=0, atol=1e-6)


def test_tables_and_counts_with_shared_bases_match_jax(ref, port):
    """With the JAX bases, every point's codes agree between the frameworks
    here, so each rank's tables and counts are the JAX shard's, bit for
    bit."""
    jh = ref["jh"]
    X = ref["X"]
    for r, out in enumerate(port):
        rows = X[r * jh.n_local: (r + 1) * jh.n_local]
        jc, _ = j_query_codes(jh.row_means, jh.bases, jnp.asarray(rows))
        tc, _ = t_query_codes(torch.from_numpy(out["build.row_means"]),
                              torch.from_numpy(np.asarray(jh.bases)), torch.from_numpy(rows))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(out["build.counts"], np.asarray(jh.counts)[r])
        np.testing.assert_array_equal(out["build.tables"], np.asarray(jh.tables)[r])


def test_hash_graph_matches_jax(ref, port):
    """Each rank's hash graph (local ids) against the JAX shard's: the
    same sets outside near-ties, judged by the float64 distances of the
    JAX shard's edges."""
    jh = ref["jh"]
    for r, out in enumerate(port):
        pg, jg = out["build.graph"], np.asarray(jh.graph)[r]
        assert_parity(pg, edge_dists(ref["X"], pg, r, jh.n_local), jg,
                      edge_dists(ref["X"], jg, r, jh.n_local))


def test_pad_rows_masked_in_tables_and_graph(ref, port):
    """The last shard's zero pad row (local id 64) is the sentinel in its
    tables and graph, as in the JAX shard."""
    jh = ref["jh"]
    last = port[1]
    valid = jh.n - jh.n_local
    for key, j in (("tables", jh.tables), ("graph", jh.graph)):
        t = last[f"build.{key}"]
        assert not ((t >= valid) & (t < jh.n_local)).any()
        assert ((np.asarray(j)[1] >= valid) == (t >= valid)).all()


@pytest.mark.parametrize("cap", ["none", "auto", "int"])
def test_capacity_is_global_as_in_jax(ref, port, cap):
    """tmax from every rank's counts: the JAX package's ``resolve_capacity``
    over the stacked counts of a corpus whose first shard is one point
    repeated (so the ranks' own maxima differ), the same table width on
    every rank."""
    counts = np.stack([out["build.counts_skew"] for out in port])
    assert counts[0].max() != counts[1].max()
    want = j_resolve_capacity(counts, {"none": None, "auto": "auto", "int": 5}[cap])
    for out in port:
        ok(out, "build")
        assert tuple(out[f"build.tmax_{cap}"]) == (want, want)


def test_search_sharded_on_carried_jax_index_matches_jax(ref, port):
    """``rerank_width=8``, ``supercharge_rounds=2`` on the JAX index carried
    across, on the queries whose codes agree in every table (here: all);
    the same result on every rank, and with ``chunked=True``."""
    jh = ref["jh"]
    jc, _ = j_query_codes(jh.row_means, jh.bases, jnp.asarray(ref["Y"]))
    tc, _ = t_query_codes(torch.from_numpy(np.asarray(jh.row_means)),
                          torch.from_numpy(np.asarray(jh.bases)), torch.from_numpy(ref["Y"]))
    assert (tc.numpy() == np.asarray(jc)).all()
    for out in port:
        ok(out, "carried")
        assert_parity(out["carried.ids"], out["carried.dd"], *ref["search"])
        assert out["carried.chunked_same"]
        assert (out["carried.ids"] < N).all()
    np.testing.assert_array_equal(port[0]["carried.ids"], port[1]["carried.ids"])


def test_rerank_and_supercharge_do_not_lower_recall(ref, port):
    """The widened search's recall@4 against a float64 brute force is at
    least the default search's (port only: one JAX search is enough)."""
    true, _ = brute(ref["X"], ref["Y"], K)
    r0 = recall_at_k(true, port[0]["carried.base"], K)
    r1 = recall_at_k(true, port[0]["carried.ids"], K)
    assert r1 >= r0 - 1e-9 and r1 > 0.5, (r0, r1)


def test_index_carries_across_both_ways(port):
    """The JAX index's arrays -> ``from_numpy`` -> ``to_numpy`` gives them
    back; the port's own index survives the same round trip."""
    for out in port:
        assert out["carried.roundtrip"]
        ok(out, "own_roundtrip")
        assert out["own_roundtrip.same"]


@pytest.mark.parametrize("path", ["table", "packed", "fused"])
def test_pad_rows_cannot_occupy_topk_slots(ref, port, path):
    """A corpus shifted off the origin (19 rows, one pad row), near-origin
    queries, every bucket and slot read: each path returns the float64
    brute force's k real ids (port only; JAX's own case runs 8 shards)."""
    n, n_padded, d_short = port[0]["pads.layout"]
    assert (n, n_padded, d_short) == (19, 20, 1)
    true, _ = brute(ref["Xs"], ref["Y0"], 5)
    for out in port:
        ok(out, "pads")
        np.testing.assert_array_equal(np.sort(out[f"pads.{path}"], 1), np.sort(true, 1))


def test_angular_search_on_carried_jax_index_matches_jax(ref, port):
    """The angular index stores its normalized corpus; ``search_sharded``
    with no corpus normalizes the queries and serves from it."""
    for out in port:
        ok(out, "angular")
        assert_parity(out["angular.ids"], out["angular.dd"], *ref["angular"])


def test_angular_build_matches_jax(ref, port):
    """The port's own angular build stores the JAX shard's normalized rows
    (within 1e-6) and its exact graph (on those rows, judged by float64
    edge distances); the packed and fused path serves the carried angular
    index with no corpus given (recall@4 against the cosine brute force
    >= 0.75)."""
    ja = ref["ja"]
    Xn = np.asarray(ja.points)[:N]
    Yn = ref["Y"] / np.linalg.norm(ref["Y"], axis=1, keepdims=True)
    true, _ = brute(Xn, Yn, K)
    for r, out in enumerate(port):
        rows = np.asarray(ja.points)[r * ja.n_local: (r + 1) * ja.n_local]
        np.testing.assert_allclose(out["angular.points"], rows, rtol=1e-6, atol=1e-6)
        pg, jg = out["angular.graph"], np.asarray(ja.graph)[r]
        assert_parity(pg, edge_dists(Xn, pg, r, ja.n_local), jg,
                      edge_dists(Xn, jg, r, ja.n_local))
        assert recall_at_k(true, out["angular.fused_ids"], K) >= 0.75


def test_make_mesh_checks_its_arguments(port):
    for out in port:
        ok(out, "mesh_errors")
        assert str(out["mesh_errors.n_devices"]).startswith("ValueError")
        assert "device='cpu'" in str(out["mesh_errors.no_card"])
        assert tuple(out["mesh_errors.mesh"][1:]) == (2, 0)
    assert [int(o["mesh_errors.mesh"][0]) for o in port] == [0, 1]


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        sh.make_mesh(device="cpu")
