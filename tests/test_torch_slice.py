"""The port's main path against the JAX package on the CPU: search over a
JAX-built index, the exact and hash kNN graphs, ``Server`` and the
reference-shaped aliases.

Ids must be equal outside near-ties (adjacent reference distances within
1e-5 relative); distances agree at rtol=1e-5.  Hash codes come from one
float32 projection in each framework, so a projection within rounding of
zero may take either sign: search parity then needs >= 99.5% of codes to
agree and compares ids on the queries whose codes all agree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximatenn_tpu as jann
import approximatenn_tpu_torch as tann
from approximatenn_tpu.engine import build as jbuild
from approximatenn_tpu.ops.hash import query_codes as j_query_codes
from approximatenn_tpu_torch.engine import build as tbuild
from approximatenn_tpu_torch.harness.scoring import ids_agree, recall_at_k
from approximatenn_tpu_torch.index import ANNIndex
from approximatenn_tpu_torch.ops.hash import query_codes as t_query_codes

torch.set_num_threads(1)

N, D, K, TRIES = 2000, 24, 10, 4


def T(a):
    return torch.from_numpy(np.array(a))


def assert_match(ia, da, ib, db, rtol=1e-5, atol=1e-5):
    ia, da, ib, db = (x.cpu() if isinstance(x, torch.Tensor) else T(x)
                      for x in (ia, da, ib, db))
    ok, _ = ids_agree(ia, ib, db, rtol=1e-5)
    assert ok, (ia, ib)
    fin = torch.isfinite(db)
    assert torch.equal(fin, torch.isfinite(da))
    np.testing.assert_allclose(da[fin].numpy(), db[fin].numpy(), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2024)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Y = rng.standard_normal((100, D)).astype(np.float32)
    return X, Y


@pytest.fixture(scope="module")
def jax_built(data, tmp_path_factory):
    X, _ = data
    jidx, jgraph, jgd = jann.build(jnp.asarray(X), K, tries=TRIES, seed=3)
    path = str(tmp_path_factory.mktemp("idx") / "j.npz")
    jidx.save(path)
    return jidx, jgraph, jgd, ANNIndex.load(path, device="cpu")


@pytest.mark.parametrize("kw", [
    {},
    {"n_probes": 6, "supercharge_rounds": 2, "rerank_width": 20},
], ids=["blind", "directed"])
def test_search_parity_on_jax_index(data, jax_built, kw):
    X, Y = data
    jidx, _, _, tidx = jax_built
    jc, _ = j_query_codes(jidx.row_means, jidx.bases, jnp.asarray(Y))
    tc, _ = t_query_codes(tidx.row_means, tidx.bases, T(Y))
    same = (tc.numpy() == np.asarray(jc))
    assert same.mean() >= 0.995
    rows = same.all(1)
    ji, jdd = jann.search(jidx, jnp.asarray(X), jnp.asarray(Y), **kw)
    ti, tdd = tann.search(tidx, T(X), T(Y), **kw)
    assert ti.shape == (len(Y), K) and ti.dtype == torch.int32
    assert_match(ti[rows], tdd[rows], np.asarray(ji)[rows], np.asarray(jdd)[rows])


def test_exact_graph_parity(data, jax_built):
    X, _ = data
    _, jgraph, jgd, _ = jax_built
    tidx, tgraph, tgd = tann.build(T(X), K, tries=TRIES, seed=3, graph_mode="exact")
    assert tgraph.dtype == torch.int32 and tgraph.shape == (N, K)
    assert_match(tgraph, tgd, jgraph, jgd)
    assert torch.equal(tidx.graph, tgraph)
    # the hash tables depend on the sampled bases; their shape does not
    assert tidx.tables.shape[:2] == (TRIES, 1 << tidx.d_short)


@pytest.mark.parametrize("n_probes", [None, 5])
def test_hash_graph_parity_on_shared_codes(data, n_probes):
    X, _ = data
    n = 800
    Xs = jnp.asarray(X[:n])
    d_short, _ = jbuild.derive_dims(n, K, D)
    rm, bases, codes, counts = jbuild.hash_stage(
        Xs, jax.random.key(5), d_short=d_short, tries=TRIES, rb=6, rlb=1, ra=1,
        rla=1, dtype=jnp.float32)
    tmax = jbuild.resolve_capacity(counts, None)
    assert tbuild.resolve_capacity(T(counts), None) == tmax
    assert tbuild.resolve_capacity(T(counts), "auto") == jbuild.resolve_capacity(counts, "auto")
    jt, jg, jgd = jbuild.graph_stage(Xs, codes, counts, k=K, d_short=d_short, tmax=tmax,
                                     block_rows=128, n_probes=n_probes, row_means=rm,
                                     bases=bases)
    tt, tg, tgd = tbuild.graph_stage(T(X[:n]), T(codes), T(counts), k=K, d_short=d_short,
                                     tmax=tmax, block_rows=128, n_probes=n_probes,
                                     row_means=T(rm), bases=T(bases))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert_match(tg, tgd, jg, jgd)


def test_hash_build_given_bases_matches_jax_codes(data):
    X, _ = data
    n = 800
    d_short, _ = jbuild.derive_dims(n, K, D)
    rm, bases, codes, counts = jbuild.hash_stage(
        jnp.asarray(X[:n]), jax.random.key(5), d_short=d_short, tries=TRIES, rb=6,
        rlb=1, ra=1, rla=1, dtype=jnp.float32)
    trm, tb, tc, tcounts = tbuild.hash_stage(T(X[:n]), None, d_short=d_short, tries=TRIES,
                                             rb=6, rlb=1, ra=1, rla=1,
                                             dtype=torch.float32, bases=T(bases))
    np.testing.assert_allclose(trm.numpy(), np.asarray(rm), rtol=1e-5, atol=1e-6)
    assert (tc.numpy() == np.asarray(codes)).mean() >= 0.995


def test_port_hash_build_recall(data):
    X, Y = data
    idx, graph, _ = tann.build(T(X), K, tries=TRIES, seed=0, graph_mode="hash")
    true, _ = tann.brute_force_knn(T(X), T(Y), K)
    ids, dd = tann.search(idx, T(X), T(Y))
    jidx, _, _ = jann.build(jnp.asarray(X), K, tries=TRIES, seed=0, graph_mode="hash")
    jids, _ = jann.search(jidx, jnp.asarray(X), jnp.asarray(Y))
    # different sampled transforms: the recalls agree statistically
    r_t = recall_at_k(true.numpy(), ids.numpy(), K)
    r_j = recall_at_k(true.numpy(), np.asarray(jids), K)
    assert abs(r_t - r_j) < 0.1 and r_t > 0.3, (r_t, r_j)
    gtrue, _ = tann.brute_force_knn_self(T(X), K)
    assert recall_at_k(gtrue.numpy(), graph.numpy(), K) > 0.5


@pytest.mark.parametrize("case", ["auto", "exact_int8", "angular", "hash"])
def test_server_parity(data, jax_built, case):
    X, Y = data
    if case == "hash":
        # a hash Server serves through its index's stored points
        jidx = dataclasses.replace(jax_built[0], points=jnp.asarray(X))
        tidx = dataclasses.replace(jax_built[3], points=T(X))
        jsrv = jann.Server(points=jnp.asarray(X), k=K, mode="hash", index=jidx)
        tsrv = tann.Server(points=T(X), k=K, mode="hash", index=tidx)
    else:
        kw = {"auto": {}, "exact_int8": {"storage_dtype": (jnp.int8, torch.int8)},
              "angular": {"metric": ("angular", "angular")}}[case]
        jsrv = jann.Server.build(jnp.asarray(X), K, **{a: v[0] for a, v in kw.items()})
        tsrv = tann.Server.build(T(X), K, **{a: v[1] for a, v in kw.items()})
    jd_, td_ = jsrv.describe(), tsrv.describe()
    for key in ("mode", "n", "d", "k", "metric", "recall", "storage_dtype"):
        assert td_[key] == jd_[key], key
    Yq = Y[:40]
    ji, jdd = jsrv.search(jnp.asarray(Yq))
    ti, tdd = tsrv.search(T(Yq))
    if case == "hash":
        jc, _ = j_query_codes(jsrv.index.row_means, jsrv.index.bases, jnp.asarray(Yq))
        tc, _ = t_query_codes(tsrv.index.row_means, tsrv.index.bases, T(Yq))
        rows = (tc.numpy() == np.asarray(jc)).all(1)
        ti, tdd, ji, jdd = ti[rows], tdd[rows], np.asarray(ji)[rows], np.asarray(jdd)[rows]
    assert_match(ti, tdd, ji, jdd)
    if tsrv.mode == "exact":
        assert td_["exact_engine"] == "oracle"  # CPU corpus: no kernel


def test_server_routes_and_unported(data):
    X, Y = data
    srv = tann.Server.build(T(X), K, mode="hash", tries=2, seed=1)
    assert srv.describe()["layout"] == "table" and srv.index.tries == 2
    ids, _ = srv.search(T(Y[:5]))
    assert ids.shape == (5, K)
    assert tann.Server.build(T(X), K, exact_max_n=100).mode == "hash"
    psrv = tann.Server.build(T(X), K, mode="hash", layout="packed", tries=2, seed=1)
    assert psrv.describe()["layout"] == "packed" and psrv.search(T(Y[:5]))[0].shape == (5, K)
    with pytest.raises(ValueError):
        tann.Server.build(T(X), K, mode="hash", storage_dtype=torch.int8)


def test_precomp_and_query_aliases(data):
    X, Y = data
    graph, dists, idx = tann.precomp(T(X[:500]), 5, tries=2, seed=4)
    assert idx is not None and torch.equal(idx.graph, graph)
    g2, _, none = tann.precomp(T(X[:500]), 5, tries=2, seed=4, save=False)
    assert none is None and torch.equal(g2, graph)
    a = tann.query(idx, T(X[:500]), T(Y[:7]))
    b = tann.search(idx, T(X[:500]), T(Y[:7]))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    gi, gd = tann.build_graph_only(T(X[:500]), 5, tries=2, seed=4)
    assert torch.equal(gi, graph)


def test_entry_points_default_to_the_card(data):
    """A numpy corpus with no device goes to the CUDA card: without one,
    ``build`` and ``Server.build`` raise rather than quietly running on the
    CPU.  ``device="cpu"`` (or a CPU tensor) still asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    X, _ = data
    with pytest.raises(RuntimeError, match="CUDA"):
        tann.build(X[:300], 5, tries=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tann.Server.build(X[:300], 5)
    idx, _, _ = tann.build(X[:300], 5, tries=2, device="cpu")
    assert idx.device.type == "cpu"
    assert tann.Server.build(X[:300], 5, device="cpu").points.device.type == "cpu"
