"""The Deep-10M deployment's slice of the port against the JAX package, on
the CPU at a small size:

(a) ``Server.build``'s auto route, storage type by storage type (float32,
    bfloat16, int8), on both sides of the exact engine's corpus bound (x2
    for 2-byte and x4 for 1-byte rows) and of ``twophase_min_n``: the
    port's mode and two-phase flag equal the JAX ``Server``'s.  The bound
    is injected by patching ``EXACT_MAX_N_DEFAULT`` in both packages (so
    the per-type multipliers run), ``twophase_min_n`` through its keyword,
    and the hash build is a stub on both sides (only the route is asked).
(b) The Deep-10M configuration at n = 20,000 x 96 (the Deep stand-in's
    clustered distribution: spread 2.0, Zipf 1.05): tries 6, capacity 48,
    exact graph, int8 packed rows, super_width 2; the index and its view
    built by the JAX package and carried across in npz files;
    ``search_packed_fused`` at windows 32 and 96 x probes 18 and 48, and
    window 96, 18 probes, ``rerank_width`` 50.  Ids equal the JAX package's
    (its Pallas kernel in interpret mode) outside near-ties (adjacent
    reference distances within rtol 1e-5), distances at rtol 1e-5 / atol
    1e-5: the int8 candidates are re-scored against the float32 corpus in
    both, which sum the same squares in another order.  Queries whose hash
    codes differ between the frameworks (a projection within rounding of
    zero) are left out, as in tests/test_torch_packed.py.
(c) No stage of the Deep-10M path needed row chunking on the card (the
    peaks are in PERF.md), so none of the JAX package's chunked loops was
    ported and there is nothing to hold to the unchunked functions.
(d) The index loaders place the index on the card by default: without a
    card they raise unless ``device="cpu"`` is given.
"""

import numpy as np
import pytest
import torch

import approximatenn_tpu_torch as tann
from approximatenn_tpu_torch.data.synthetic import clustered_gaussian, gaussian
from approximatenn_tpu_torch.engine import serving as tserving
from approximatenn_tpu_torch.harness.scoring import ids_agree
from approximatenn_tpu_torch.index import ANNIndex, PackedIndex
from approximatenn_tpu_torch.ops import exact as ex
from approximatenn_tpu_torch.ops.hash import query_codes

torch.set_num_threads(1)

# (a): the exact bound every storage type reaches through its multiplier
BOUND, D_ROUTE = 3000, 96
MULTIPLIER = {"float32": 1, "bfloat16": 2, "int8": 4}

# (b): the Deep-10M configuration at a CPU size; the JAX kernel's
# interpret mode costs ~2-4 s a query at tries 6, so each point takes two
N, D, K, TRIES, CAPACITY, M = 20_000, 96, 10, 6, 48, 2
PACKED_POINTS = {  # name: search_packed_fused keywords
    "w32_p18": dict(window=32, n_probes=18),
    "w32_p48": dict(window=32, n_probes=48),
    "w96_p18": dict(window=96, n_probes=18),
    "w96_p48": dict(window=96, n_probes=48),
    "w96_p18_rerank50": dict(window=96, n_probes=18, rerank_width=50),
}


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("k", [10, 130])
@pytest.mark.parametrize("tp_side", ["below", "at"])
@pytest.mark.parametrize("n_side", ["at", "above"])
@pytest.mark.parametrize("dtype", sorted(MULTIPLIER))
def test_server_auto_route_matches_jax(monkeypatch, dtype, n_side, tp_side, k):
    import jax.numpy as jnp

    import approximatenn_tpu.engine.build as jbuild
    import approximatenn_tpu.engine.serving as jserving
    from approximatenn_tpu_torch.engine import build as tbuild

    default = BOUND // MULTIPLIER[dtype]
    monkeypatch.setattr(jserving, "EXACT_MAX_N_DEFAULT", default)
    monkeypatch.setattr(tserving, "EXACT_MAX_N_DEFAULT", default)
    # the hash engine's build is not what is asked here
    monkeypatch.setattr(jbuild, "build", lambda *a, **kw: (None, None, None))
    monkeypatch.setattr(tbuild, "build", lambda *a, **kw: (None, None, None))
    n = BOUND + (n_side == "above")
    tp_min = n + (tp_side == "below")  # "below": n is one short of the threshold
    X = np.random.default_rng(7).standard_normal((n, D_ROUTE)).astype(np.float32)
    jdt = {"float32": None, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    tdt = {"float32": None, "bfloat16": torch.bfloat16, "int8": torch.int8}[dtype]
    js = jserving.Server.build(jnp.asarray(X), k, storage_dtype=jdt, twophase_min_n=tp_min)
    ts = tserving.Server.build(T(X), k, storage_dtype=tdt, twophase_min_n=tp_min)
    assert (ts.mode, ts._twophase) == (js.mode, js._twophase)
    # the rule itself, written out: int8 is always exact; k = 130 stays
    # exact (n >= 8 (k + 2)) but never takes the two-phase selection
    want_mode = "exact" if dtype == "int8" or n <= BOUND else "hash"
    assert ts.mode == want_mode
    assert ts._twophase == (want_mode == "exact" and tp_side == "at" and k == 10)
    assert ts.describe()["storage_dtype"] == dtype


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """The JAX index and int8 packed view over the Deep-distributed corpus,
    and the port's view through the JAX npz file."""
    import jax.numpy as jnp

    import approximatenn_tpu as jann

    rng = np.random.default_rng(96)
    X = clustered_gaussian(rng, N, D, n_clusters=256, spread=2.0, zipf=1.05)
    Y = (X[rng.integers(0, N, M)] + 0.1 * gaussian(rng, M, D)).astype(np.float32)
    jidx, _, _ = jann.build(jnp.asarray(X), K, tries=TRIES, capacity=CAPACITY, seed=1,
                            store_points=True)
    jpv = jidx.packed(window=96, super_width=2, dtype=jnp.int8)
    path = str(tmp_path_factory.mktemp("deep") / "pv.npz")
    jpv.save(path)
    tpv = PackedIndex.load(path, device="cpu")
    return X, Y, jidx, jpv, tpv


def test_deep_configuration_carried(deep):
    """The carried view is the configuration's: exact graph (auto at this
    n), tries 6, super_width 2, int8 rows equal to the JAX view's."""
    X, _, jidx, jpv, tpv = deep
    assert (tpv.n, tpv.d, tpv.tries, tpv.super_width, tpv.window) == (N, D, TRIES, 2, 96)
    assert tpv.point_rows.dtype == torch.int8 and tpv.scale is not None
    assert jidx.tmax == CAPACITY
    np.testing.assert_array_equal(tpv.point_rows.numpy(), np.asarray(jpv.point_rows)[:, :D])
    # the exact graph: each row's 10 neighbours are the float64 oracle's up to ties
    rows = np.arange(0, N, 997)
    g = np.asarray(jidx.graph)[rows]
    dd = ((X[rows, None, :].astype(np.float64) - X[None].astype(np.float64)) ** 2).sum(-1)
    dd[np.arange(rows.size), rows] = np.inf
    kth = np.sort(dd, 1)[:, K - 1]
    got = np.take_along_axis(dd, g.astype(np.int64), 1)
    assert (got <= kth[:, None] * (1 + 1e-6)).all()


@pytest.mark.parametrize("point", sorted(PACKED_POINTS))
def test_search_packed_fused_matches_jax(deep, point):
    import jax.numpy as jnp

    import approximatenn_tpu as jann
    from approximatenn_tpu.ops.hash import query_codes as j_query_codes

    X, Y, jidx, jpv, tpv = deep
    kw = PACKED_POINTS[point]
    ji, jd = jann.search_packed_fused(jpv, queries=jnp.asarray(Y), interpret=True, **kw)
    before = ex.launches["probe_topk"]
    ti, td = tann.search_packed_fused(tpv, queries=T(Y), **kw)
    assert ex.launches["probe_topk"] == before  # a CPU view: the plain version
    assert ti.shape == (M, K) and ti.dtype == torch.int32
    jc, _ = j_query_codes(jidx.row_means, jidx.bases, jnp.asarray(Y))
    tc, _ = query_codes(tpv.row_means, tpv.bases, T(Y))
    same = (tc.numpy() == np.asarray(jc)).all(1)
    assert same.sum() >= M - 1
    ji, jd = T(np.asarray(ji))[same], T(np.asarray(jd))[same]
    ok, _ = ids_agree(ti[same], ji, jd, rtol=1e-5)
    assert ok, (ti[same], ji)
    fin = torch.isfinite(jd)
    assert torch.equal(fin, torch.isfinite(td[same]))
    np.testing.assert_allclose(td[same][fin].numpy(), jd[fin].numpy(), rtol=1e-5, atol=1e-5)
    # int8 candidates come back re-scored against the float32 corpus
    real = ti < N
    d2 = ((T(X)[ti.clamp(max=N - 1).long()] - T(Y)[:, None]) ** 2).sum(-1)
    np.testing.assert_allclose(td[real].numpy(), d2[real].numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture()
def small_index(tmp_path):
    X = np.random.default_rng(3).standard_normal((600, 16)).astype(np.float32)
    idx, _, _ = tann.build(T(X), 5, tries=3, seed=2, store_points=True)
    path = str(tmp_path / "idx.npz")
    idx.save(path)
    ppath = str(tmp_path / "pv.npz")
    idx.packed(dtype=torch.int8).save(ppath)
    return path, ppath


def test_loaders_default_to_the_card(small_index, monkeypatch):
    """Without a card, loading with no device raises (it would otherwise
    serve from the CPU unasked); ``device="cpu"`` loads onto the CPU."""
    path, ppath = small_index
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with np.load(path) as z:
        arrays = dict(z)
    with np.load(ppath) as z:
        parrays = dict(z)
    for call in (lambda: ANNIndex.load(path), lambda: ANNIndex.from_numpy(arrays),
                 lambda: PackedIndex.load(ppath), lambda: PackedIndex.from_numpy(parrays)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
    idx = ANNIndex.load(path, device="cpu")
    pv = PackedIndex.load(ppath, device="cpu")
    for t in (idx.tables, idx.graph, idx.points, idx.bases, pv.point_rows, pv.ids, pv.scale):
        assert t.device.type == "cpu"
    assert torch.equal(ANNIndex.from_numpy(arrays, device="cpu").graph, idx.graph)
    assert torch.equal(PackedIndex.from_numpy(parrays, device="cpu").point_rows, pv.point_rows)


def test_build_records_its_stages():
    """``build``'s stages (and the packed view's, through ``Server.build``)
    land in a ``StageTimes``; peak memory is kept only where a card is in
    use."""
    from approximatenn_tpu_torch.utils.profiling import StageTimes

    X = T(np.random.default_rng(5).standard_normal((800, 16)).astype(np.float32))
    st = StageTimes(memory=True)
    srv = tserving.Server.build(X, 5, mode="hash", layout="packed", packed_dtype=torch.int8,
                                tries=3, capacity=48, seed=1, stage_times=st)
    assert list(st.totals) == ["hash", "tables", "graph", "pack"]
    assert all(st.counts[name] == 1 for name in st.totals)
    assert not st.peaks  # the CPU: nothing to read
    assert srv.describe()["layout"] == "packed"
    hashed = StageTimes()
    tann.build(X, 5, tries=3, seed=1, graph_mode="hash", stage_times=hashed)
    assert list(hashed.totals) == ["hash", "graph"]  # the hash graph builds its tables
