"""Places where the port once behaved differently from the JAX package,
each held to the JAX package's behaviour on the same numpy inputs on the
CPU: ``search`` on an index whose tables were dropped, ``Server``'s pinned
search knobs (``_search_kw``) in hash and in exact mode, exact-mode
``Server.add_points`` in the stored dtype, and ``search``'s ``chunked``
switch.

The hash index is built once by the JAX package and loaded by the port
from its saved file, so both search the same tables with the same
transforms; queries whose bucket codes differ between the frameworks (a
projection within rounding of a threshold) are left out, as in
``test_torch_slice.py``.

Tolerance: ids equal outside near-ties (relative distance gap 1e-5) and
distances within rtol 1e-5 / atol 1e-5 between the frameworks; stored
corpora and the raised errors' texts compared for equality.  Where a case
also compares two runs of the port, those are compared for equality.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximatenn_tpu as jann
import approximatenn_tpu_torch as tann
from approximatenn_tpu.ops.hash import query_codes as j_query_codes
from approximatenn_tpu_torch import config
from approximatenn_tpu_torch.engine import serving
from approximatenn_tpu_torch.harness.scoring import ids_agree
from approximatenn_tpu_torch.index import ANNIndex
from approximatenn_tpu_torch.ops.hash import query_codes as t_query_codes

torch.set_num_threads(1)

N, D, K = 1500, 16, 5
PINS = {"rerank_width": 25, "supercharge_rounds": 2}


def T(a):
    return torch.from_numpy(np.array(a))


def same(a, b):
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def assert_match(port, ref, rows=slice(None)):
    """The port's (ids, distances) against the JAX package's."""
    ia, da = (x[rows] for x in port)
    ib, db = (T(x)[rows] for x in ref)
    ok, _ = ids_agree(ia, ib, db, rtol=1e-5)
    assert ok, (ia, ib)
    fin = torch.isfinite(db)
    assert torch.equal(fin, torch.isfinite(da))
    np.testing.assert_allclose(da[fin].numpy(), db[fin].numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """X, Y, the JAX index, the port's copy of it, and the queries whose
    bucket codes agree in every table."""
    rng = np.random.default_rng(77)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Y = rng.standard_normal((60, D)).astype(np.float32)
    jidx, _, _ = jann.build(jnp.asarray(X), K, tries=2, seed=3, store_points=True)
    path = str(tmp_path_factory.mktemp("idx") / "j.npz")
    jidx.save(path)
    tidx = ANNIndex.load(path, device="cpu")
    jc, _ = j_query_codes(jidx.row_means, jidx.bases, jnp.asarray(Y))
    tc, _ = t_query_codes(tidx.row_means, tidx.bases, T(Y))
    agree = tc.numpy() == np.asarray(jc)
    assert agree.mean() >= 0.995
    return X, Y, jidx, tidx, agree.all(1)


@pytest.fixture(scope="module")
def hash_servers(built):
    """(JAX server, port server) over the one index, per layout, with
    ``n_probes=2`` set at build as ``Server.build`` would."""
    X, _, jidx, tidx, _ = built
    out = {}
    for layout in ("table", "packed"):
        jsrv = jann.Server(points=jnp.asarray(X), k=K, mode="hash", index=jidx,
                           n_probes=2, packed=jidx.packed() if layout == "packed" else None)
        tsrv = tann.Server(points=T(X), k=K, mode="hash", index=tidx, n_probes=2,
                           packed=tidx.packed() if layout == "packed" else None)
        out[layout] = (jsrv, tsrv)
    return out


def test_search_on_dropped_tables_raises_the_reference_error(built):
    X, Y, jidx, tidx, rows = built
    jslim, slim = jidx.drop_tables(), tidx.drop_tables()
    assert slim.tables is None and slim.counts is None
    for args in ((X, Y), (Y,)):
        with pytest.raises(ValueError, match="drop_tables") as ref:
            jann.search(jslim, *map(jnp.asarray, args))
        with pytest.raises(ValueError, match="drop_tables") as port:
            tann.search(slim, *map(T, args))
        assert str(port.value) == str(ref.value)
    # the packed view still builds from the slim index and serves as the
    # reference's does
    got = tann.search_packed(slim.packed(T(X)), T(X), T(Y))
    assert same(got, tann.search_packed(tidx.packed(T(X)), T(X), T(Y)))
    assert_match(got, jann.search_packed(jslim.packed(jnp.asarray(X)), jnp.asarray(X),
                                         jnp.asarray(Y)), rows)
    # updates keep their own wording
    with pytest.raises(ValueError, match="updates need the padded tables"):
        slim.remove_points([0])


@pytest.mark.parametrize("layout", ["table", "packed"])
def test_server_pinned_hash_knobs_act_as_per_call_knobs(built, hash_servers, layout):
    _, Y, _, _, rows = built
    jsrv, tsrv = hash_servers[layout]
    jpinned = dataclasses.replace(jsrv, _search_kw=dict(PINS))
    pinned = dataclasses.replace(tsrv, _search_kw=dict(PINS))
    ref = jpinned.search(jnp.asarray(Y))
    got = pinned.search(T(Y))
    assert_match(got, ref, rows)
    # in both packages the pins act as the same knobs passed per call, and
    # they do change the search
    assert_match(tsrv.search(T(Y), **PINS), jsrv.search(jnp.asarray(Y), **PINS), rows)
    assert same(got, tsrv.search(T(Y), **PINS))
    assert not np.array_equal(np.asarray(ref[0]), np.asarray(jsrv.search(jnp.asarray(Y))[0]))
    assert not torch.equal(got[0], tsrv.search(T(Y))[0])
    assert tsrv._search_kw == {}


@pytest.mark.parametrize("layout", ["table", "packed"])
def test_server_call_keyword_overrides_the_pinned_one(built, hash_servers, layout):
    _, Y, _, _, rows = built
    jsrv, tsrv = hash_servers[layout]
    jpinned = dataclasses.replace(jsrv, _search_kw=dict(PINS))
    pinned = dataclasses.replace(tsrv, _search_kw=dict(PINS))
    override = {"rerank_width": None, "supercharge_rounds": 0}
    got = pinned.search(T(Y), **override)
    assert_match(got, jpinned.search(jnp.asarray(Y), **override), rows)
    assert same(got, tsrv.search(T(Y), **override))
    # one pin overridden, the other kept
    got = pinned.search(T(Y), rerank_width=40)
    assert_match(got, jpinned.search(jnp.asarray(Y), rerank_width=40), rows)
    assert same(got, tsrv.search(T(Y), rerank_width=40, supercharge_rounds=2))
    assert pinned._search_kw == PINS  # a call leaves the pins alone


def test_server_pinned_exact_knob_reaches_the_exact_engine(built, monkeypatch):
    X, Y, *_ = built
    jsrv = jann.Server.build(jnp.asarray(X), K, mode="exact")
    srv = tann.Server.build(T(X), K, mode="exact")
    # off the TPU the reference takes a pinned kernel knob and answers with
    # its brute force; the port's CPU path is the streaming kernel's plain
    # version: the same neighbours
    jpinned = dataclasses.replace(jsrv, _search_kw={"stream": True})
    pinned = dataclasses.replace(srv, _search_kw={"stream": True})
    got = pinned.search(T(Y))
    assert_match(got, jpinned.search(jnp.asarray(Y)))
    assert same(got, srv.search(T(Y), stream=True))
    assert_match(pinned.search(T(Y), stream=False),
                 jpinned.search(jnp.asarray(Y), stream=False))
    seen = []
    real = serving.exact_search

    def spy(points, queries, k, **kw):
        seen.append(kw)
        return real(points, queries, k, **kw)

    monkeypatch.setattr(serving, "exact_search", spy)
    pinned.search(T(Y))
    pinned.search(T(Y), stream=False, merge="rescan")
    assert seen[0]["stream"] is True and seen[0]["no_twophase"] is True
    assert seen[1]["stream"] is False and seen[1]["merge"] == "rescan"
    # a pinned TPU tiling knob is refused as it is per call
    tiled = dataclasses.replace(srv, _search_kw={"tile": 256})
    with pytest.raises(ValueError, match="tile"):
        tiled.search(T(Y))
    assert same(tiled.search(T(Y), tile=None), srv.search(T(Y)))


def test_server_describe_names_the_engine_of_a_pinned_search(built):
    X, *_ = built
    jsrv = jann.Server.build(jnp.asarray(X), K, mode="exact")
    srv = tann.Server.build(T(X), K, mode="exact")
    pins = {"stream": True, "compute_dtype": torch.bfloat16}
    jpinned = dataclasses.replace(jsrv, _search_kw={"stream": True,
                                                    "compute_dtype": jnp.bfloat16})
    pinned = dataclasses.replace(srv, _search_kw=pins)
    # the reference's describe() takes no keywords and reads no pin: the
    # keys the two packages share are the same with and without pins
    for key in ("mode", "n", "d", "k", "metric", "recall", "storage_dtype"):
        assert jpinned.describe()[key] == jsrv.describe()[key] == pinned.describe()[key], key
    # the port's also names the engine that search(**kw) runs, so it reads
    # the pins under the call's keywords exactly as search does
    assert pinned.describe() == srv.describe(**pins)
    assert pinned.exact_engine() == srv.exact_engine(**pins)
    assert pinned.describe(stream=False) == srv.describe(stream=False,
                                                         compute_dtype=torch.bfloat16)
    # the routing predicate sees the merged knobs, as the reference's does:
    # a rank-family pin keeps a search off the two-phase engine
    big = dataclasses.replace(jpinned, _twophase=True)
    assert not big._route_twophase(K, False, dict(big._search_kw))
    assert serving.route(10**6, K, {**pins}, False) != "twophase"


@pytest.mark.parametrize("case", ["float64", "float64-angular", "bfloat16", "int8"])
def test_exact_add_points_prepares_rows_in_the_stored_dtype(case):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((400, 12))  # float64
    metric = "angular" if case.endswith("angular") else "l2"
    jdt, sdt = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
                "int8": (jnp.int8, torch.int8)}.get(case, (None, None))
    old = config.ftype()
    config.set_ftype("float64")
    jax.config.update("jax_enable_x64", True)  # or the reference holds no float64
    try:
        whole = tann.Server.build(T(X), K, mode="exact", metric=metric, storage_dtype=sdt)
        grown = tann.Server.build(T(X[:200]), K, mode="exact", metric=metric,
                                  storage_dtype=sdt)
        jgrown = jann.Server.build(jnp.asarray(X[:200]), K, mode="exact", metric=metric,
                                   storage_dtype=jdt)
        if sdt == torch.int8:
            assert grown.scale == pytest.approx(float(jgrown._search_kw["scale"]), rel=1e-6)
            grown.scale = float(jgrown._search_kw["scale"])  # one grid for both packages
        grown.add_points(T(X[200:]))
        jgrown.add_points(jnp.asarray(X[200:]))
        ref = np.asarray(jgrown.points.astype(jnp.float64))
    finally:
        jax.config.update("jax_enable_x64", False)
        config.set_ftype(old)
    assert str(grown.points.dtype).replace("torch.", "") == str(jgrown.points.dtype)
    added, ref_added = grown.points[200:].double().numpy(), ref[200:]
    if case == "float64":
        assert whole.points.dtype == torch.float64
        # not what a trip through float32 leaves
        assert not np.array_equal(X[200:].astype(np.float32).astype(np.float64), X[200:])
    if case == "float64-angular":
        # the normalisation runs in float32 on added rows in both packages
        np.testing.assert_allclose(added, ref_added, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(grown.points, whole.points, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(added, ref_added)
        if case != "int8":  # a one-shot int8 build sets its grid from all rows
            assert torch.equal(grown.points, whole.points)


@pytest.mark.parametrize("chunked", [True, False, None])
def test_search_accepts_chunked_and_ignores_it(built, chunked):
    X, Y, jidx, tidx, rows = built
    got = tann.search(tidx, T(X), T(Y), chunked=chunked)
    assert_match(got, jann.search(jidx, jnp.asarray(X), jnp.asarray(Y), chunked=chunked), rows)
    assert same(got, tann.search(tidx, T(X), T(Y)))
    got = tann.search(tidx, T(Y), chunked=chunked, n_probes=3)
    assert_match(got, jann.search(jidx, jnp.asarray(Y), chunked=chunked, n_probes=3), rows)
    assert same(got, tann.search(tidx, T(Y), n_probes=3))


@pytest.mark.parametrize("factor", [1.0, 1.5])
def test_exact_int8_server_takes_a_per_call_scale(factor):
    """An int8 exact ``Server.search(q, scale=s)`` once raised ``TypeError``
    (a duplicate ``scale``); the JAX ``Server`` keeps its scale in
    ``_search_kw``, so a per-call one overrides it.  Both packages on the
    same corpus and grid, the stored scale and 1.5x it."""
    rng = np.random.default_rng(11)
    X = rng.standard_normal((500, 16)).astype(np.float32)
    Y = rng.standard_normal((20, 16)).astype(np.float32)
    jsrv = jann.Server.build(jnp.asarray(X), K, mode="exact", storage_dtype=jnp.int8)
    srv = tann.Server.build(T(X), K, mode="exact", storage_dtype=torch.int8)
    js = float(jsrv._search_kw["scale"])
    assert srv.scale == pytest.approx(js, rel=1e-6)
    srv.scale = js  # one grid for both packages
    assert torch.equal(srv.points, T(np.asarray(jsrv.points)))
    s = js * factor
    got = srv.search(T(Y), scale=s)
    assert_match(got, jsrv.search(jnp.asarray(Y), scale=jnp.float32(s)))
    if factor == 1.0:
        assert same(got, srv.search(T(Y)))
    else:  # the call's scale, not the stored one, reached the engine
        assert not torch.equal(got[1], srv.search(T(Y))[1])
