"""Index updates and packed ``Server`` updates against the JAX package on
the CPU: the cases of tests/test_updates.py run through both packages on
one JAX-built index carried across with ``ANNIndex.load``.

Tolerance: the bucket tables, counts, tombstone masks and the new rows'
graph are equal (same codes, the same stable append, exact graph rows from
the float32 oracle in both); searches compare ids equal outside near-ties
(rtol 1e-5) and distances at rtol 1e-5 / atol 1e-5 on queries whose bucket
codes agree in every table.

JAX is imported only inside the tests and fixtures that use it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import approximatenn_tpu_torch as tann
from approximatenn_tpu_torch.harness.scoring import ids_agree
from approximatenn_tpu_torch.index import ANNIndex
from approximatenn_tpu_torch.ops.hash import query_codes

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def assert_search_match(jidx, tidx, Y, a, b):
    import jax.numpy as jnp

    from approximatenn_tpu.ops.hash import query_codes as j_query_codes

    jc, _ = j_query_codes(jidx.row_means, jidx.bases, jnp.asarray(Y))
    tc, _ = query_codes(tidx.row_means, tidx.bases, T(Y))
    rows = torch.from_numpy((tc.numpy() == np.asarray(jc)).all(1))
    assert rows.float().mean() >= 0.9
    ia, da = a[0][rows], a[1][rows]
    ib, db = T(b[0])[rows], T(b[1])[rows]
    ok, _ = ids_agree(ia, ib, db, rtol=1e-5)
    assert ok, (ia, ib)
    fin = torch.isfinite(db)
    assert torch.equal(fin, torch.isfinite(da))
    np.testing.assert_allclose(da[fin].numpy(), db[fin].numpy(), rtol=1e-5, atol=1e-5)


def carry(jidx, tmp_path):
    jidx.save(str(tmp_path / "idx.npz"))
    return ANNIndex.load(str(tmp_path / "idx.npz"), device="cpu")


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    import jax.numpy as jnp

    import approximatenn_tpu as jann

    rng = np.random.default_rng(5)
    X = rng.standard_normal((2000, 16)).astype(np.float32)
    jidx, _, _ = jann.build(jnp.asarray(X), 5, tries=4, seed=1, store_points=True)
    return X, jidx, carry(jidx, tmp_path_factory.mktemp("u"))


def assert_same_index(t, j):
    assert (t.n, t.k, t.tmax) == (j.n, j.k, j.tmax)
    np.testing.assert_array_equal(t.tables.numpy(), np.asarray(j.tables))
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_array_equal(t.graph.numpy(), np.asarray(j.graph))
    if j.dead is None:
        assert t.dead is None
    else:
        np.testing.assert_array_equal(t.dead.numpy(), np.asarray(j.dead))
    np.testing.assert_array_equal(t.points.numpy(), np.asarray(j.points))


def test_add_points_matches_jax_and_finds_new_points(base):
    import jax.numpy as jnp

    import approximatenn_tpu as jann

    X, jidx, tidx = base
    Y = np.random.default_rng(11).standard_normal((20, 16)).astype(np.float32)
    j2, t2 = jidx.add_points(jnp.asarray(Y)), tidx.add_points(T(Y))
    assert t2.n == tidx.n + 20 and tidx.n == 2000  # the original is untouched
    assert_same_index(t2, j2)
    ids, dd = tann.search(t2, queries=T(Y))
    want = tidx.n + torch.arange(20, dtype=torch.int32)
    hit = ids[:, 0] == want
    assert hit.float().mean() > 0.9
    assert torch.allclose(dd[hit, 0], torch.zeros(()), atol=1e-5)
    assert_search_match(j2, t2, Y, (ids, dd), jann.search(j2, queries=jnp.asarray(Y)))


def test_add_points_graph_rows_exact(base):
    X, _, tidx = base
    Y = np.random.default_rng(12).standard_normal((8, 16)).astype(np.float32)
    t2 = tidx.add_points(T(Y))
    allp = np.concatenate([X, Y])
    for i in range(8):
        d2 = ((allp - Y[i]) ** 2).sum(1)
        d2[tidx.n + i] = np.inf  # self
        assert set(t2.graph[tidx.n + i].tolist()) == set(np.argsort(d2)[:5].tolist())


@pytest.mark.parametrize("repair", [True, False])
def test_reverse_edge_repair_matches_jax(base, repair):
    import jax.numpy as jnp

    X, jidx, tidx = base
    targets = np.arange(0, 40, 2)
    Y = X[targets] + 1e-4  # each new point sits on an old one
    j2 = jidx.add_points(jnp.asarray(Y), repair_reverse_edges=repair)
    t2 = tidx.add_points(T(Y), repair_reverse_edges=repair)
    assert_same_index(t2, j2)
    g_old = t2.graph[: tidx.n]
    new_ids = tidx.n + torch.arange(len(targets))
    if repair:  # the old point's nearest neighbour is now the new point
        assert all(int(new_ids[i]) in g_old[targets[i]].tolist()
                   for i in range(len(targets)))
    else:  # old rows are stale by design
        assert not ((g_old >= tidx.n) & (g_old < t2.n)).any()


def test_remove_points_durable_through_repack_and_add(base):
    import jax.numpy as jnp

    import approximatenn_tpu as jann

    X, jidx, tidx = base
    q = X[:16]
    ids0, _ = tann.search(tidx, queries=T(q))
    victims = np.union1d(np.unique(ids0[:, 0].numpy()), np.arange(100, 150))
    j2, t2 = jidx.remove_points(jnp.asarray(victims)), tidx.remove_points(T(victims))
    assert_same_index(t2, j2)
    bad = set(victims.tolist())
    ids1, _ = tann.search(t2, queries=T(q))
    assert not set(ids1.flatten().tolist()) & bad and int(ids1.max()) <= tidx.n
    for dt in (None, torch.int8):
        pv = t2.packed(dtype=dt)
        assert pv.n_live == tidx.n - len(victims)
        for fn in (tann.search_packed, tann.search_packed_fused):
            ids_p, dd_p = fn(pv, queries=T(q))
            assert not set(ids_p.flatten().tolist()) & bad
            assert torch.isfinite(dd_p).all()
    # new points placed at removed points: the dead rows must not come back
    # through the new rows' graph or a search
    Y = X[victims[:10]] + 1e-4
    j3, t3 = j2.add_points(jnp.asarray(Y)), t2.add_points(T(Y))
    assert_same_index(t3, j3)
    assert not set(t3.graph[t2.n:].flatten().tolist()) & bad
    ids3, dd3 = tann.search(t3, queries=T(Y))
    assert not set(ids3.flatten().tolist()) & bad
    assert_search_match(j3, t3, Y, (ids3, dd3), jann.search(j3, queries=jnp.asarray(Y)))


def test_bulk_add_overflow_drops_only_in_the_full_table(tmp_path):
    import jax.numpy as jnp

    import approximatenn_tpu as jann

    rng = np.random.default_rng(7)
    X = rng.standard_normal((400, 8)).astype(np.float32)
    jidx, _, _ = jann.build(jnp.asarray(X), 4, tries=3, seed=2, store_points=True,
                            capacity=4)
    tidx = carry(jidx, tmp_path)
    Y = rng.standard_normal((200, 8)).astype(np.float32)
    j2, t2 = jidx.add_points(jnp.asarray(Y)), tidx.add_points(T(Y))
    assert_same_index(t2, j2)
    assert (t2.counts > t2.tmax).any()  # overflow happened
    assert ((t2.tables <= t2.n) & (t2.tables >= 0)).all()
    ids, _ = tann.search(t2, queries=T(Y))
    hit = (ids == 400 + torch.arange(200)[:, None]).any(1)
    assert hit.float().mean() > 0.8


def test_with_depth_drop_tables_memory(base):
    _, jidx, tidx = base
    for depth in (1, 3, 10**6):
        t, j = tidx.with_depth(depth), jidx.with_depth(depth)
        assert t.tmax == j.tmax
        np.testing.assert_array_equal(t.tables.numpy(), np.asarray(j.tables))
    with pytest.raises(ValueError):
        tidx.with_depth(0)
    td, jd = tidx.drop_tables(), jidx.drop_tables()
    assert td.tables is None and td.counts is None
    for ragged in (True, False):
        assert tidx.memory_bytes(ragged) == jidx.memory_bytes(ragged)
        assert td.memory_bytes(ragged) == jd.memory_bytes(ragged)
    pv = td.packed()  # the packed view needs no tables
    assert pv.n == tidx.n
    for bad in (lambda: td.add_points(np.zeros((1, 16), np.float32)),
                lambda: td.remove_points([0]), td.par_maxes,
                lambda: td.save("unused.npz")):
        with pytest.raises(ValueError, match="drop"):
            bad()


def test_add_points_requires_points(base):
    X, _, tidx = base
    bare = dataclasses.replace(tidx, points=None)
    with pytest.raises(ValueError):
        bare.add_points(T(X[:2]))
    assert bare.add_points(T(X[:2]) + 100.0, points=T(X)).n == 2002


def test_packed_server_updates_match_jax(base):
    """``Server(mode="hash", layout="packed")``: add and remove re-pack the
    view at its window and row type; searches match the JAX Server."""
    import jax.numpy as jnp

    import approximatenn_tpu as jann

    X, jidx, tidx = base
    Y = np.random.default_rng(13).standard_normal((12, 16)).astype(np.float32)
    for jdt, tdt in ((None, None), (jnp.int8, torch.int8)):
        jsrv = jann.Server(points=jnp.asarray(X), k=5, mode="hash", index=jidx,
                           packed=jidx.packed(window=16, dtype=jdt))
        tsrv = tann.Server(points=T(X), k=5, mode="hash", index=tidx,
                           packed=tidx.packed(window=16, dtype=tdt))
        jsrv.add_points(jnp.asarray(Y)).remove_points(jnp.asarray([3, 4, 2005]))
        tsrv.add_points(T(Y)).remove_points([3, 4, 2005])
        assert tsrv.packed.window == 16
        assert tsrv.packed.point_rows.dtype == (tdt or torch.float32)
        assert tsrv.packed.n == 2012 and tsrv.packed.n_live == 2009
        assert tsrv.describe()["layout"] == "packed" and tsrv.describe()["n"] == 2012
        assert_same_index(tsrv.index, jsrv.index)
        a = tsrv.search(T(Y))
        assert_search_match(jsrv.index, tsrv.index, Y, a, jsrv.search(jnp.asarray(Y)))
        assert not {3, 4, 2005} & set(a[0].flatten().tolist())


def test_exact_server_updates_match_jax(rng):
    """Exact mode: add converts to the stored tier, remove compacts; an id
    outside [0, n) raises here, where the JAX Server tombstones its last row
    instead (engine/serving.py:417-444, a known fault of the reference), so
    that case is not compared with it."""
    import jax.numpy as jnp

    import approximatenn_tpu as jann

    X = rng.standard_normal((500, 12)).astype(np.float32)
    Y = rng.standard_normal((6, 12)).astype(np.float32)
    for sdt in (None, "int8"):
        jsrv = jann.Server.build(jnp.asarray(X), 5, storage_dtype=sdt and jnp.int8)
        tsrv = tann.Server.build(T(X), 5, storage_dtype=sdt and torch.int8)
        jsrv.add_points(jnp.asarray(Y)).remove_points(np.array([0, 7, 7, 501]))
        tsrv.add_points(T(Y)).remove_points([0, 7, 7, 501])
        np.testing.assert_array_equal(tsrv.points.numpy(), np.asarray(jsrv.points))
        ji, jd = jsrv.search(jnp.asarray(Y))
        ti, td = tsrv.search(T(Y))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
        for bad in ([503], [-1]):
            with pytest.raises(ValueError, match=r"\[0, 503\)"):
                tsrv.remove_points(bad)
        assert tsrv.points.shape[0] == 503
