"""The port's packed serving slice against the JAX package on the CPU:
``pack_tables``, the synthetic generators, ``ANNIndex.packed`` on a
JAX-built index carried across, ``PackedIndex`` persistence both ways,
``search_packed``, ``search_packed_fused`` (its probe stage on the plain
version, against the JAX fused path with the Pallas kernel in interpret
mode) and packed ``Server`` routing.

Tolerance: ids equal outside near-ties (adjacent reference distances
within rtol 1e-5) and distances at rtol 1e-5 / atol 1e-5, float32 in both
(the frameworks sum in other orders).  Hash codes come from one float32
projection in each framework, so a projection within rounding of zero may
take either sign: packed layouts are compared on the tables whose codes all
agree, searches on the queries whose codes all agree (>= 99.5% of codes
must agree).  bf16 rows are compared bit for bit (both round to nearest
even); the JAX plain path computes bf16 differences in bf16
(engine/search.py:261-266) and is only compared in float32 here.

JAX is imported only inside the tests and fixtures that use it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import approximatenn_tpu_torch as tann
from approximatenn_tpu_torch.data import synthetic
from approximatenn_tpu_torch.engine import serving as tserving
from approximatenn_tpu_torch.harness.scoring import ids_agree
from approximatenn_tpu_torch.index import ANNIndex, PackedIndex
from approximatenn_tpu_torch.ops import exact as ex
from approximatenn_tpu_torch.ops.buckets import pack_tables
from approximatenn_tpu_torch.ops.hash import query_codes

torch.set_num_threads(1)

N, D, K, TRIES, M = 2000, 24, 8, 4, 8


def T(a):
    return torch.from_numpy(np.array(a))


def assert_match(ia, da, ib, db):
    ia, da, ib, db = (x.cpu() if isinstance(x, torch.Tensor) else T(x)
                      for x in (ia, da, ib, db))
    ok, _ = ids_agree(ia, ib, db, rtol=1e-5)
    assert ok, (ia, ib)
    fin = torch.isfinite(db)
    assert torch.equal(fin, torch.isfinite(da))
    np.testing.assert_allclose(da[fin].numpy(), db[fin].numpy(), rtol=1e-5, atol=1e-5)


def code_rows(jidx, tidx, Y):
    """Queries whose bucket codes agree in every table, both frameworks."""
    import jax.numpy as jnp

    from approximatenn_tpu.ops.hash import query_codes as j_query_codes

    jc, _ = j_query_codes(jidx.row_means, jidx.bases, jnp.asarray(Y))
    tc, _ = query_codes(tidx.row_means, tidx.bases, T(Y))
    same = tc.numpy() == np.asarray(jc)
    assert same.mean() >= 0.995
    return same.all(1)


def jax_view_arrays(jpv) -> dict:
    """A JAX packed view's leaves as the numpy arrays
    ``PackedIndex.from_numpy`` carries (bf16 leaves stay ml_dtypes arrays)."""
    a = dict(point_rows=np.asarray(jpv.point_rows),
             row_dtype=np.array(str(jpv.point_rows.dtype)),
             ids=np.asarray(jpv.ids), starts=np.asarray(jpv.starts),
             graph=np.asarray(jpv.graph),
             meta=np.array([jpv.n, jpv.k, jpv.d, jpv.d_short, jpv.tries, jpv.window,
                            jpv.super_width, jpv.d_pad, jpv.n_live]),
             metric=np.array(jpv.metric), row_means=np.asarray(jpv.row_means),
             bases=np.asarray(jpv.bases))
    if jpv.points is not None:
        a["points"] = np.asarray(jpv.points)
    if jpv.scale is not None:
        a["scale"] = np.asarray(jpv.scale)
    return a


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    import jax.numpy as jnp

    import approximatenn_tpu as jann

    rng = np.random.default_rng(2024)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Y = rng.standard_normal((40, D)).astype(np.float32)
    jidx, _, _ = jann.build(jnp.asarray(X), K, tries=TRIES, seed=3, store_points=True)
    path = str(tmp_path_factory.mktemp("idx") / "j.npz")
    jidx.save(path)
    return X, Y, jidx, ANNIndex.load(path, device="cpu")


@pytest.fixture(scope="module")
def views(built):
    """The JAX f32 and int8 views and the port's copies through from_numpy."""
    import jax.numpy as jnp

    X, Y, jidx, _ = built
    out = {}
    for name, dt in (("f32", None), ("int8", jnp.int8)):
        jpv = jidx.packed(dtype=dt)
        out[name] = (jpv, PackedIndex.from_numpy(jax_view_arrays(jpv), device="cpu"))
    return out


def test_pack_tables_matches_jax(rng):
    import jax.numpy as jnp

    from approximatenn_tpu.ops.buckets import pack_tables as j_pack_tables

    nb = 16
    codes = rng.integers(0, nb, (3, 500)).astype(np.int32)  # many duplicate codes
    codes[1, ::7] = nb  # past-the-end codes (relocated tombstones)
    jo, js = j_pack_tables(jnp.asarray(codes), nb)
    to, ts = pack_tables(T(codes), nb)
    assert to.dtype == torch.int32 and ts.dtype == torch.int32
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_synthetic_generators_match_jax():
    from approximatenn_tpu.data import synthetic as j_synthetic

    for fn, kw in (("gaussian", {}), ("clustered_gaussian", {"n_clusters": 50})):
        a = getattr(synthetic, fn)(np.random.default_rng(9), 3000, 16, **kw)
        b = getattr(j_synthetic, fn)(np.random.default_rng(9), 3000, 16, **kw)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


PACK_CASES = ["f32", "bf16", "int8", "staged_bf16", "tombstones", "tombstones_int8"]


@pytest.mark.parametrize("case", PACK_CASES)
def test_packed_view_matches_jax(built, case):
    import jax.numpy as jnp

    from approximatenn_tpu.index import stage_points as j_stage_points
    from approximatenn_tpu.ops.hash import query_codes as j_query_codes

    X, _, jidx, tidx = built
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "int8": (jnp.int8, torch.int8),
                "tombstones_int8": (jnp.int8, torch.int8)}.get(case, (None, None))
    if case.startswith("tombstones"):
        dead = np.r_[0:40, 1500:1530]
        jidx, tidx = jidx.remove_points(jnp.asarray(dead)), tidx.remove_points(T(dead))
        np.testing.assert_array_equal(tidx.dead.numpy(), np.asarray(jidx.dead))
    if case == "staged_bf16":
        jpv = jidx.packed(j_stage_points(jnp.asarray(X), jnp.bfloat16), staged=True)
        tpv = tidx.packed(tann.stage_points(T(X), torch.bfloat16), staged=True)
        assert tpv.points.shape == (N + 1, D) and torch.isinf(tpv.points[N]).all()
    else:
        jpv, tpv = jidx.packed(dtype=jdt), tidx.packed(dtype=tdt)
    assert (tpv.n, tpv.n_pad, tpv.n_live, tpv.live_bound, tpv.window) == (
        jpv.n, jpv.n_rows * jpv.super_width, jpv.n_live, jpv.live_bound, jpv.window)
    assert tpv.point_rows.shape == (TRIES * tpv.n_pad, D)
    if case.endswith("int8"):
        assert tpv.n_pad % 32 == 0 and float(tpv.scale) == float(jpv.scale)
    jc, _ = j_query_codes(jidx.row_means, jidx.bases, jnp.asarray(X))
    tc, _ = query_codes(tidx.row_means, tidx.bases, T(X))
    same = tc.numpy() == np.asarray(jc)
    assert same.mean() >= 0.995
    tables = np.nonzero(same.all(0))[0]
    assert len(tables) >= TRIES - 1
    jrows = np.asarray(jpv.point_rows.astype(jnp.float32) if case in ("bf16", "staged_bf16")
                       else jpv.point_rows)[:, :D]
    trows = tpv.point_rows.float() if tpv.point_rows.dtype == torch.bfloat16 else tpv.point_rows
    for t in tables:
        np.testing.assert_array_equal(tpv.ids[t].numpy(), np.asarray(jpv.ids[t]))
        np.testing.assert_array_equal(tpv.starts[t].numpy(), np.asarray(jpv.starts[t]))
        sl = slice(t * tpv.n_pad, (t + 1) * tpv.n_pad)
        live = slice(t * tpv.n_pad, t * tpv.n_pad + tpv.live_bound)
        np.testing.assert_array_equal(trows[live].numpy(), jrows[live])
        assert torch.equal(torch.isinf(trows[sl]).any(1), T(np.isinf(jrows[sl]).any(1)))
    if case.startswith("tombstones"):
        assert tpv.n_live == N - 70
        assert not np.isin(tpv.ids[:, : tpv.n_live].numpy(), dead).any()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_packed_save_load_both_ways(built, tmp_path, dt):
    import jax.numpy as jnp

    from approximatenn_tpu.index import PackedIndex as JPackedIndex

    _, _, jidx, tidx = built
    jdt, tdt = (None, None) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    # the port's view -> npz -> the JAX loader: rows are d wide (d_pad 0)
    tpv = tidx.packed(dtype=tdt, window=20)
    tpv.save(str(tmp_path / "t.npz"))
    jl = JPackedIndex.load(str(tmp_path / "t.npz"))
    assert jl.lane_dim == D and jl.point_rows.dtype == (jdt or jnp.float32)
    assert (jl.n, jl.window, jl.n_live, jl.n_rows * jl.super_width) == (
        tpv.n, 20, tpv.n_live, tpv.n_pad)
    np.testing.assert_array_equal(np.asarray(jl.point_rows.astype(jnp.float32)),
                                  tpv.point_rows.float().numpy())
    np.testing.assert_array_equal(np.asarray(jl.ids), tpv.ids.numpy())
    np.testing.assert_array_equal(np.asarray(jl.points), tpv.points.numpy())
    # the JAX view (rows lane-padded to 128) -> npz -> the port: pad lanes go
    jpv = jidx.packed(dtype=jdt)
    jpv.save(str(tmp_path / "j.npz"))
    tl = PackedIndex.load(str(tmp_path / "j.npz"), device="cpu")
    assert jpv.lane_dim == 128 and tl.point_rows.shape == (TRIES * tl.n_pad, D)
    assert tl.point_rows.dtype == (tdt or torch.float32)
    np.testing.assert_array_equal(tl.point_rows.float().numpy(),
                                  np.asarray(jpv.point_rows.astype(jnp.float32))[:, :D])
    np.testing.assert_array_equal(tl.starts.numpy(), np.asarray(jpv.starts))
    assert tl.memory_bytes() < jpv.memory_bytes()  # no pad lanes


SEARCH_CASES = {
    # name: (index metric, search_packed keywords, window override)
    "f32_blind": ("l2", {}, None),
    "f32_directed_rerank": ("l2", {"n_probes": 5, "rerank_width": 16}, None),
    "window_override": ("l2", {"n_probes": 5}, 6),
    "angular": ("angular", {"n_probes": 5, "supercharge_rounds": 2}, None),
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_search_packed_matches_jax(built, case, tmp_path):
    import jax.numpy as jnp

    import approximatenn_tpu as jann

    X, Y, jidx, tidx = built
    metric, kw, window = SEARCH_CASES[case]
    if metric != "l2":
        jidx, _, _ = jann.build(jnp.asarray(X), K, tries=TRIES, seed=5, metric=metric,
                                store_points=True)
        jidx.save(str(tmp_path / "a.npz"))
        tidx = ANNIndex.load(str(tmp_path / "a.npz"), device="cpu")
    jpv, tpv = jidx.packed(), tidx.packed()
    if window is not None:
        jpv, tpv = jpv.with_window(window), tpv.with_window(window)
        assert tpv.rows_per_probe() == jpv.rows_per_probe() < jpv.rows_per_probe(24)
    ji, jd = jann.search_packed(jpv, queries=jnp.asarray(Y), **kw)
    ti, td = tann.search_packed(tpv, queries=T(Y), **kw)
    assert ti.shape == (len(Y), K) and ti.dtype == torch.int32
    rows = code_rows(jidx, tidx, Y if metric == "l2" else
                     (Y / np.linalg.norm(Y, axis=1, keepdims=True)).astype(np.float32))
    assert_match(ti[rows], td[rows], np.asarray(ji)[rows], np.asarray(jd)[rows])
    # the block size bounds a transient only
    tb, _ = tann.search_packed(tpv, queries=T(Y), block_rows=7, **kw)
    assert torch.equal(tb, ti)


FUSED_CASES = {
    # name: (view, search_packed_fused keywords)
    "blind": ("f32", {}),
    "directed": ("f32", {"n_probes": 4}),
    "rerank_width": ("f32", {"n_probes": 4, "rerank_width": 16, "window": 40}),
    "supercharge_0": ("f32", {"n_probes": 4, "supercharge_rounds": 0}),
    "supercharge_2": ("f32", {"n_probes": 4, "supercharge_rounds": 2}),
    "int8_rescore": ("int8", {"n_probes": 4}),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_search_packed_fused_matches_jax_interpret(built, views, case):
    import jax.numpy as jnp

    import approximatenn_tpu as jann

    X, Y, jidx, tidx = built
    name, kw = FUSED_CASES[case]
    jpv, tpv = views[name]
    Yq = Y[:M]
    ji, jd = jann.search_packed_fused(jpv, queries=jnp.asarray(Yq), interpret=True, **kw)
    before = ex.launches["probe_topk"]
    ti, td = tann.search_packed_fused(tpv, queries=T(Yq), **kw)
    assert ex.launches["probe_topk"] == before  # a CPU view: the plain version
    assert ti.shape == (M, K) and ti.dtype == torch.int32
    rows = code_rows(jidx, tidx, Yq)
    assert_match(ti[rows], td[rows], np.asarray(ji)[rows], np.asarray(jd)[rows])
    if name == "int8":  # re-scored against the float corpus: true distances
        fin = ti < N
        d2 = ((T(X)[ti.clamp(max=N - 1).long()] - T(Yq)[:, None]) ** 2).sum(-1)
        np.testing.assert_allclose(td[fin].numpy(), d2[fin].numpy(), rtol=1e-5, atol=1e-5)


def test_fused_takes_no_tpu_knobs(views):
    _, tpv = views["f32"]
    with pytest.raises(TypeError):
        tann.search_packed_fused(tpv, torch.zeros((2, D)), query_block=8)
    with pytest.raises(TypeError):
        tann.search_packed_fused(tpv, torch.zeros((2, D)), interpret=True)
    with pytest.raises(ValueError, match="does not store points"):
        tann.search_packed_fused(dataclasses.replace(tpv, points=None), torch.zeros((2, D)))


def test_packed_route_matches_jax():
    from approximatenn_tpu.engine import serving as jserving

    assert tserving.FUSED_MIN_BATCH == jserving.FUSED_MIN_BATCH == 0
    name = {"fused": "fused", "xla": "plain"}
    for n, batch, card, thr in ((10**6, 1, True, None), (10**6, 1000, False, None),
                                (3000, 7, True, 8), (3000, 8, True, 8),
                                (3000, 500, False, 8)):
        assert tserving.fused_min_batch(n) == jserving.fused_min_batch(n)
        assert tserving.packed_route(n, batch, card, thr) == name[
            jserving.packed_route(n, batch, card, thr)]


def test_packed_server_on_cpu_matches_jax(built, views):
    """A CPU view routes to the plain path, as the JAX package does off the
    TPU; ``window`` reaches it; the TPU knobs raise."""
    import jax.numpy as jnp

    import approximatenn_tpu as jann

    X, Y, jidx, tidx = built
    jpv, tpv = views["f32"]
    jsrv = jann.Server(points=jnp.asarray(X), k=K, mode="hash", index=jidx, packed=jpv)
    tsrv = tann.Server(points=T(X), k=K, mode="hash", index=tidx, packed=tpv,
                       fused_min_batch=0)
    jd_, td_ = jsrv.describe(), tsrv.describe()
    for key in ("mode", "n", "d", "k", "layout"):
        assert td_[key] == jd_[key], key
    assert td_["index_mb"] == round(tpv.memory_bytes() / 2**20, 1)
    rows = code_rows(jidx, tidx, Y)
    before = ex.launches["probe_topk"]
    for kw in ({}, {"n_probes": 5, "window": 10}, {"block_rows": 4}):
        ji, jd = jsrv.search(jnp.asarray(Y), **kw)
        ti, td = tsrv.search(T(Y), **kw)
        assert_match(ti[rows], td[rows], np.asarray(ji)[rows], np.asarray(jd)[rows])
    pi, _ = tann.search_packed(tpv.with_window(10), queries=T(Y), n_probes=5)
    assert torch.equal(tsrv.search(T(Y), n_probes=5, window=10)[0], pi)
    assert ex.launches["probe_topk"] == before
    for knob in ("query_block", "interpret", "pos_mode"):
        with pytest.raises(ValueError, match=knob):
            tsrv.search(T(Y), **{knob: 8})
    tsrv.search(T(Y), interpret=None)  # a forwarded unset knob is no pin


def test_packed_server_build_and_route(built, monkeypatch):
    """``Server.build(layout="packed")`` builds the view at the window and
    row type asked; on a (faked) CUDA view ``packed_route`` picks the probe
    kernel from ``fused_min_batch`` queries unless ``block_rows`` pins the
    plain path."""
    import approximatenn_tpu_torch.engine.search as tsearch

    X, Y, _, _ = built
    srv = tann.Server.build(T(X), K, mode="hash", layout="packed", window=12,
                            packed_dtype=torch.bfloat16, tries=2, seed=1)
    assert srv.packed.window == 12 and srv.packed.point_rows.dtype == torch.bfloat16
    d = srv.describe()
    assert d["layout"] == "packed" and d["index_mb"] == round(
        srv.packed.memory_bytes() / 2**20, 1)
    ids, dd = srv.search(T(Y[:5]))
    assert ids.shape == (5, K) and torch.isfinite(dd).all()
    with pytest.raises(ValueError, match="layout"):
        tann.Server.build(T(X), K, mode="hash", layout="bogus")

    calls = []
    monkeypatch.setattr(tsearch, "search_packed_fused",
                        lambda pv, **kw: calls.append(("fused", kw)))
    monkeypatch.setattr(tsearch, "search_packed",
                        lambda pv, **kw: calls.append(("plain", kw)))
    monkeypatch.setattr(PackedIndex, "device", property(lambda self: torch.device("cuda")))
    card = dataclasses.replace(srv, fused_min_batch=4)
    card.search(T(Y[:4]), window=9)
    card.search(T(Y[:3]))
    card.search(T(Y[:4]), block_rows=2)
    assert [c[0] for c in calls] == ["fused", "plain", "plain"]
    assert calls[0][1]["window"] == 9
