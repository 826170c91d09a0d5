"""The port's two-phase exact engine (``ops/twophase.py``) against the JAX
package's ``exact_knn_pallas(merge="twophase")`` and ``exact_knn_twophase``
(Pallas in interpret mode, as tests/test_pallas.py runs them) and the float
oracle, on the CPU where the plain versions of the emit and rescan kernels
run; plus ``Server``'s routing predicate (the decision table of every
entry point is tests/test_torch_routing.py).  The kernels
themselves are held against the plain versions on a card by the
``cuda``-marked test in tests/test_torch_exact.py, and the rescan's row
scorer and split grid by this file's ``cuda``-marked tests:

    python -m pytest --noconftest tests/test_torch_twophase.py -m cuda -q

JAX is imported only inside the tests that compare with it.
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import approximatenn_tpu_torch as tann
from approximatenn_tpu_torch.harness.scoring import ids_agree
from approximatenn_tpu_torch.ops import exact as ex
from approximatenn_tpu_torch.ops import twophase as tp

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def test_segment_merge_matches_pallas_interpret(rng):
    """Phases 1 + 2 (one candidate per segment) at the shape of
    tests/test_pallas.py::test_twophase_merge_matches_reference_semantics."""
    import jax.numpy as jnp

    from approximatenn_tpu.ops.pallas_exact import exact_knn_pallas

    n, d, m, k, seg = 4096, 32, 24, 5, 64
    p = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((m, d)).astype(np.float32)
    ji, jdd = exact_knn_pallas(jnp.asarray(p), jnp.asarray(q), k, tile=512,
                               query_block=8, interpret=True, merge="twophase",
                               twophase_seg=seg)
    ti, tdd = ex.exact_knn(T(p), T(q), k, merge="twophase", twophase_seg=seg)
    assert ti.dtype == torch.int32 and tdd.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tdd.numpy(), np.asarray(jdd), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_twophase_matches_jax_interpret_and_oracle(rng, dt):
    """The exact engine at the shape of tests/test_pallas.py::
    test_twophase_exact_engine_matches_oracle (n = 4099: a partial last
    segment)."""
    import jax.numpy as jnp

    from approximatenn_tpu.ops.pallas_exact import exact_knn_twophase as j_twophase
    from approximatenn_tpu.ops.pallas_exact import quantize_corpus as j_quantize

    n, d, m, k, seg = 4099, 32, 30, 8, 64
    p = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((m, d)).astype(np.float32)
    jp, tpts, jscale, scale = jnp.asarray(p), T(p), None, None
    oracle_p, oracle_q = T(p), T(q)
    if dt == "bf16":
        jp, tpts = jp.astype(jnp.bfloat16), tpts.to(torch.bfloat16)
        oracle_p = tpts.float()
        oracle_q = T(q).to(torch.bfloat16).float()
    elif dt == "int8":
        jp, jscale = j_quantize(jp)
        tpts, scale = ex.quantize_corpus(tpts)
        oracle_p = tpts.float() * scale
        oracle_q = torch.clamp(torch.round(T(q) / scale), -127, 127) * scale
    ji, jdd = j_twophase(jp, jnp.asarray(q), k, seg=seg, scale=jscale,
                         interpret=True)
    ti, tdd = tp.exact_knn_twophase(tpts, T(q), k, seg=seg, scale=scale)
    oi, _ = tann.brute_force_knn(oracle_p.double(), oracle_q.double(), k)
    assert ti.dtype == torch.int32 and tdd.dtype == torch.float32
    np.testing.assert_array_equal(np.sort(ti.numpy(), 1), np.sort(np.asarray(ji), 1))
    np.testing.assert_array_equal(np.sort(ti.numpy(), 1), np.sort(oi.numpy(), 1))
    tol = 1e-5 if dt == "f32" else 1e-3
    np.testing.assert_allclose(tdd.numpy(), np.asarray(jdd), rtol=tol, atol=1e-4)
    assert (np.diff(tdd.numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize("rescan", ["dma", "xla"])
def test_big_k_emit_all_matches_oracle(rng, rescan):
    """k > 128: the rescan returns every window row and the final top-k
    runs in PyTorch (the shape of tests/test_pallas.py::
    test_twophase_bigk_matches_oracle, checked against the oracle because
    that JAX test is slow in interpret mode)."""
    n, d, m, k, seg = 3001, 17, 9, 150, 16
    p = T(rng.standard_normal((n, d)).astype(np.float32))
    q = T(rng.standard_normal((m, d)).astype(np.float32))
    ti, tdd = tp.exact_knn_twophase(p, q, k, seg=seg, rescan=rescan)
    oi, od = tann.brute_force_knn(p.double(), q.double(), k)
    assert ti.shape == (m, k)
    np.testing.assert_array_equal(np.sort(ti.numpy(), 1), np.sort(oi.numpy(), 1))
    np.testing.assert_allclose(tdd.numpy(), od.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [1_000, 250_000, 1_000_000, 10_000_000])
def test_auto_seg_is_the_jax_formula(n):
    # ops/pallas_exact.py:exact_knn_twophase, seg=None (f32 align 8 never binds)
    want = max(min(512, max(32, 1 << (math.isqrt(n) // 8).bit_length())), 8)
    assert tp.auto_seg(n) == want
    assert tp.auto_seg(n) & (tp.auto_seg(n) - 1) == 0


@pytest.mark.parametrize("m, n, seg, want", [
    (10_000, 10_000_000, 512, 10_000),  # the Deep-10M batch: one block
    (10_000, 250_000_000, 512, 1_024),  # a Deep-1B shard: 128-query units
    (7, 2**40, 8, 1),                   # not one unit fits: one query
    (0, 1_000, 32, 1),
])
def test_query_block(m, n, seg, want):
    assert tp.query_block(m, -(-n // seg)) == want


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_query_blocks_equal_one_block(monkeypatch, dt):
    """The engine in several query blocks (the pair budget forced small;
    the last block partial) returns the single block's answers bit for
    bit, and counts one engine call."""
    g = torch.Generator().manual_seed(8)
    X = torch.randn(3001, 24, generator=g).to(dt)
    Q = torch.randn(300, 24, generator=g)
    one = tp.exact_knn_twophase(X, Q, 10, seg=16)
    monkeypatch.setattr(tp, "BLOCK_PAIRS", -(-3001 // 16) * 128)
    assert tp.query_block(300, -(-3001 // 16)) == 128
    before = ex.launches["twophase_calls"]
    blocked = tp.exact_knn_twophase(X, Q, 10, seg=16)
    assert ex.launches["twophase_calls"] == before + 1
    assert torch.equal(one[0], blocked[0]) and torch.equal(one[1], blocked[1])


def test_segment_minima_plain_semantics(rng):
    """Segments are global and contiguous, the last one partial; the
    excluded id and exhausted picks mask out; ties go to the smaller id."""
    n, d, seg = 203, 8, 32
    p = rng.standard_normal((n, d)).astype(np.float32)
    p[40] = p[33]  # a tie inside segment 1
    q = np.stack([p[33] * 0 + 0.1, p[5]]).astype(np.float32)
    excl = torch.tensor([-1, 5], dtype=torch.int32)
    mins, ids = tp.segment_minima(T(p), T(q), seg, exclude=excl)
    assert mins.shape == (2, 7) and ids.dtype == torch.int32
    score = (p * p).sum(-1)[None] - 2.0 * q @ p.T
    score[1, 5] = np.inf
    for s in range(7):
        blk = score[:, s * seg: (s + 1) * seg]
        np.testing.assert_allclose(mins[:, s].numpy(), blk.min(1), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(ids[:, s].numpy(), s * seg + blk.argmin(1))
    assert int(ids[1, 0]) != 5
    # k beyond the segment count: sentinel picks, then exhausted windows
    si, sd = tp.segment_merge(T(p), T(q), 9, seg)
    assert (si[:, 7:] == n).all() and torch.isinf(sd[:, 7:]).all()
    ti, tdd = tp.exact_knn_twophase(T(p), T(q), 6, seg=128)  # P = 8 > 2 segments
    oi, _ = tann.brute_force_knn(T(p).double(), T(q).double(), 6)
    np.testing.assert_array_equal(np.sort(ti.numpy(), 1), np.sort(oi.numpy(), 1))


EMIT_DESIGNS = [
    # (storage, d, seg, emit kernel)
    (torch.bfloat16, 96, 512, "wgmma"),    # the Deep-10M cell
    (torch.float16, 96, 8, "wgmma"),       # the shortest segment a quad holds
    (torch.bfloat16, 128, 1024, "wgmma"),  # the widest row the ring takes
    (torch.float16, 8, 64, "wgmma"),       # one 16-byte unit a row
    (torch.bfloat16, 40, 32, "wgmma"),     # a K step half past d
    (torch.bfloat16, 96, 4, "tile"),       # seg < 8
    (torch.bfloat16, 33, 512, "tile"),     # odd d: the pitch is no multiple of 16 bytes
    (torch.float16, 100, 128, "tile"),     # d % 8 = 4: the same
    (torch.bfloat16, 136, 512, "tile"),    # past 128 features
    (torch.float16, 2048, 64, "tile"),
    (torch.float32, 96, 512, "tile"),      # float32 at every tier
    (torch.int8, 96, 512, "tile"),
]


@pytest.mark.parametrize("dtype,d,seg,want", EMIT_DESIGNS)
def test_emit_design(dtype, d, seg, want):
    """Which emit kernel a corpus takes (``segment_minima``'s dispatch)."""
    assert tp.emit_design(dtype, d, seg) == want


def _plan_rows(plan, m, n):
    """Per query block, the rows each of its work units covers, as the
    Hopper emit's roles walk them (unit u: query block u % n_qb, split
    u // n_qb; split s covers [s * split_rows, min((s + 1) * split_rows, n)))."""
    n_qb = -(-m // tp.WG_QUERIES)
    assert plan["units"] == n_qb * plan["splits"]
    cover = {qb: [] for qb in range(n_qb)}
    for u in range(plan["units"]):
        lo = (u // n_qb) * plan["split_rows"]
        cover[u % n_qb].append((lo, min(lo + plan["split_rows"], n)))
    return cover


@pytest.mark.parametrize("seg", [8, 64, 256, 512, 1024])
def test_emit_plan_covers_every_segment_once(seg):
    """Every segment of every query block falls in exactly one work unit, no
    unit is empty and every split starts on a segment and a stage boundary,
    for n a multiple of neither the 256-row stage nor the segment; the
    blocks never outnumber the units; the ring fits the block's shared
    memory at every width the design takes."""
    for n in (1, 1001, 5003, 300_001, 10_000_000 + 3):
        for m in (1, 26, 300, 1037, 10_000):
            plan = tp.emit_plan(m, n, 96, seg, 132)
            assert 1 <= plan["blocks"] <= min(plan["units"], 132)
            for spans in _plan_rows(plan, m, n).values():
                assert all(lo < hi for lo, hi in spans), (n, m, plan)
                assert all(lo % seg == 0 and lo % tp.WG_TILE_ROWS == 0 for lo, _ in spans)
                # the spans tile [0, n) end to end: each segment once
                spans.sort()
                ends = [0] + [hi for _, hi in spans]
                assert [lo for lo, _ in spans] == ends[:-1] and ends[-1] == n, (n, m, plan)
    for d in range(8, tp.WG_MAX_D + 1, 8):
        st = tp.emit_plan(1000, 10**6, d, 512, 132)["stages"]
        assert tp.WG_STAGES[0] <= st <= tp.WG_STAGES[1]
        assert tp.wgmma_smem(st, -(-d // tp.WG_CHUNK)) <= tp.SMEM_MAX
        if st < tp.WG_STAGES[1]:
            assert tp.wgmma_smem(st + 1, -(-d // tp.WG_CHUNK)) > tp.SMEM_MAX


@pytest.mark.parametrize("m", [1, 26, 1000, 10_000])
def test_emit_plan_fills_the_card(m):
    """At the Deep-10M shape (10M x 96, seg 512) on 132 SMs: at m = 10,000
    (the cell's batch) and 1,000 the units keep at least 7/8 of the SMs
    busy over their waves; at m = 1 and 26 (a single query, add_points'
    emit-all block) one query block is cut into one wave of splits that
    still holds 7/8 of the SMs."""
    plan = tp.emit_plan(m, 10_000_000, 96, 512, 132)
    assert plan["busy"] >= 7 / 8, plan
    assert plan["units"] / (-(-plan["units"] // 132) * 132) == plan["busy"]
    if m <= tp.WG_QUERIES:
        assert plan["units"] == plan["splits"] and 7 / 8 * 132 <= plan["units"] <= 132
        assert plan["split_rows"] % 512 == 0
    if m == 10_000:
        assert plan["units"] == 79 * plan["splits"] and plan["stages"] == 4


def test_smallest_orders_by_distance_then_id():
    d = torch.tensor([[1.0, -0.0, 0.0, -2.0, 1.0, float("inf")]])
    ids = torch.tensor([[9, 7, 3, 8, 2, 1]], dtype=torch.int32)
    out_d, out_i = tp.smallest(d, ids, 8)
    assert out_i.tolist() == [[8, 3, 7, 2, 9, 1, 2**31 - 1, 2**31 - 1]]
    assert out_d[0, :5].tolist() == [-2.0, 0.0, 0.0, 1.0, 1.0]
    assert torch.isinf(out_d[0, 5:]).all()


def test_server_route_twophase_predicate(rng):
    X = T(rng.standard_normal((3000, 16)).astype(np.float32))
    srv = tann.Server.build(X, 10, twophase_min_n=1000)
    assert srv.mode == "exact" and srv._twophase and srv.twophase_min_n == 1000
    assert not srv._route_twophase(10)  # a CPU corpus runs the oracle
    assert srv.describe()["exact_engine"] == "oracle"
    assert not tann.Server.build(X, 10)._twophase  # below TWOPHASE_MIN_N
    assert not tann.Server.build(X, 127, twophase_min_n=1000)._twophase
    # the predicate's CUDA branches, no card needed: it reads only the
    # corpus's device and row count
    on_card = SimpleNamespace(device=torch.device("cuda"), shape=X.shape)
    card = dataclasses.replace(srv, points=on_card)
    assert card._route_twophase(10)
    assert not card._route_twophase(10, no_twophase=True)
    assert not card._route_twophase(10, skw={"merge": "rank"})
    assert card._route_twophase(10, skw={"seg": 32, "pad_segments": 3})
    assert not card._route_twophase(127)
    # k > 128 rides the two-phase engine, no_twophase or not (the JAX
    # package drops to brute force here: the no_twophase it forwards fails
    # its big-k keyword gate, engine/serving.py:328, ops/pallas_exact.py:1635)
    assert card._route_twophase(200)
    assert card._route_twophase(200, no_twophase=True)
    assert not card._route_twophase(2990)  # k close to n
    assert card.exact_engine() == "cuda-twophase"
    # a build below its twophase_min_n serves the rank kernel
    below = dataclasses.replace(card, _twophase=False, twophase_min_n=5000)
    assert not below._route_twophase(10)
    assert below.exact_engine() == "cuda-rank"
    assert below._route_twophase(200)
    # the rule the predicate forwards to, with the Server's own threshold
    assert tp.route(3000, 10, {}, min_n=1000) == "twophase"
    assert tp.route(3000, 10, {}, min_n=5000) == "rank"
    assert tp.route(3000, 10, {}, True, min_n=1000) == "rank"


def test_server_big_k_matches_jax(rng):
    """Server exact search at k > 128 on the CPU against the JAX Server.
    Both run the oracle here; on an accelerator the JAX Server reaches it
    only through the reference bug (no_twophase fails exact_search's big-k
    gate, engine/serving.py:328), while the port routes the two-phase
    engine on CUDA (see test_server_route_twophase_predicate)."""
    import jax.numpy as jnp

    import approximatenn_tpu as jann

    X = rng.standard_normal((2000, 12)).astype(np.float32)
    Y = rng.standard_normal((7, 12)).astype(np.float32)
    ji, jdd = jann.Server.build(jnp.asarray(X), 150).search(jnp.asarray(Y))
    srv = tann.Server.build(T(X), 150)
    ti, tdd = srv.search(T(Y), no_twophase=True, seg=16)
    assert srv.describe()["exact_engine"] == "oracle"
    np.testing.assert_array_equal(np.sort(ti.numpy(), 1), np.sort(np.asarray(ji), 1))
    np.testing.assert_allclose(tdd.numpy(), np.asarray(jdd), rtol=1e-5, atol=1e-4)


def test_exact_knn_merge_options():
    p = torch.zeros((10, 4))
    q = torch.zeros((2, 4))
    # the rescan merge and the stream are ported (their plain versions run
    # on the CPU); stream=True takes precedence over merge, as in JAX
    for kw in ({"merge": "rescan"}, {"stream": True}, {"stream": True, "merge": "bogus"}):
        ids, dd = ex.exact_knn(p, q, 3, **kw)
        assert ids.tolist() == [[0, 1, 2]] * 2 and (dd == 0).all()  # ties to the smaller id
        with pytest.raises(ValueError, match="k <= 128"):
            ex.exact_knn(p, q, 129, **kw)
    with pytest.raises(ValueError):
        ex.exact_knn(p, q, 3, merge="bogus")
    with pytest.raises(ValueError):
        tp.exact_knn_twophase(p, q, 3, seg=24)  # not a power of two
    with pytest.raises(ValueError):
        tp.exact_knn_twophase(p, q, 3, rescan="bogus")
    ids, dd = ex.exact_knn(p, q, 200, merge="twophase", twophase_seg=4)  # any k
    assert ids.shape == (2, 200) and (ids[:, 3:] == 10).all()


# -- the rescan kernel on a card ------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _corpus(g, dev, dt, n, d):
    """(rows of type ``dt``, the scale of int8 rows or None)."""
    x = torch.randn(n, d, generator=g).to(dev)
    if dt == "int8":
        return ex.quantize_corpus(x)
    return x.to({"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}[dt]), None


def _starts(g, n, m, P, seg, dev):
    """Per query P window starts: distinct segments in random order, then
    exhausted picks (start n) where P exceeds the segments."""
    n_seg = -(-n // seg)
    st = torch.full((m, P), n, dtype=torch.int32)
    for i in range(m):
        segs = torch.randperm(n_seg, generator=g)[:P]
        st[i, : segs.numel()] = (segs * seg).to(torch.int32)
    return st.to(dev)


def _rescan_on_card(pts, q, starts, seg, k, **kw):
    """One launch of the rescan (``kw``: its geometry and split count)
    against the plain version: emit-all ids equal, selected ids equal
    outside near-ties, distances at rtol 1e-5 / atol 1e-4, (n, +inf) past
    the real rows."""
    key = "twophase_rescan_all" if k is None else "twophase_rescan"
    before = ex.launches[key]
    ia, da = tp.rescan_windows(pts, q, starts, seg, k, **kw)
    assert ex.launches[key] == before + 1
    ib, db = tp.rescan_windows_plain(pts, q, starts, seg, None if k is None else min(k + 1, 128))
    torch.cuda.synchronize()
    ia, da, ib, db = ia.cpu(), da.cpu(), ib.cpu(), db.cpu()
    if k is None:
        assert torch.equal(ia, ib), kw
    else:
        ok, _ = ids_agree(ia, ib[:, :k], db, rtol=1e-5)
        assert ok, kw
        db, ib = db[:, :k], ib[:, :k]
        assert bool((ia[~torch.isfinite(da)] == pts.shape[0]).all())
    fin = torch.isfinite(db)
    assert torch.equal(fin, torch.isfinite(da)), kw
    np.testing.assert_allclose(da[fin].numpy(), db[fin].numpy(), rtol=1e-5, atol=1e-4)
    return ia


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16", "int8"])
def test_rescan_rows_of_any_width_on_card(dt):
    """Rows whose bytes are no multiple of 16 (d = 33: 4-byte f32, 2-byte
    bf16/f16 and 1-byte int8 loads), d = 96 and d = 300 (rows read in
    several passes), selecting and emit-all, one split and several."""
    dev = _card()
    g = torch.Generator().manual_seed(4)
    for d in (33, 96, 300):
        pts, scale = _corpus(g, dev, dt, 5003, d)
        q, _, _ = ex._prepare(pts, torch.randn(40, d, generator=g).to(dev), scale)
        starts = _starts(g, 5003, 40, 14, 64, dev)
        for k, splits in ((10, None), (10, 5), (128, 3), (None, None), (None, 7)):
            _rescan_on_card(pts, q, starts, 64, k, n_splits=splits)


@pytest.mark.cuda
def test_rescan_split_grid_on_card():
    """The split grid: emit-all at add_points' block of 26 queries with P x
    seg past n (n = 100,003, seg = 128, P = 1,000 windows over 782
    segments), the rule's split count and 32; k = 1 and 128 with several
    splits merged; one query."""
    dev = _card()
    g = torch.Generator().manual_seed(5)
    n, seg = 100_003, 128
    pts, _ = _corpus(g, dev, "f32", n, 128)
    q = torch.randn(26, 128, generator=g).to(dev)
    starts = _starts(g, n, 26, 1000, seg, dev)
    assert int((starts == n).sum()) == 26 * (1000 - 782)
    for splits in (None, 32):
        _rescan_on_card(pts, q, starts, seg, None, n_splits=splits)
    for k in (1, 128):
        for splits in (None, 2, 17, 32):
            _rescan_on_card(pts, q, starts[:, :40].contiguous(), seg, k, n_splits=splits)
    for k, splits in ((10, None), (10, 12), (None, 32)):
        _rescan_on_card(pts, q[:1].contiguous(), starts[:1, :40].contiguous(), seg, k,
                        n_splits=splits)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_rescan_every_geometry_on_card(dt):
    """Every launch geometry the kernel takes: lane groups of 4 to 32
    lanes (one or several passes a row), selecting and emit-all, one split
    and several."""
    dev = _card()
    g = torch.Generator().manual_seed(6)
    pts, scale = _corpus(g, dev, dt, 3001, 128)
    q, _, _ = ex._prepare(pts, torch.randn(30, 128, generator=g).to(dev), scale)
    starts = _starts(g, 3001, 30, 12, 32, dev)
    size = pts.element_size()
    for lanes in (4, 8, 16, 32):
        geom = ex.gather_geometry(128, size, lanes=lanes)
        for k, splits in ((10, 1), (10, 4), (None, 3)):
            _rescan_on_card(pts, q, starts, 32, k, geometry=geom, n_splits=splits)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rescan_nan_and_inf_rows_on_card(dt):
    """Rows holding a NaN or an infinite coordinate score NaN or +inf: the
    kernel runs through them, never selects them, writes their NaN or
    +inf where emit-all asks for every row, and equals the plain version
    (more finite rows than k in every query's windows)."""
    dev = _card()
    g = torch.Generator().manual_seed(7)
    x = torch.randn(4000, 96, generator=g)
    bad = torch.randperm(4000, generator=g)[:120]
    x[bad[:40], 3] = float("nan")
    x[bad[40:80]] = float("inf")
    x[bad[80:], 0] = -float("inf")
    pts = x.to(dev, {"f32": torch.float32, "bf16": torch.bfloat16}[dt])
    q = torch.randn(50, 96, generator=g).to(dev)
    starts = _starts(g, 4000, 50, 10, 64, dev)
    for k, splits in ((10, None), (10, 4), (128, 2)):
        ids = _rescan_on_card(pts, q, starts, 64, k, n_splits=splits)
        assert not torch.isin(ids, bad.to(ids.dtype)).any(), (k, splits)
    _rescan_on_card(pts, q, starts, 64, None, n_splits=5)


@pytest.mark.cuda
def test_query_blocks_on_card(monkeypatch):
    """On the card (the Hopper emit, bf16): the engine in query blocks of
    128 equals the single block bit for bit and launches the emit once a
    block."""
    dev = _card()
    g = torch.Generator().manual_seed(9)
    X = torch.randn(300_001, 96, generator=g).to(dev, torch.bfloat16)
    Q = torch.randn(1037, 96, generator=g).to(dev)
    one = tp.exact_knn_twophase(X, Q, 10)
    monkeypatch.setattr(tp, "BLOCK_PAIRS", -(-300_001 // tp.auto_seg(300_001)) * 128)
    before = dict(ex.launches)
    blocked = tp.exact_knn_twophase(X, Q, 10)
    torch.cuda.synchronize()
    assert ex.launches["twophase_emit"] - before["twophase_emit"] == 9
    assert ex.launches["twophase_calls"] - before["twophase_calls"] == 1
    assert torch.equal(one[0], blocked[0]) and torch.equal(one[1], blocked[1])


@pytest.mark.cuda
def test_engine_past_2_31_elements_on_card():
    """A bf16 corpus of 24M x 96 rows, 2.3e9 elements (past 2**31, 4.6 GB):
    the emit, the segment pick and the rescan against their plain
    versions, on queries whose own rows lie before and past the 2**31-th
    element, and the engine returning each query's own row first."""
    dev = _card()
    n, d, seg, k = 24_000_000, 96, 512, 10
    assert n * d > 2**31
    g = torch.Generator(device=dev).manual_seed(31)
    pts = torch.randn((n, d), generator=g, device=dev, dtype=torch.bfloat16)
    own = torch.tensor([5, 2**31 // d - 1, 2**31 // d + 1, 23_000_017, n - 1], device=dev)
    q = pts[own].float() + 0.01 * torch.randn((own.numel(), d), generator=g, device=dev)
    # emit: every (query, segment) minimum against the plain version
    va, ia = tp.segment_minima(pts, q, seg)
    vb, ib = tp.segment_minima_plain(pts, q, seg)
    torch.cuda.synchronize()
    np.testing.assert_allclose(va.cpu().numpy(), vb.cpu().numpy(), rtol=1e-5, atol=1e-3)
    differ = torch.nonzero(ia != ib).tolist()
    qk = q.to(torch.bfloat16).double()
    for r, sg in differ[:50]:  # only where two rows of a segment near-tie
        sa = (pts[ia[r, sg]].double() - qk[r]).pow(2).sum()
        sb = (pts[ib[r, sg]].double() - qk[r]).pow(2).sum()
        assert abs(float(sa - sb)) <= 1e-4 * abs(float(sb)) + 1e-3
    assert torch.equal(ia[torch.arange(own.numel()), own // seg], own.int())
    # the pick: the own row's segment first, the picked minima as the plain pick's
    P = k + 2
    sel, sd = tp.segment_merge(pts, q, P, seg)
    _, qn, _ = ex._prepare(pts, q, None)
    pd, pi = tp.smallest(vb + qn[:, None], ib, P)
    assert torch.equal(sel[:, 0], own.int())
    np.testing.assert_allclose(sd.cpu().numpy(), pd.cpu().numpy(), rtol=1e-5, atol=1e-3)
    # the rescan over the picked windows, past 2**31 elements too
    starts = (sel // seg * seg).int()
    _rescan_on_card(pts, q, starts, seg, k)
    ids, dd = tp.exact_knn_twophase(pts, q, k)
    want = (pts[own].double() - qk).pow(2).sum(1)
    assert torch.equal(ids[:, 0], own.int())
    np.testing.assert_allclose(dd[:, 0].cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-6)
