"""The rescan-merge and streaming exact kernels' plain PyTorch versions
(``ops/exact.py``) against the JAX package's ``exact_knn_pallas(merge=
"rescan")`` and ``exact_knn_pallas(stream=True)`` run in interpret mode, as
tests/test_pallas.py runs them, at that file's shapes; ``compute_dtype``
on an f32 corpus for all three merges (the rank kernel takes norms of the
rounded corpus, the other two of the unrounded one); and the routing of
the merge/stream/compute_dtype knobs through ``exact_search``,
``exact_knn_self`` and ``Server`` (their route is in
tests/test_torch_routing.py's table).  The CUDA kernels are held against these
plain versions on a card by the ``cuda``-marked test in
tests/test_torch_exact.py.

Ids are equal position by position, except where the two ids lie at
float64 distances within 1e-5 relative (a near-tie the summation orders
may break either way).  Distances: rtol 1e-5 / atol 1e-5 for f32 (the
streaming kernel's association included), rtol 1e-4 for bf16 and int8.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import approximatenn_tpu_torch as tann
from approximatenn_tpu_torch.ops import exact as ex

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def assert_same(ti, td, ji, jd, pts64, q64, rtol, atol=1e-5):
    """Port (ti, td) against JAX (ji, jd): ids equal outside float64
    near-ties, distances within the tolerance, (n, +inf) in the same
    places."""
    ti, td, ji, jd = ti.numpy(), td.numpy(), np.asarray(ji), np.asarray(jd)
    n = pts64.shape[0]
    assert ti.dtype == np.int32 and td.dtype == np.float32 and ti.shape == ji.shape
    for r, c in zip(*np.nonzero(ti != ji)):
        a, b = int(ti[r, c]), int(ji[r, c])
        assert a < n and b < n, (r, c, a, b)
        da = ((pts64[a] - q64[r]) ** 2).sum()
        db = ((pts64[b] - q64[r]) ** 2).sum()
        assert abs(da - db) <= 1e-5 * max(da, db), (r, c, a, b, da, db)
    np.testing.assert_allclose(td, jd, rtol=rtol, atol=atol)


CASES = {
    # name: (n, d, m, k, corpus, self-exclusion, tile, query_block); the
    # shapes of tests/test_pallas.py::TestExactKNNStreaming
    "f32_700x33": (700, 33, 57, 7, "f32", False, 256, 16),
    "f32_768x16": (768, 16, 33, 5, "f32", False, 512, 16),
    "self_300x6": (300, 6, 300, 4, "f32", True, 128, 32),
    "bf16_500x32": (500, 32, 24, 10, "bf16", False, 128, 8),
    "int8_500x32": (500, 32, 24, 10, "int8", False, 128, 8),
    "k_gt_n_5x4": (5, 4, 3, 8, "f32", False, 128, 8),
}
PLAIN = {"rescan": ex.exact_knn_rescan_plain, "stream": ex.exact_knn_stream_plain}
JAX_KW = {"rescan": {"merge": "rescan"}, "stream": {"stream": True}}


def inputs(rng, n, d, m, corpus, self_excl):
    """(numpy corpus, numpy queries, JAX corpus, port corpus, JAX scale,
    port scale, float64 corpus and queries as the kernels rank them)."""
    import jax.numpy as jnp

    from approximatenn_tpu.ops.pallas_exact import quantize_corpus as j_quantize

    p = rng.standard_normal((n, d)).astype(np.float32)
    q = p[:m].copy() if self_excl else rng.standard_normal((m, d)).astype(np.float32)
    jp, tpts, jscale, scale = jnp.asarray(p), T(p), None, None
    p64, q64 = p.astype(np.float64), q.astype(np.float64)
    if corpus == "bf16":
        jp, tpts = jp.astype(jnp.bfloat16), tpts.to(torch.bfloat16)
        p64 = tpts.double().numpy()
        q64 = T(q).to(torch.bfloat16).double().numpy()
    elif corpus == "int8":
        jp, jscale = j_quantize(jp)
        tpts, scale = ex.quantize_corpus(tpts)
        np.testing.assert_array_equal(tpts.numpy(), np.asarray(jp))
        s = float(scale)
        p64 = tpts.double().numpy() * s
        q64 = np.clip(np.round(q / s), -127, 127).astype(np.float64) * s
    return q, jp, tpts, jscale, scale, p64, q64


@pytest.mark.parametrize("kernel", ["rescan", "stream"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(rng, case, kernel):
    import jax.numpy as jnp

    from approximatenn_tpu.ops.pallas_exact import exact_knn_pallas

    n, d, m, k, corpus, self_excl, tile, qb = CASES[case]
    q, jp, tpts, jscale, scale, p64, q64 = inputs(rng, n, d, m, corpus, self_excl)
    e = np.arange(m, dtype=np.int32) if self_excl else None
    ji, jd = exact_knn_pallas(jp, jnp.asarray(q), k, tile=tile, query_block=qb,
                              interpret=True, scale=jscale,
                              exclude=None if e is None else jnp.asarray(e),
                              **JAX_KW[kernel])
    ti, td = PLAIN[kernel](tpts, T(q), k, tile=tile, scale=scale,
                           exclude=None if e is None else T(e))
    assert_same(ti, td, ji, jd, p64, q64, rtol=1e-5 if corpus == "f32" else 1e-4)
    if self_excl:
        assert not (ti.numpy() == np.arange(m)[:, None]).any()
    if n < k:
        assert (ti[:, n:] == n).all() and torch.isinf(td[:, n:]).all()


@pytest.mark.parametrize("merge", ["rank", "rescan", "stream"])
def test_compute_dtype_bf16_matches_pallas_interpret(rng, merge):
    """bf16 compute on an f32 corpus: the corpus and queries round to bf16
    for the product, |q|^2 stays float32; the rank kernel's norms are those
    of the rounded corpus, the rescan merge's and the stream's those of the
    unrounded one, so the three distances differ."""
    import jax.numpy as jnp

    from approximatenn_tpu.ops.pallas_exact import exact_knn_pallas

    n, d, m, k, tile = 700, 33, 57, 7, 256
    p = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((m, d)).astype(np.float32)
    jkw = {"merge": merge} if merge != "stream" else {"stream": True}
    ji, jd = exact_knn_pallas(jnp.asarray(p), jnp.asarray(q), k, tile=tile, query_block=16,
                              interpret=True, compute_dtype=jnp.bfloat16, **jkw)
    if merge == "rank":
        ti, td = ex.exact_knn_plain(T(p), T(q), k, compute_dtype=torch.bfloat16)
    else:
        ti, td = PLAIN[merge](T(p), T(q), k, tile=tile, compute_dtype=torch.bfloat16)
    p64 = T(p).to(torch.bfloat16).double().numpy()
    q64 = T(q).to(torch.bfloat16).double().numpy()
    assert_same(ti, td, ji, jd, p64, q64, rtol=1e-4)
    # the norm source: rank's distances are not the other two's
    _, rank_d = ex.exact_knn_plain(T(p), T(q), k, compute_dtype=torch.bfloat16)
    _, f32_d = PLAIN["rescan"](T(p), T(q), k, tile=tile)
    assert not np.allclose(td.numpy(), f32_d.numpy(), rtol=1e-6, atol=0)
    assert merge == "rank" or not np.allclose(td.numpy(), rank_d.numpy(), rtol=1e-6, atol=0)


def test_exact_knn_on_cpu_runs_the_plain_versions(rng):
    p = T(rng.standard_normal((900, 12)).astype(np.float32))
    q = T(rng.standard_normal((20, 12)).astype(np.float32))
    before = dict(ex.launches)
    for kw, plain in (({"merge": "rescan"}, ex.exact_knn_rescan_plain),
                      ({"stream": True}, ex.exact_knn_stream_plain),
                      ({"stream": True, "merge": "rescan"}, ex.exact_knn_stream_plain),
                      ({"compute_dtype": torch.float16}, ex.exact_knn_plain)):
        a = ex.exact_knn(p, q, 6, **kw)
        b = plain(p, q, 6, compute_dtype=kw.get("compute_dtype"))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), kw
    assert ex.launches == before  # no kernel ran
    # many tiles, a partial last one, or one tile past n: the same neighbours
    ref_i, ref_d = ex.exact_knn_stream_plain(p, q, 6)
    for tile in (64, 100, 1000):
        for plain in PLAIN.values():
            ids, dd = plain(p, q, 6, tile=tile)
            assert torch.equal(ids, ref_i)
            np.testing.assert_allclose(dd.numpy(), ref_d.numpy(), rtol=1e-5, atol=1e-5)
    ids_self, _ = ex.exact_knn_self(p, 5, merge="rescan")
    assert not (ids_self == torch.arange(900)[:, None]).any()
    s8, scale = ex.quantize_corpus(p)
    a = ex.exact_knn(s8, q, 6, scale=scale, merge="rescan")
    b = ex.exact_knn(s8, q, 6, scale=scale, merge="rescan", compute_dtype=torch.bfloat16)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])  # int8 ignores the knob


def test_knob_checks():
    p = torch.zeros((10, 4))
    q = torch.zeros((2, 4))
    for kw in ({"tile": 256}, {"query_block": 8}, {"interpret": True}):
        for fn in (lambda: ex.exact_knn(p, q, 3, **kw), lambda: ex.exact_knn_self(p, 3, **kw),
                   lambda: ex.exact_search(p, q, 3, **kw),
                   lambda: tann.Server.build(p, 3).search(q, **kw)):
            with pytest.raises(ValueError, match="TPU"):
                fn()
    ex.exact_knn(p, q, 3, interpret=None)  # a knob given as None is unset
    with pytest.raises(TypeError):
        ex.exact_knn(p, q, 3, bogus=1)
    for cdt in (torch.float64, torch.int8, "bf16"):
        with pytest.raises(ValueError, match="compute_dtype"):
            ex.exact_knn(p, q, 3, compute_dtype=cdt)
    assert ex.stream_dtype(torch.int8, torch.bfloat16) == torch.int8
    assert ex.stream_dtype(torch.bfloat16) == torch.bfloat16
    assert ex.stream_dtype(torch.float64) == torch.float32
    assert ex.stream_dtype(torch.bfloat16, torch.float32) == torch.float32


def test_server_describes_the_pinned_kernel(rng):
    X = T(rng.standard_normal((3000, 16)).astype(np.float32))
    Y = T(rng.standard_normal((9, 16)).astype(np.float32))
    srv = tann.Server.build(X, 10, twophase_min_n=1000)
    assert srv.describe(merge="rescan")["exact_engine"] == "oracle"  # a CPU corpus
    # on the CPU a pinned search runs the float oracle
    oi, od = tann.brute_force_knn(X, Y, 10)
    for kw in ({"merge": "rescan"}, {"stream": True}, {"compute_dtype": torch.bfloat16}):
        ti, td = srv.search(Y, **kw)
        assert torch.equal(ti, oi) and torch.equal(td, od)
    # the CUDA branches read only the corpus's device, shape and type
    on_card = SimpleNamespace(device=torch.device("cuda"), shape=X.shape, dtype=torch.float32,
                              element_size=lambda: 4)
    card = dataclasses.replace(srv, points=on_card)
    for kw, engine, cdt in (({}, "cuda-twophase", None),
                            ({"no_twophase": True}, "cuda-rank", "float32"),
                            ({"merge": "rescan"}, "cuda-rescan", "float32"),
                            ({"stream": True, "merge": "rescan"}, "cuda-stream", "float32"),
                            ({"compute_dtype": torch.bfloat16}, "cuda-rank", "bfloat16"),
                            ({"merge": "rescan", "compute_dtype": torch.float16}, "cuda-rescan",
                             "float16"),
                            ({"merge": "twophase"}, "cuda-segment-merge", None)):
        d = card.describe(**kw)
        assert d["exact_engine"] == engine and d.get("compute_dtype") == cdt, (kw, d)
    assert card.exact_engine() == "cuda-twophase"


def _tf32_ranking(terms: int):
    """Top-10 ids of 50 queries over a 2,000 x 128 float32 corpus with the
    dot products summed from ``split_tf32`` factors (1 term: hi*hi; 3 terms:
    lo*hi + hi*lo + hi*hi, as the streaming kernel's float32 path), ranked
    as the stream ranks (qn - (2 q.x - pn)), beside the float64 oracle."""
    from approximatenn_tpu_torch.harness.scoring import ids_agree

    rng = np.random.default_rng(11)
    # a common offset of 1 makes the dot products large beside the gaps
    # between neighbours' distances, as in a corpus that is not centred
    X = T(rng.standard_normal((2000, 128)).astype(np.float32) + np.float32(1))
    Y = T(rng.standard_normal((50, 128)).astype(np.float32) + np.float32(1))
    (xh, xl), (yh, yl) = ex.split_tf32(X), ex.split_tf32(Y)
    dots = yh @ xh.T
    if terms == 3:
        dots = (yl @ xh.T + yh @ xl.T) + dots
    dd = (Y * Y).sum(-1)[:, None] - (2.0 * dots - (X * X).sum(-1)[None, :])
    ids = torch.sort(dd, dim=1, stable=True).indices[:, :10].int()
    d64 = ((X.double()[None] - Y.double()[:, None]) ** 2).sum(-1)
    v64, i64 = torch.sort(d64, dim=1, stable=True)
    ok, _ = ids_agree(ids, i64[:, :10].int(), v64[:, :11].float(), rtol=1e-5)
    err = (dots.double() - Y.double() @ X.double().T).abs().max().item()
    return ok, err


def test_split_tf32_halves_are_tf32_and_sum_to_x():
    rng = np.random.default_rng(3)
    x = T((rng.standard_normal(4096) * 10.0 ** rng.integers(-3, 4, 4096)).astype(np.float32))
    hi, lo = ex.split_tf32(x)
    for part in (hi, lo):
        assert part.dtype == torch.float32
        assert not bool((part.view(torch.int32) & 0x1FFF).any())  # 10 mantissa bits
    assert bool(((hi - x).abs() <= x.abs() * 2.0 ** -11).all())  # rounded to nearest
    assert bool(((hi.double() + lo.double() - x.double()).abs() <= x.abs() * 2.0 ** -22).all())
    # ties round away from zero, as cvt.rna does: 1 + 2^-11 lies halfway
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert ex.split_tf32(tie)[0].tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


def test_three_tf32_terms_rank_as_float64_and_one_term_does_not():
    ok3, err3 = _tf32_ranking(3)
    ok1, err1 = _tf32_ranking(1)
    assert ok3 and err3 < 5e-4  # float32 summation error at |q.x| ~ 128
    assert not ok1 and err1 > 20 * err3
