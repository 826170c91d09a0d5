"""The ``matmul_precision`` tiers of the four tensor-core exact kernels
(rank, rescan merge, stream, two-phase emit) against the JAX package, on
the CPU; the CUDA kernels at each tier against their plain versions on a
card (``cuda`` marker; skipped without one).

* "split3": the port's plain versions against ``exact_knn_pallas(...,
  interpret=True, matmul_precision="split3")`` and the JAX
  ``exact_knn_twophase`` at tests/test_pallas.py's split3 shape (800 x 48,
  m = 40, k = 10, tile 256, query block 16): ids equal, distances within
  rtol 1e-5 / atol 1e-5 (only the order of the float32 sums differs), and
  ids equal to the float64 oracle's, as the JAX test requires.
* "default": JAX's interpret mode computes ``Precision.DEFAULT`` in float32
  on the CPU, so the TPU's meaning is built here with
  ``jax.lax.dot_general`` of the bf16-rounded factors (float32
  accumulation) and float32 norms, and the port's plain "default" is held
  to it within rtol 1e-6 (the products are exact in float32; the norms and
  sums are float32 in both, in other orders).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_precision.py -q
"""

import numpy as np
import pytest
import torch

from approximatenn_tpu_torch.harness.scoring import ids_agree
from approximatenn_tpu_torch.ops import exact as ex
from approximatenn_tpu_torch.ops import twophase as tp

torch.set_num_threads(1)

# tests/test_pallas.py::test_split3_matches_f64_oracle's shape
N, D, M, K, TILE, QB = 800, 48, 40, 10, 256, 16
SEG = 64
PLAIN = {"rank": ex.exact_knn_plain, "rescan": ex.exact_knn_rescan_plain,
         "stream": ex.exact_knn_stream_plain}
JAX_KW = {"rank": {}, "rescan": {"merge": "rescan"}, "stream": {"stream": True}}


def T(a):
    return torch.from_numpy(np.array(a))


def data(rng):
    p = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((M, D)).astype(np.float32)
    return p, q


def oracle_ids(p, q, k):
    d64 = ((q[:, None, :].astype(np.float64) - p[None].astype(np.float64)) ** 2).sum(-1)
    return np.argsort(d64, 1, kind="stable")[:, :k]


def test_split_bf16_and_dot_split3_match_jax():
    """The bf16 factors bit for bit (both round to nearest even), the sum
    within 2^-20 sum|a||b| of ``_dot_split3``'s (other summation order), on
    values whose exponents span 10^-3 .. 10^3."""
    import jax
    import jax.numpy as jnp

    from approximatenn_tpu.ops.pallas_exact import _dot_split3

    rng = np.random.default_rng(7)

    def draw(*shape):
        return (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3, shape)).astype(np.float32)

    a, b = draw(37, 65), draw(29, 65)
    for x in (a, b):
        jh = jnp.asarray(x).astype(jnp.bfloat16)
        jl = (jnp.asarray(x) - jh.astype(jnp.float32)).astype(jnp.bfloat16)
        th, tl = ex.split_bf16(T(x))
        assert th.dtype == tl.dtype == torch.bfloat16
        np.testing.assert_array_equal(th.view(torch.int16).numpy(),
                                      np.asarray(jh).view(np.int16))
        np.testing.assert_array_equal(tl.view(torch.int16).numpy(),
                                      np.asarray(jl).view(np.int16))
    jd = np.asarray(_dot_split3(jnp.asarray(a), jnp.asarray(b), (((1,), (1,)), ((), ()))))
    td = ex.dot_split3(T(a), T(b)).numpy()
    mag = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64).T
    assert (np.abs(td.astype(np.float64) - jd) <= 2.0 ** -20 * mag).all()
    # and the dispatch: dist_dot picks each tier's product
    assert torch.equal(ex.dist_dot(T(a), T(b), "split3"), ex.dot_split3(T(a), T(b)))
    assert torch.equal(ex.dist_dot(T(a), T(b), "highest"), T(a) @ T(b).T)
    del jax


@pytest.mark.parametrize("kernel", ["rank", "rescan", "stream"])
def test_split3_plain_matches_pallas_interpret(rng, kernel):
    import jax.numpy as jnp

    from approximatenn_tpu.ops.pallas_exact import exact_knn_pallas

    p, q = data(rng)
    ji, jd = exact_knn_pallas(jnp.asarray(p), jnp.asarray(q), K, tile=TILE, query_block=QB,
                              interpret=True, matmul_precision="split3", **JAX_KW[kernel])
    ti, td = PLAIN[kernel](T(p), T(q), K, matmul_precision="split3")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.sort(ti.numpy(), 1), np.sort(oracle_ids(p, q, K), 1))
    # the wrapper on a CPU tensor runs the same plain version
    wi, wd = ex.exact_knn(T(p), T(q), K, matmul_precision="split3", **JAX_KW[kernel])
    assert torch.equal(wi, ti) and torch.equal(wd, td)


def test_split3_segment_merge_matches_pallas_interpret(rng):
    """``exact_knn(merge="twophase")`` (emit + one candidate a segment) at
    split3; the JAX tile is the whole corpus, whose segment grid is then
    the port's contiguous global one."""
    import jax.numpy as jnp

    from approximatenn_tpu.ops.pallas_exact import exact_knn_pallas

    p, q = data(rng)
    ji, jd = exact_knn_pallas(jnp.asarray(p), jnp.asarray(q), K, tile=N, query_block=QB,
                              interpret=True, matmul_precision="split3", merge="twophase",
                              twophase_seg=SEG)
    ti, td = ex.exact_knn(T(p), T(q), K, matmul_precision="split3", merge="twophase",
                          twophase_seg=SEG)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


def test_split3_twophase_engine_matches_jax(rng):
    """``exact_knn_twophase`` at split3 (the tier reaches the emit; the
    rescan is exact float32 at every tier), against JAX's with its gather
    rescan (``rescan="xla"``, the port's plain rescan) and the oracle."""
    import jax.numpy as jnp

    from approximatenn_tpu.ops.pallas_exact import exact_knn_twophase as j_twophase

    p, q = data(rng)
    ji, jd = j_twophase(jnp.asarray(p), jnp.asarray(q), K, seg=SEG, interpret=True,
                        rescan="xla", matmul_precision="split3")
    ti, td = tp.exact_knn_twophase(T(p), T(q), K, seg=SEG, matmul_precision="split3")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.sort(ti.numpy(), 1), np.sort(oracle_ids(p, q, K), 1))


def tpu_default_scores(p, q):
    """(scores pn - 2 q.x (m, n), |q|^2 (m,)) float32 as the TPU computes
    them at ``Precision.DEFAULT``: one MXU pass of the bf16-rounded factors
    with float32 accumulation, float32 norms of the unrounded values."""
    import jax
    import jax.numpy as jnp

    jq, jp = jnp.asarray(q), jnp.asarray(p)
    dots = jax.lax.dot_general(jq.astype(jnp.bfloat16), jp.astype(jnp.bfloat16),
                               (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32)
    pn = jnp.sum(jp * jp, axis=-1)
    qn = jnp.sum(jq * jq, axis=-1)
    return np.asarray(pn[None, :] - 2.0 * dots), np.asarray(qn)


def assert_topk_of(ids, dists, ref, k, rtol=1e-6):
    """``ids``/``dists`` are the k smallest of the reference distance rows
    ``ref`` (m, n): ids equal outside near-ties (adjacent reference
    distances within ``rtol``), each distance within ``rtol`` of the
    reference at its id."""
    order = np.argsort(ref, 1, kind="stable")
    ref_ids = order[:, :k + 1]
    ref_d = np.take_along_axis(ref, ref_ids, 1)
    ok, _ = ids_agree(ids, T(ref_ids[:, :k].astype(np.int32)), T(ref_d.astype(np.float32)),
                      rtol=rtol)
    assert ok
    at = np.take_along_axis(ref, ids.numpy().astype(np.int64), 1)
    np.testing.assert_allclose(dists.numpy(), at, rtol=rtol)


@pytest.mark.parametrize("kernel", ["rank", "rescan", "stream"])
def test_default_plain_is_one_bf16_pass(rng, kernel):
    p, q = data(rng)
    s, qn = tpu_default_scores(p, q)
    ti, td = PLAIN[kernel](T(p), T(q), K, matmul_precision="default")
    assert_topk_of(ti, td, qn[:, None] + s, K)


def test_default_emit_and_twophase_engine_are_one_bf16_pass(rng):
    """Emit's segment minima at "default" are the reference scores'
    per-segment minima; ``exact_knn_twophase`` rescans exactly (float32
    difference form) the k + 2 segments those minima pick."""
    p, q = data(rng)
    s, qn = tpu_default_scores(p, q)
    n_seg = -(-N // SEG)
    pad = np.full((M, n_seg * SEG), np.inf, np.float32)
    pad[:, :N] = s
    blocks = pad.reshape(M, n_seg, SEG)
    ref_min = blocks.min(-1)
    ref_arg = blocks.argmin(-1) + np.arange(n_seg) * SEG
    vals, ids = tp.segment_minima_plain(T(p), T(q), SEG, matmul_precision="default")
    np.testing.assert_allclose((vals + T(qn)[:, None]).numpy(), qn[:, None] + ref_min, rtol=1e-6)
    np.testing.assert_array_equal(ids.numpy(), ref_arg)  # no near-ties here
    # the engine: rows of the k + 2 best segments by those minima, exact
    picks = np.argsort(ref_min, 1, kind="stable")[:, :K + 2]
    d32 = ((q[:, None, :] - p[None]) ** 2).sum(-1)
    mask = np.zeros((M, N), bool)
    for r in range(M):
        for sg in picks[r]:
            mask[r, sg * SEG: (sg + 1) * SEG] = True
    ti, td = tp.exact_knn_twophase(T(p), T(q), K, seg=SEG, matmul_precision="default")
    assert_topk_of(ti, td, np.where(mask, d32, np.inf), K)


def _tier_ranking(tier: str):
    """Top-10 ids of 50 queries over a 2,000 x 128 float32 corpus (offset by
    1, as in tests/test_torch_merge.py's ``_tf32_ranking``: the dot products
    are large beside the gaps between neighbours' distances) with the dot
    products at ``tier``, ranked as the stream ranks (qn - (2 q.x - pn)),
    beside the float64 oracle; and the largest error of a dot product."""
    rng = np.random.default_rng(11)
    X = T(rng.standard_normal((2000, 128)).astype(np.float32) + np.float32(1))
    Y = T(rng.standard_normal((50, 128)).astype(np.float32) + np.float32(1))
    dots = ex.dist_dot(Y, X, tier)
    dd = (Y * Y).sum(-1)[:, None] - (2.0 * dots - (X * X).sum(-1)[None, :])
    ids = torch.sort(dd, dim=1, stable=True).indices[:, :10].int()
    d64 = ((X.double()[None] - Y.double()[:, None]) ** 2).sum(-1)
    v64, i64 = torch.sort(d64, dim=1, stable=True)
    ok, _ = ids_agree(ids, i64[:, :10].int(), v64[:, :11].float(), rtol=1e-5)
    err = (dots.double() - Y.double() @ X.double().T).abs().max().item()
    return ok, err


def test_split3_ranks_as_float64_and_default_does_not():
    ok3, err3 = _tier_ranking("split3")
    ok1, err1 = _tier_ranking("default")
    assert ok3 and err3 < 5e-3  # bf16 hi/lo: ~16 bits a factor at |q.x| ~ 128
    assert not ok1 and err1 > 20 * err3


def test_tiers_apply_to_float32_streams_only(rng):
    """bf16, f16 and int8 streams (stored, or ``compute_dtype``) ignore the
    tier, as the JAX package's ``f32_path``; an unknown tier raises
    ``ValueError`` at every entry point, and no kernel runs on the CPU."""
    assert ex.stream_tier(torch.float32, "split3") == "split3"
    for dt in (torch.bfloat16, torch.float16, torch.int8):
        assert ex.stream_tier(dt, "default") == "highest"
    p, q = data(rng)
    tpts, tq = T(p), T(q)
    before = dict(ex.launches)
    for kernel, plain in PLAIN.items():
        a = plain(tpts.to(torch.bfloat16), tq, K)
        b = plain(tpts.to(torch.bfloat16), tq, K, matmul_precision="default")
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), kernel
        c = plain(tpts, tq, K, compute_dtype=torch.float16)
        e = plain(tpts, tq, K, compute_dtype=torch.float16, matmul_precision="split3")
        assert torch.equal(c[0], e[0]) and torch.equal(c[1], e[1]), kernel
    pq, scale = ex.quantize_corpus(tpts)
    a = tp.segment_minima_plain(pq, tq, SEG, scale=scale)
    b = tp.segment_minima_plain(pq, tq, SEG, scale=scale, matmul_precision="default")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert ex.launches == before
    for fn in (lambda: ex.exact_knn(tpts, tq, K, matmul_precision="high"),
               lambda: ex.exact_knn(tpts, tq, K, stream=True, matmul_precision="high"),
               lambda: ex.exact_knn_plain(tpts, tq, K, matmul_precision="bf16"),
               lambda: tp.segment_minima(tpts, tq, SEG, matmul_precision="HIGHEST"),
               lambda: tp.exact_knn_twophase(tpts, tq, K, matmul_precision=None),
               lambda: ex.exact_search(tpts, tq, K, matmul_precision="fast"),
               lambda: ex.stream_tier(torch.float32, "split6")):
        with pytest.raises(ValueError, match="matmul_precision"):
            fn()


def assert_match(ia, da, ib, db):
    """Kernel (ia, da) against plain (ib, db; db with the k+1-th distance):
    ids equal outside near-ties (1e-5 relative), the same sentinels,
    distances at rtol 1e-5 / atol 1e-4 (float32 sums in other orders)."""
    ok, _ = ids_agree(ia, ib, db, rtol=1e-5)
    assert ok, (ia, ib)
    db = db[:, : ia.shape[1]]
    fin = torch.isfinite(db)
    assert torch.equal(fin, torch.isfinite(da))
    np.testing.assert_allclose(da[fin].numpy(), db[fin].numpy(), rtol=1e-5, atol=1e-4)


def one_hot_rows(n: int, d: int, dev):
    """(corpus (n, d), queries (d, d)) of small integers (see
    tests/test_torch_exact.py): every value is exact in bf16 and its split
    has lo = 0, so every tier's products are exact."""
    r = torch.arange(n, device=dev)
    corpus = torch.zeros((n, d), device=dev)
    corpus[r, r % d] = (1 + r // d).float()
    return corpus, torch.eye(d, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["split3", "default"])
@pytest.mark.parametrize("kernel", ["rank", "rescan_merge", "stream", "emit"])
def test_tier_kernel_matches_plain_on_card(kernel, tier):
    """Each tensor-core kernel at the tier against its plain version at the
    same tier: ids equal outside near-ties and distances at rtol 1e-5 (fp32
    sums of the same exact bf16 products), over d = 96 (an even number of
    K steps), 33 (odd: the last pair's second half is zero registers) and,
    for the tile loop's kernels, 960 (feature chunks); the launch counted
    under the tier's key; one-hot integer rows bit for bit (a fragment
    placed at the wrong k shows); NaN and infinite rows never returned;
    "default" differs from "highest" somewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator().manual_seed(13)
    dev = torch.device("cuda")
    key = {"rank": "exact_knn", "rescan_merge": "exact_knn_rescan",
           "stream": "exact_knn_stream", "emit": "twophase_emit"}[kernel]
    kw = {"rank": {}, "rescan_merge": {"merge": "rescan"}, "stream": {"stream": True}}.get(kernel)
    plain = {"rank": ex.exact_knn_plain, "rescan_merge": ex.exact_knn_rescan_plain,
             "stream": ex.exact_knn_stream_plain}.get(kernel)
    dims = (96, 33) if kernel == "stream" else (96, 33, 960)
    differs = False
    for d in dims:
        p = torch.randn(5003, d, generator=g).to(dev)
        q = torch.randn(300, d, generator=g).to(dev)
        excl = torch.arange(300, dtype=torch.int32, device=dev)
        for k, e in ((10, excl), (128, None)):
            before = dict(ex.launches)
            if kernel == "emit":
                va, ia = tp.segment_minima(p, q, 128, exclude=e, matmul_precision=tier)
                vb, ib = tp.segment_minima_plain(p, q, 128, exclude=e, matmul_precision=tier)
                torch.cuda.synchronize()
                np.testing.assert_allclose(va.cpu().numpy(), vb.cpu().numpy(),
                                           rtol=1e-5, atol=1e-4)
                vh, _ = tp.segment_minima(p, q, 128, exclude=e)
                differs |= not torch.equal(va, vh)
            else:
                ia, da = ex.exact_knn(p, q, k, exclude=e, matmul_precision=tier, **kw)
                ib, db = plain(p, q, k + 1, exclude=e, matmul_precision=tier)
                torch.cuda.synchronize()
                assert_match(ia.cpu(), da.cpu(), ib[:, :k].cpu(), db.cpu())
                ih, _ = ex.exact_knn(p, q, k, exclude=e, **kw)
                differs |= not torch.equal(ia, ih)
            ran = {name: c - before[name] for name, c in ex.launches.items()
                   if c != before[name]}
            want = {key: 2, f"{key}:{tier}": 1}
            # the rank kernel's "highest" call at d = 96, k = 10 (the one
            # beside the tier's, for the comparison) takes the Hopper design
            if kernel == "rank" and ex.rank_design(torch.float32, "highest", d, k,
                                                   q.shape[0]) == "wgmma":
                want["exact_knn:wgmma"] = 1
            assert ran == want, ran
            if kernel == "emit":
                # a 16-bit corpus has no tier: the emit computes what it does
                # at "highest", on the Hopper pipeline at d = 96 (the tile
                # loop at d = 33 and 960), and counts no tier
                for t16 in (torch.bfloat16, torch.float16):
                    p16 = p.to(t16)
                    wgmma = tp.emit_design(t16, d, 128) == "wgmma"
                    assert wgmma == (d == 96)
                    before = dict(ex.launches)
                    v16, i16 = tp.segment_minima(p16, q, 128, exclude=e, matmul_precision=tier)
                    ran = {name: c - before[name] for name, c in ex.launches.items()
                           if c != before[name]}
                    assert ran == ({key: 1, f"{key}:wgmma": 1} if wgmma else {key: 1}), ran
                    vh, ih = tp.segment_minima(p16, q, 128, exclude=e)
                    vp, _ = tp.segment_minima_plain(p16, q, 128, exclude=e,
                                                    matmul_precision=tier)
                    torch.cuda.synchronize()
                    assert torch.equal(v16, vh) and torch.equal(i16, ih)
                    np.testing.assert_allclose(v16.cpu().numpy(), vp.cpu().numpy(),
                                               rtol=1e-5, atol=1e-4)
    # proof that the bf16 path ran: one bf16 pass moves some result (split3
    # ranks as "highest" does outside near-ties)
    assert differs or tier == "split3"
    # one-hot integer rows: every tier's products are exact, so the kernel
    # equals its plain version bit for bit
    for n, d in ((1000, 128), (700, 33)):
        X, qq = one_hot_rows(n, d, dev)
        if kernel == "emit":
            a = tp.segment_minima(X, qq, 128, matmul_precision=tier)
            b = tp.segment_minima_plain(X, qq, 128, matmul_precision=tier)
        elif kernel == "rank":
            a = ex.exact_knn(X, qq, 10, matmul_precision=tier)
            b = ex.exact_knn_plain(X, qq, 10, matmul_precision=tier)
        elif kernel == "stream":
            a = ex.exact_knn(X, qq, 10, stream=True, matmul_precision=tier)
            b = ex.exact_knn_stream_plain(X, qq, 10, tile=128, matmul_precision=tier)
        else:
            a = ex.exact_knn(X, qq, 10, merge="rescan", matmul_precision=tier)
            qb, tn = ex.tile_geometry("rescan_merge_knn")
            s = ex.splits(d, n, torch.cuda.get_device_properties(dev).multi_processor_count,
                          qb, tn)
            b = ex.exact_knn_rescan_plain_by_splits(X, qq, 10, s, tn, matmul_precision=tier)
        torch.cuda.synchronize()
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), (n, d)
    # NaN and infinite coordinates never come back
    X = torch.randn(1000, 96, generator=g)
    X[5, 17] = float("nan")
    X[700] = float("inf")
    X[701, 0] = -float("inf")
    X = X.to(dev)
    qq = torch.randn(37, 96, generator=g).to(dev)
    bad = torch.tensor([5, 700, 701], dtype=torch.int32, device=dev)
    if kernel == "emit":
        ids = tp.exact_knn_twophase(X, qq, 10, matmul_precision=tier)[0]
    else:
        ids = ex.exact_knn(X, qq, 10, matmul_precision=tier, **kw)[0]
    torch.cuda.synchronize()
    assert not torch.isin(ids, bad).any()
    with pytest.raises(ValueError, match="matmul_precision"):
        ex.exact_knn(X, qq, 10, matmul_precision="split2", **(kw or {}))
