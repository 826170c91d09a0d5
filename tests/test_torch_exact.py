"""The exact-kNN kernel's plain PyTorch version against the JAX Pallas
kernel (run in interpret mode, as tests/test_pallas.py runs it) and the
oracles, on the CPU; the CUDA kernels themselves (rank, two-phase emit and
rescan, rescan merge, stream) against their plain versions on a card
(``cuda`` marker; skipped without one).

Ids must be equal outside near-ties (adjacent reference distances within
1e-5 relative); distances agree at rtol=1e-5, atol=1e-4 (different
summation orders of the same float32 score |x|^2 - 2 q.x).

JAX is imported only inside the tests that compare with it, so the card
test also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_exact.py -m cuda -q
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from approximatenn_tpu_torch.harness.scoring import ids_agree, recall_at_k
from approximatenn_tpu_torch.ops import exact as ex
from approximatenn_tpu_torch.ops.distance import brute_force_knn

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def assert_match(ia, da, ib, db, rtol=1e-5, atol=1e-4):
    """``db`` may carry one column more than the ids (the k+1-th reference
    distance, to recognise a near-tie at the boundary)."""
    ia, da, ib, db = (x.cpu() if isinstance(x, torch.Tensor) else T(x)
                      for x in (ia, da, ib, db))
    ok, _ = ids_agree(ia, ib, db, rtol=1e-5)
    assert ok, (ia, ib)
    db = db[:, : ia.shape[1]]
    fin = torch.isfinite(db)
    assert torch.equal(fin, torch.isfinite(da))
    np.testing.assert_allclose(da[fin].numpy(), db[fin].numpy(), rtol=rtol, atol=atol)


CASES = {
    # name: (n, d, m, k, corpus dtype, exclude)
    "f32": (700, 33, 57, 7, "f32", False),
    "bf16": (500, 32, 40, 10, "bf16", False),
    "int8": (600, 24, 40, 10, "int8", False),
    "exclude": (301, 16, 301, 5, "f32", True),
    "k_gt_n": (20, 8, 9, 30, "f32", False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(rng, case):
    import jax.numpy as jnp

    from approximatenn_tpu.ops.pallas_exact import exact_knn_pallas
    from approximatenn_tpu.ops.pallas_exact import quantize_corpus as j_quantize

    n, d, m, k, dt, excl = CASES[case]
    p = rng.standard_normal((n, d)).astype(np.float32)
    q = p[:m].copy() if excl else rng.standard_normal((m, d)).astype(np.float32)
    e = np.arange(m, dtype=np.int32) if excl else None
    jp, tp, scale, jscale = jnp.asarray(p), T(p), None, None
    if dt == "bf16":
        jp, tp = jp.astype(jnp.bfloat16), tp.to(torch.bfloat16)
    elif dt == "int8":
        jp, jscale = j_quantize(jp)
        tp, scale = ex.quantize_corpus(tp)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        assert float(scale) == float(jscale)
    ji, jdd = exact_knn_pallas(jp, jnp.asarray(q), k, tile=128, query_block=16,
                               interpret=True, scale=jscale,
                               exclude=None if e is None else jnp.asarray(e))
    ti, tdd = ex.exact_knn_plain(tp, T(q), k, scale=scale,
                                 exclude=None if e is None else T(e))
    assert ti.dtype == torch.int32 and tdd.dtype == torch.float32
    assert_match(ti, tdd, ji, jdd, rtol=1e-3 if dt == "bf16" else 1e-5)
    if case == "k_gt_n":
        assert (ti[:, n:] == n).all() and torch.isinf(tdd[:, n:]).all()
    if excl:
        assert not (ti.numpy() == np.arange(m)[:, None]).any()


def test_plain_recall_one_vs_float64_oracle(rng):
    p = rng.standard_normal((1500, 48)).astype(np.float32)
    q = rng.standard_normal((64, 48)).astype(np.float32)
    ti, tdd = ex.exact_knn_plain(T(p), T(q), 10)
    dd64 = ((q.astype(np.float64)[:, None, :] - p.astype(np.float64)[None]) ** 2).sum(-1)
    true = np.argsort(dd64, axis=1, kind="stable")[:, :10]
    assert recall_at_k(true, ti.numpy(), 10) == 1.0
    oi, od = brute_force_knn(T(p), T(q), 10)
    assert_match(ti, tdd, oi, od)


def test_exact_knn_wrapper_on_cpu_uses_plain(rng):
    p = T(rng.standard_normal((200, 16)).astype(np.float32))
    q = T(rng.standard_normal((10, 16)).astype(np.float32))
    before = ex.launches["exact_knn"]
    a = ex.exact_knn(p, q, 5)
    b = ex.exact_knn_plain(p, q, 5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert ex.launches["exact_knn"] == before  # no kernel ran
    with pytest.raises(ValueError):
        ex.exact_knn(p, q, 129)
    with pytest.raises(ValueError):
        ex.exact_knn(p, q, 5, matmul_precision="bogus")
    with pytest.raises(TypeError):
        ex.exact_knn(p, q.double(), 5)
    with pytest.raises(ValueError):
        ex.exact_knn(p.to(torch.int8), q, 5)  # int8 needs its scale
    # the tiers: "highest" is the default; split3 ranks as it does outside
    # near-ties; "default" is its own plain result (one bf16 pass)
    assert torch.equal(ex.exact_knn(p, q, 5, matmul_precision="highest")[0], a[0])
    s_ids, s_d = ex.exact_knn(p, q, 5, matmul_precision="split3")
    _, ref_d = ex.exact_knn_plain(p, q, 6)
    assert_match(s_ids, s_d, a[0], ref_d)
    d_ids, d_d = ex.exact_knn(p, q, 5, matmul_precision="default")
    b_ids, b_d = ex.exact_knn_plain(p, q, 5, matmul_precision="default")
    assert torch.equal(d_ids, b_ids) and torch.equal(d_d, b_d)
    assert ex.launches["exact_knn"] == before


@pytest.mark.parametrize("dt", ["f32", "int8", "bf16"])
def test_exact_search_cpu_matches_jax(rng, dt):
    import jax.numpy as jnp

    from approximatenn_tpu.ops.pallas_exact import exact_search as j_exact_search
    from approximatenn_tpu.ops.pallas_exact import quantize_corpus as j_quantize

    p = rng.standard_normal((400, 20)).astype(np.float32)
    q = rng.standard_normal((30, 20)).astype(np.float32)
    kw_j, kw_t = {}, {}
    jp, tp = jnp.asarray(p), T(p)
    if dt == "int8":
        jp, kw_j["scale"] = j_quantize(jp)
        tp, kw_t["scale"] = ex.quantize_corpus(tp)
    elif dt == "bf16":
        # the port ranks a half corpus in float32 on the CPU: the JAX
        # oracle on the same stored values, widened, is the reference
        tp = tp.to(torch.bfloat16)
        jp = jnp.asarray(tp.float().numpy())
    ji, jdd = j_exact_search(jp, jnp.asarray(q), 8, **kw_j)
    ti, tdd = ex.exact_search(tp, T(q), 8, **kw_t)
    assert_match(ti, tdd, ji, jdd, rtol=1e-3 if dt == "bf16" else 1e-5)


@pytest.mark.parametrize("engine", ["exact_search", "exact_knn_twophase"])
def test_exact_entry_points_take_array_likes(rng, engine):
    """numpy corpus and queries with ``device="cpu"`` give what CPU tensors
    give (the JAX twins take any array)."""
    from approximatenn_tpu_torch.ops import twophase as tp

    fn = ex.exact_search if engine == "exact_search" else tp.exact_knn_twophase
    p = rng.standard_normal((600, 12)).astype(np.float32)
    q = rng.standard_normal((9, 12)).astype(np.float32)
    a_ids, a_d = fn(p, q, 7, device="cpu")
    b_ids, b_d = fn(T(p), T(q), 7)
    assert a_ids.device.type == "cpu"
    assert torch.equal(a_ids, b_ids) and torch.equal(a_d, b_d)
    c_ids, _ = fn(T(p), q.astype(np.float64), 7)  # queries follow the corpus as float32
    assert torch.equal(c_ids, b_ids)


def test_exact_entry_points_default_to_the_card(rng):
    """Without a card, numpy inputs and no device raise the
    ``default_device`` error rather than quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    from approximatenn_tpu_torch.ops import twophase as tp

    p = rng.standard_normal((100, 8)).astype(np.float32)
    for fn in (ex.exact_search, tp.exact_knn_twophase):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            fn(p, p[:3], 4)


def test_package_imports_no_jax():
    code = (
        "import sys; before = set(sys.modules)\n"
        "import approximatenn_tpu_torch, approximatenn_tpu_torch.ops.exact\n"
        "import approximatenn_tpu_torch.ops.probe, approximatenn_tpu_torch.data.synthetic\n"
        "new = set(sys.modules) - before\n"
        "bad = [m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'approximatenn_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules and 'approximatenn_tpu' not in sys.modules\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rank", "emit", "rescan", "rescan_merge", "stream"])
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16", "int8"])
def test_kernel_matches_plain_on_card(dt, kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from approximatenn_tpu_torch.ops import twophase as tp

    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    p = torch.randn(5003, 96, generator=g).to(dev)
    q = torch.randn(300, 96, generator=g).to(dev)
    scale = None
    if dt == "bf16":
        p = p.to(torch.bfloat16)
    elif dt == "f16":
        p = p.to(torch.float16)
    elif dt == "int8":
        p, scale = ex.quantize_corpus(p)
    rtol = 1e-3 if dt in ("bf16", "f16") else 1e-5
    excl = torch.arange(300, dtype=torch.int32, device=dev)
    # (k, exclude, compute_dtype); bf16 compute on the f32 corpus
    cases = [(1, None, None), (10, excl, None), (128, None, None)]
    if dt == "f32":
        cases.append((10, excl, torch.bfloat16))
    if kernel in ("rank", "rescan_merge", "stream"):
        key, kw, plain = {
            "rank": ("exact_knn", {}, ex.exact_knn_plain),
            "rescan_merge": ("exact_knn_rescan", {"merge": "rescan"}, ex.exact_knn_rescan_plain),
            "stream": ("exact_knn_stream", {"stream": True}, ex.exact_knn_stream_plain),
        }[kernel]
        runs = [(p, q, cases)]  # (corpus, queries, cases)
        if kernel in ("rank", "rescan_merge"):
            # any d (one feature chunk up to d = 128 in f32, several past
            # it); m = 37 and 1, k = 1 and 128, exclude
            for dd in (33, 256, 960, 2048):
                raw = torch.randn(1001, dd, generator=g).to(dev)
                if dt == "int8":
                    raw = torch.clamp(torch.round(raw / scale), -127, 127)
                qd = torch.randn(37, dd, generator=g).to(dev)
                runs.append((raw.to(p.dtype), qd, [(1, excl[:37], None), (128, None, None)]))
                runs.append((raw.to(p.dtype), qd[:1].contiguous(), [(10, excl[:1], None)]))
        if kernel == "stream":
            # d = 33 rows from an offset view (not 16-byte aligned: the
            # wrapper re-aligns a copy; rows copied in 4-byte units or byte
            # by byte); a partial last tile
            raw = torch.randn(5004, 33, generator=g).to(dev)
            if dt == "int8":
                raw = torch.clamp(torch.round(raw / scale), -127, 127)
            runs.append((raw.to(p.dtype)[1:], q[:, :33].contiguous(), cases))
            # even two 16-row tiles of d = 2000 f32 values overflow shared memory
            with pytest.raises(ValueError, match="shared memory"):
                ex.exact_knn(torch.zeros(300, 2000, device=dev), torch.zeros(2, 2000, device=dev),
                             3, stream=True)
        for pts, qq, kcases in runs:
            for k, e, cdt in kcases:
                before = dict(ex.launches)
                ia, da = ex.exact_knn(pts, qq, k, exclude=e, scale=scale, compute_dtype=cdt, **kw)
                # the rank kernel's float32 calls at d = 96, k <= 64 and
                # m = 300 take the Hopper design; everything else the tile loop
                want = {key: 1}
                if kernel == "rank" and ex.rank_design(ex.stream_dtype(pts.dtype, cdt), "highest",
                                                       pts.shape[1], k, qq.shape[0]) == "wgmma":
                    want["exact_knn:wgmma"] = 1
                assert want.get("exact_knn:wgmma", 0) == (
                    kernel == "rank" and dt == "f32" and cdt is None and pts.shape[1] == 96
                    and k <= 64)
                assert {name: c - before[name] for name, c in ex.launches.items() if c != before[name]} == want
                ib, db = plain(pts, qq, k + 1, exclude=e, scale=scale, compute_dtype=cdt)
                torch.cuda.synchronize()
                assert_match(ia.cpu(), da.cpu(), ib[:, :k].cpu(), db.cpu(),
                             rtol=1e-3 if cdt is not None else rtol)
    elif kernel == "emit":
        # seg 8 (lane groups), 16, 64 (32-row chunks), 128, 256, 512 and 1,024
        # (segments of several tiles; n is a multiple of none of them, and
        # splits take whole segments); then any d (feature chunks past
        # d = 128 in f32), m = 37 and 1, exclude
        runs = [(p, q, [(8, None), (16, None), (64, excl), (128, None), (256, excl),
                        (512, excl), (1024, None)])]
        for dd in (33, 256, 960, 2048):
            raw = torch.randn(1001, dd, generator=g).to(dev)
            if dt == "int8":
                raw = torch.clamp(torch.round(raw / scale), -127, 127)
            qd = torch.randn(37, dd, generator=g).to(dev)
            runs.append((raw.to(p.dtype), qd, [(32, excl[:37]), (256, None)]))
            runs.append((raw.to(p.dtype), qd[:1].contiguous(), [(8, excl[:1]), (1024, None)]))
        for pts, qq, scases in runs:
            for seg, e in scases:
                # the Hopper emit serves 16-bit rows of d = 96 at every seg
                # here; float32, int8 and the other widths the tile loop
                wgmma = tp.emit_design(pts.dtype, pts.shape[1], seg) == "wgmma"
                assert wgmma == (dt in ("bf16", "f16") and pts.shape[1] == 96)
                before = dict(ex.launches)
                va, ia = tp.segment_minima(pts, qq, seg, exclude=e, scale=scale)
                ran = {name: c - before[name] for name, c in ex.launches.items()
                       if c != before[name]}
                assert ran == ({"twophase_emit": 1, "twophase_emit:wgmma": 1} if wgmma
                               else {"twophase_emit": 1}), ran
                vb, ib = tp.segment_minima_plain(pts, qq, seg, exclude=e, scale=scale)
                torch.cuda.synchronize()
                assert_emit_match(pts, qq, scale, va, ia, vb, ib, seg)
    else:
        m = q.shape[0]
        qq, _, _ = ex._prepare(p, q, scale)
        for seg, k in ((64, 10), (128, 128), (32, None)):
            P = 12 if k is None else k + 2
            sel, _ = tp.segment_merge(p, q, P, seg, scale=scale)
            starts = torch.where(sel < p.shape[0], sel // seg * seg,
                                 torch.full_like(sel, p.shape[0]))
            starts[0, -3:] = p.shape[0]  # exhausted picks
            key = "twophase_rescan_all" if k is None else "twophase_rescan"
            before = ex.launches[key]
            ia, da = tp.rescan_windows(p, qq, starts, seg, k)
            assert ex.launches[key] == before + 1
            ib, db = tp.rescan_windows_plain(p, qq, starts, seg, k)
            torch.cuda.synchronize()
            assert ia.shape == ib.shape == (m, P * seg if k is None else k)
            if k is None:
                assert torch.equal(ia, ib)
                fin = torch.isfinite(db)
                assert torch.equal(fin, torch.isfinite(da))
                np.testing.assert_allclose(da[fin].cpu().numpy(), db[fin].cpu().numpy(),
                                           rtol=1e-5, atol=1e-4)
            else:
                _, d_next = tp.rescan_windows_plain(p, qq, starts, seg, min(k + 1, 128))
                dref = torch.cat([db, d_next[:, k:]], 1) if k < 128 else db
                assert_match(ia.cpu(), da.cpu(), ib.cpu(), dref.cpu())


def assert_emit_match(pts, qq, scale, va, ia, vb, ib, seg):
    """Emit's minima (va, ia) against the plain version's (vb, ib): the same
    finite entries, values at rtol 1e-5 / atol 1e-4 (fp32 sums of exact
    products), argmin rows apart only where two rows of a segment near-tie."""
    assert va.shape == vb.shape == (qq.shape[0], -(-pts.shape[0] // seg))
    fin = torch.isfinite(vb)
    assert torch.equal(fin, torch.isfinite(va))
    np.testing.assert_allclose(va[fin].cpu().numpy(), vb[fin].cpu().numpy(),
                               rtol=1e-5, atol=1e-4)  # fp32 sums of exact products
    qk, _, _ = ex._prepare(pts, qq, scale)  # as the kernel multiplies them
    if pts.dtype in (torch.bfloat16, torch.float16):
        qk = qk.to(pts.dtype).float()
    x = pts.double()
    rows = torch.nonzero((ia != ib) & fin)
    for r, sg in rows.tolist()[:50]:
        sa = (x[ia[r, sg]] - qk[r].double()).pow(2).sum()
        sb = (x[ib[r, sg]] - qk[r].double()).pow(2).sum()
        assert abs(float(sa - sb)) <= 1e-4 * abs(float(sb)) + 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16", "int8"])
def test_emit_deep_like_on_card(dt):
    """Emit at the Deep-10M cell's width on a corpus of 300,001 rows (a
    partial last stage and segment) with m = 1,037 queries (a partial last
    query block and warpgroup), at seg 8 to 1,024, against the plain
    version: with ``exclude``; a NaN row that never returns (the kernel
    counts it +inf, so it must equal the run where that row lies far away,
    bit for bit); duplicated rows where a query sits exactly on the row,
    whose tie goes to the smaller id (inside a quad's columns, inside one
    thread's, across two stages of one segment), and to the duplicate
    where the smaller one is excluded.  bf16 and f16 take the Hopper emit,
    float32 and int8 the tile loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from approximatenn_tpu_torch.ops import twophase as tp

    g = torch.Generator().manual_seed(20)
    dev = torch.device("cuda")
    n, d, m = 300_001, 96, 1037
    raw = torch.randn(n, d, generator=g)
    q = torch.randn(m, d, generator=g)
    pairs = [(1000, 1003), (2000, 2008), (4100, 4600)]
    for src, dst in pairs:
        raw[dst] = raw[src]
    scale = None
    if dt == "int8":
        pts, scale = ex.quantize_corpus(raw)
        stored = pts.float() * scale
    else:
        tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}[dt]
        pts = raw.to(tdt)
        stored = pts.float()
    for i, (src, _) in enumerate(pairs):  # queries 0..2 sit on the duplicated rows
        q[i] = stored[src]
    far = pts.clone()
    if dt != "int8":  # int8 holds no NaN
        far[7] = 6e4  # f16 holds it; the row's score dwarfs every other
        pts[7, 3] = float("nan")
    pts, far, q = pts.to(dev), far.to(dev), q.to(dev)
    excl = torch.randint(0, n, (m,), generator=g, dtype=torch.int32)
    excl[: len(pairs)] = -1
    excl_src = excl.clone()
    excl_src[: len(pairs)] = torch.tensor([s for s, _ in pairs], dtype=torch.int32)
    excl, excl_src = excl.to(dev), excl_src.to(dev)
    wgmma = dt in ("bf16", "f16")
    for seg in (8, 16, 32, 64, 128, 256, 512, 1024):
        assert (tp.emit_design(pts.dtype, d, seg) == "wgmma") == wgmma
        for e in (None, excl, excl_src):
            before = ex.launches["twophase_emit:wgmma"]
            va, ia = tp.segment_minima(pts, q, seg, exclude=e, scale=scale)
            assert ex.launches["twophase_emit:wgmma"] == before + wgmma
            vf, i_f = tp.segment_minima(far, q, seg, exclude=e, scale=scale)
            vb, ib = tp.segment_minima_plain(far, q, seg, exclude=e, scale=scale)
            torch.cuda.synchronize()
            assert torch.equal(va, vf) and torch.equal(ia, i_f), seg
            if dt != "int8":
                assert not bool((ia == 7).any())
            assert_emit_match(far, q, scale, va, ia, vb, ib, seg)
            ia = ia.cpu()
            for i, (src, dst) in enumerate(pairs):
                for row in (src, dst):
                    s = row // seg
                    # the rows that sit on the query, in this segment, not excluded
                    on = [r for r in (src, dst)
                          if r // seg == s and not (e is excl_src and r == src)]
                    if on:
                        assert int(ia[i, s]) == min(on), (seg, i, row, on)
                    else:
                        assert int(ia[i, s]) != src, (seg, i, row)


def one_hot_rows(n: int, d: int, dev):
    """(corpus (n, d), queries (d, d)) float32 of small integers: row r
    holds 1 + r // d in feature r % d and zeros elsewhere, query j is the
    unit vector of feature j.  Then q_j . x_r is 1 + r // d where r % d == j
    and 0 elsewhere, and every value and distance is an integer that
    float32, bf16, f16 and int8 (scale 1) hold exactly for n <= 127 d."""
    r = torch.arange(n, device=dev)
    corpus = torch.zeros((n, d), device=dev)
    corpus[r, r % d] = (1 + r // d).float()
    return corpus, torch.eye(d, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rank", "rescan_merge", "stream", "emit"])
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16", "int8"])
def test_stream_fragment_layout_on_card(dt, kernel):
    """One-hot integer rows against unit-vector queries (``one_hot_rows``):
    every product is exact in every type, so each tensor-core kernel (rank,
    rescan merge, stream, two-phase emit) must equal its plain version bit
    for bit; a wrong fragment index moves a dot product to another (row,
    query) and shows.
    Among the many equal distances here, which ids the replace-the-worst
    merge keeps depends on the tile: the stream's plain version walks the
    kernel's 128-row tiles, the rescan merge's also its corpus splits
    (``exact_knn_rescan_plain_by_splits``); the rank kernel orders ties by id."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16,
           "int8": torch.int8}[dt]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, d in ((1000, 128), (333, 40), (700, 33)):
        X, q = one_hot_rows(n, d, dev)
        pts = X.to(tdt)
        scale = 1.0 if dt == "int8" else None
        excl = torch.arange(d, dtype=torch.int32, device=dev)
        if kernel == "emit":
            from approximatenn_tpu_torch.ops import twophase as tp

            for seg, e in ((8, None), (128, excl), (256, None), (256, excl)):
                va, ia = tp.segment_minima(pts, q, seg, exclude=e, scale=scale)
                vb, ib = tp.segment_minima_plain(pts, q, seg, exclude=e, scale=scale)
                torch.cuda.synchronize()
                assert torch.equal(va, vb) and torch.equal(ia, ib), (dt, n, d, seg)
            continue
        for k, e in ((10, None), (10, excl), (128, None)):
            if kernel == "rank":
                ia, da = ex.exact_knn(pts, q, k, exclude=e, scale=scale)
                ib, db = ex.exact_knn_plain(pts, q, k, exclude=e, scale=scale)
            elif kernel == "rescan_merge":
                ia, da = ex.exact_knn(pts, q, k, exclude=e, scale=scale, merge="rescan")
                qb, tn = ex.tile_geometry("rescan_merge_knn")
                s = ex.splits(d, n, sms, qb, tn)
                ib, db = ex.exact_knn_rescan_plain_by_splits(pts, q, k, s, tn, exclude=e,
                                                             scale=scale)
            else:
                ia, da = ex.exact_knn(pts, q, k, exclude=e, scale=scale, stream=True)
                ib, db = ex.exact_knn_stream_plain(pts, q, k, exclude=e, scale=scale, tile=128)
            torch.cuda.synchronize()
            assert torch.equal(ia, ib) and torch.equal(da, db), (dt, n, d, k)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rank", "rank_wgmma", "rescan_merge", "stream", "twophase"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_nan_and_inf_rows_never_return_on_card(dt, kernel):
    """Rows holding a NaN or an infinite coordinate have NaN or +inf
    distances: they never enter a query's k, and every other row comes back
    as it does when those rows lie far away instead.  In the
    replace-the-worst kernels (rescan merge, stream) a NaN left in a tile's
    lane reduction orders differently in different lanes, so lanes would
    leave the rounds apart while the rest still shuffle with the whole warp
    (the card stops with an illegal instruction); the two-phase engine
    (``exact_knn_twophase``: emit, then the rescan) counts a NaN score as
    +inf in its segment minima too.  ``rank_wgmma`` is the rank kernel's
    Hopper design (float32 only: its NaN and infinite values split into
    NaN halves, so their scores are NaN and never candidates), at m = 200,
    past the one query block that the router leaves to the tile loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    if kernel == "rank_wgmma" and dt != "f32":
        pytest.skip("the Hopper rank kernel takes float32 corpora only")
    dev = torch.device("cuda")
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    from approximatenn_tpu_torch.ops import twophase as tp

    kw = {"rank": {}, "rank_wgmma": {}, "rescan_merge": {"merge": "rescan"},
          "stream": {"stream": True}, "twophase": {}}[kernel]
    fn = tp.exact_knn_twophase if kernel == "twophase" else ex.exact_knn
    g = torch.Generator().manual_seed(3)
    X = torch.randn(1000, 96, generator=g)
    q = torch.randn(200 if kernel == "rank_wgmma" else 37, 96, generator=g).to(dev)
    bad = [5, 700, 701]
    far = X.clone()
    far[bad] = 1e18
    X[5, 17] = float("nan")
    X[700] = float("inf")
    X[701, 0] = -float("inf")
    for k in ((10, 64) if kernel == "rank_wgmma" else (10, 128)):
        wg = ex.launches["exact_knn:wgmma"]
        ia, da = fn(X.to(dev, tdt), q, k, **kw)
        ib, db = fn(far.to(dev, tdt), q, k, **kw)
        torch.cuda.synchronize()
        if kernel == "rank_wgmma":
            assert ex.launches["exact_knn:wgmma"] == wg + 2, k
        assert not torch.isin(ia, torch.tensor(bad, dtype=ia.dtype, device=dev)).any(), k
        assert torch.equal(ia, ib) and torch.equal(da, db), k


def test_plain_by_splits_is_the_plain_version_at_one_split(rng):
    """``exact_knn_rescan_plain_by_splits`` with one split is the rescan
    merge's plain version at 128-row tiles; with several it still gives the
    exact neighbours (on the CPU, where the card's split count is not
    needed)."""
    p = T(rng.standard_normal((700, 12)).astype(np.float32))
    q = T(rng.standard_normal((9, 12)).astype(np.float32))
    e = T(np.arange(9, dtype=np.int32))
    a = ex.exact_knn_rescan_plain_by_splits(p, q, 10, 1, 128, exclude=e)
    b = ex.exact_knn_rescan_plain(p, q, 10, exclude=e, tile=128)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    c = ex.exact_knn_rescan_plain_by_splits(p, q, 10, 4, 128, exclude=e)
    assert_match(c[0], c[1], b[0], b[1])


RANK_ROUTES = [
    # (corpus dtype, tier, d, k, m, design)
    ("f32", "highest", 128, 10, 129, "wgmma"),
    ("f32", "highest", 128, 10, 10_000, "wgmma"),
    ("f32", "highest", 96, 1, 65_536, "wgmma"),
    ("f32", "highest", 32, 64, 129, "wgmma"),
    ("f32", "highest", 4, 10, 10_000, "wgmma"),
    ("f32", "highest", 128, 10, 128, "tile"),  # one query block
    ("f32", "highest", 128, 10, 1, "tile"),
    ("f32", "highest", 128, 65, 10_000, "tile"),  # past the lists' room
    ("f32", "highest", 128, 128, 10_000, "tile"),
    ("f32", "highest", 33, 10, 10_000, "tile"),  # TMA's 16-byte pitch
    ("f32", "highest", 132, 10, 10_000, "tile"),  # past MAX_BOXES boxes
    ("f32", "split3", 128, 10, 10_000, "tile"),
    ("f32", "default", 128, 10, 10_000, "tile"),
    ("bf16", "highest", 128, 10, 10_000, "tile"),
    ("f16", "highest", 128, 10, 10_000, "tile"),
    ("int8", "highest", 128, 10, 10_000, "tile"),
]


@pytest.mark.parametrize("route", RANK_ROUTES, ids=lambda r: "-".join(map(str, r)))
def test_rank_design_routes(route):
    """``rank_design``'s table: the Hopper rank kernel takes float32 at
    "highest" with d a multiple of 4 up to 128, k up to 64 and more than one
    block of 128 queries; every other type, tier, width, k and batch keeps
    the tile loop."""
    dt, tier, d, k, m, want = route
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16,
             "int8": torch.int8}[dt]
    assert ex.rank_design(dtype, tier, d, k, m) == want


@pytest.mark.parametrize("shape", [(10_000, 1_000_000, 128, 10), (65_536, 1_000_000, 128, 10),
                                   (16_960, 1_000_000, 128, 10), (1000, 1_000_000, 128, 10),
                                   (129, 20_011, 96, 64), (300, 5003, 36, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_rank_plan_units(shape):
    """The Hopper rank kernel's plan on a card of 132 SMs: the persistent
    blocks' walk (block b takes units b, b + blocks, ...) meets every (query
    block, split) exactly once; splits cut on whole 128-row tiles, at most
    32 (the split merge's lists), none empty, together the corpus; the ring
    the deepest that fits beside the lists of k.  At the two cells' shapes
    (m = 10,000 and the graph chunk's 65,536 against 1M rows) the units fill
    the card in whole waves (at least 15/16 of its SM slots busy)."""
    m, n, d, k = shape
    sms = 132
    plan = ex.rank_plan(m, n, d, k, sms)
    n_qb = -(-m // ex.WG_RANK_QUERIES)
    s, per = plan["splits"], plan["split_rows"]
    assert plan["units"] == n_qb * s and plan["blocks"] == min(plan["units"], sms)
    walked = [(u % n_qb, u // n_qb) for b in range(plan["blocks"])
              for u in range(b, plan["units"], plan["blocks"])]
    assert sorted(walked) == [(qb, sp) for qb in range(n_qb) for sp in range(s)]
    assert per % ex.WG_RANK_TILE_ROWS == 0 and 1 <= s <= 32
    assert (s - 1) * per < n <= s * per
    bpi = ex.rank_boxes_per_item(d)
    st = plan["stages"]
    assert ex.WG_RANK_STAGES[0] <= st <= ex.WG_RANK_STAGES[1]
    assert ex.wgmma_rank_smem(st, bpi, k) <= ex.SMEM_MAX
    assert st == ex.WG_RANK_STAGES[1] or ex.wgmma_rank_smem(st + 1, bpi, k) > ex.SMEM_MAX
    busy = plan["units"] / (-(-plan["units"] // sms) * sms)
    assert busy == pytest.approx(plan["busy"])
    if m in (10_000, 65_536):
        assert busy >= 15 / 16 and plan["blocks"] == sms


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 96, 32, 36, 33])
def test_rank_wgmma_on_card(d):
    """The rank kernel's Hopper design against the plain version at
    "highest" and the float64 oracle, at d = 128, 96, 32 (whole pairs of
    16-feature boxes), 36 (one-box ring items, the last box mostly past d)
    and 33 (no TMA pitch: the router keeps the tile loop), on n = 20,011
    rows (no multiple of a 128-row tile or of a split): k = 1, 10 and 64
    (the lists' largest), m = 1,500 and 10,000 (neither a multiple of the
    128-query block), and m = 1 and 127 (one query block, which the router
    leaves to the tile loop), excluded ids, duplicated rows whose tie goes
    to the smaller id, and ``launches["exact_knn:wgmma"]`` rising by one a
    call exactly where ``rank_design`` says "wgmma"."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator().manual_seed(d)
    dev = torch.device("cuda")
    n = 20_011
    raw = torch.randn(n, d, generator=g)
    raw[9000] = raw[17]
    raw[15000] = raw[17]
    p = raw.to(dev)
    q = torch.randn(10_000, d, generator=g).to(dev)
    q[0] = p[17]  # sits on three equal rows: 17, 9000, 15000
    excl = torch.randint(0, n, (10_000,), generator=g, dtype=torch.int32).to(dev)
    excl[0] = -1
    for k in (1, 10, 64):
        for m, e in ((1500, None), (1500, excl), (10_000, excl), (127, excl), (1, None)):
            qq, ee = q[:m].contiguous(), None if e is None else e[:m].contiguous()
            wg = d % 4 == 0 and m > 128
            assert ex.rank_design(torch.float32, "highest", d, k, m) == ("wgmma" if wg else "tile")
            before = dict(ex.launches)
            ia, da = ex.exact_knn(p, qq, k, exclude=ee)
            ran = {name: c - before[name] for name, c in ex.launches.items() if c != before[name]}
            assert ran == ({"exact_knn": 1, "exact_knn:wgmma": 1} if wg
                           else {"exact_knn": 1}), (k, m, ran)
            ib, db = ex.exact_knn_plain(p, qq, k + 1, exclude=ee)
            torch.cuda.synchronize()
            # query 0 sits on a row: its distance 0 comes out of |q|^2 + (|x|^2
            # - 2 q.x), a cancellation that leaves a few ulps of |q|^2 (one
            # accumulator takes all three TF32 passes): held to |q|^2 there
            assert_match(ia[1:].cpu(), da[1:].cpu(), ib[1:, :k].cpu(), db[1:].cpu())
            assert torch.equal(ia[0], ib[0, :k])
            assert float((da[0] - db[0, :k]).abs().max()) <= 1e-5 * float(qq[0].pow(2).sum())
            # the float64 oracle: the k-th distance, and every id's distance
            x64, q64 = p.double(), qq.double()
            d64 = torch.cdist(q64, x64).pow(2)
            if ee is not None:
                d64[torch.arange(m, device=dev), ee.long()] = float("inf")
            kth = torch.topk(d64, k, largest=False).values[:, -1]
            got = d64.gather(1, ia.long())
            scale = q64.pow(2).sum(1, keepdim=True) + x64.pow(2).sum(1).median()
            assert bool(((got - kth[:, None]) / scale <= 1e-5).all()), (k, m)
            if k >= 3 and m > 1:
                assert ia[0, :3].tolist() == [17, 9000, 15000], ia[0, :3]


@pytest.mark.parametrize("shape", ["serving", "graph_chunk"])
def test_split_geometry_with_132_sms(shape):
    """The rank kernel's and the rescan merge's grid at the main path's
    shapes on a card of 132 SMs (the H100 SXM), one block resident per SM:
    at the serving shape (1M x 128, m = 1000) 32 query blocks x 4 splits =
    128 blocks, one wave; at the graph chunk (m = 65,536 queries) 2048 query
    blocks and no split, 16 waves.  The two-phase emit runs the same grid
    (``test_emit_splits_cut_on_segment_boundaries``)."""
    m, want = {"serving": (1000, 4), "graph_chunk": (65536, 1)}[shape]
    n, sms, qb, tn = 1_000_000, 132, 32, 128
    s = ex.splits(m, n, sms, qb, tn)
    assert s == want
    blocks = -(-m // qb) * s
    waves = -(-blocks // sms)
    assert blocks / (waves * sms) >= 7 / 8  # at most 1/8 of the SM slots idle
    assert all(ex.splits(m, nn, sms, qb, tn) <= 32 for nn in (n, 10**8))  # the kernels' cap
    if shape == "serving":
        # one query: every split it may have, the card still mostly idle
        assert ex.splits(1, n, sms, qb, tn) == 32
        # a corpus of one tile cannot be split
        assert ex.splits(m, 100, sms, qb, tn) == 1


@pytest.mark.parametrize("seg", [2**i for i in range(11)])
def test_emit_splits_cut_on_segment_boundaries(seg):
    """The two-phase emit's grid on the tile loop (``ops/twophase.py:
    segment_minima`` takes the rank kernel's splits, ``knn_tile.cuh:
    launch_tiled`` rounds a split up to whole segments): for n not a tile
    multiple every split boundary is a segment boundary, the splits cover
    the corpus, and at the serving shape (1M x 128, m = 1000, seg = 128 on
    132 SMs) the blocks keep at least 7/8 of the SMs busy."""
    sms, qb, tn = 132, 32, 128
    for n in (1, 1001, 5003, 20_011, 1_000_003):
        for m in (1, 37, 300, 1000, 65_536):
            s = ex.splits(m, n, sms, qb, tn)
            per = ex.split_rows(n, s, tn, max(1, seg // tn))
            starts = [b * per for b in range(s + 1)]  # split b: rows [b per, (b + 1) per) below n
            assert all(b % tn == 0 and b % seg == 0 for b in starts if b < n), (n, m, s, per)
            assert starts[-1] >= n  # the splits cover every row
    s = ex.splits(1000, 1_000_000, sms, qb, tn)
    assert ex.split_rows(1_000_000, s, tn, 1) * s >= 1_000_000
    blocks = -(-1000 // qb) * s
    assert blocks / (-(-blocks // sms) * sms) >= 7 / 8


@pytest.mark.cuda
@pytest.mark.parametrize("d", [200, 256, 768])
def test_stream_large_d_on_card(d):
    """Past d = 200 (float32) two 128-row ring slots do not fit a block's
    shared memory: the launcher takes 64-, 32- or 16-row slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator().manual_seed(d)
    dev = torch.device("cuda")
    p = torch.randn(3001, d, generator=g).to(dev)
    q = torch.randn(100, d, generator=g).to(dev)
    excl = torch.arange(100, dtype=torch.int32, device=dev)
    for pts, rtol in ((p, 1e-5), (p.to(torch.bfloat16), 1e-3)):
        for k, e in ((10, excl), (128, None)):
            before = ex.launches["exact_knn_stream"]
            ia, da = ex.exact_knn(pts, q, k, exclude=e, stream=True)
            assert ex.launches["exact_knn_stream"] == before + 1
            ib, db = ex.exact_knn_stream_plain(pts, q, k + 1, exclude=e)
            torch.cuda.synchronize()
            assert_match(ia.cpu(), da.cpu(), ib[:, :k].cpu(), db.cpu(), rtol=rtol)
