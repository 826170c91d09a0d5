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
                assert {name: c - before[name] for name, c in ex.launches.items() if c != before[name]} == {key: 1}
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
@pytest.mark.parametrize("kernel", ["rank", "rescan_merge", "stream", "twophase"])
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
    +inf in its segment minima too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    from approximatenn_tpu_torch.ops import twophase as tp

    kw = {"rank": {}, "rescan_merge": {"merge": "rescan"}, "stream": {"stream": True},
          "twophase": {}}[kernel]
    fn = tp.exact_knn_twophase if kernel == "twophase" else ex.exact_knn
    g = torch.Generator().manual_seed(3)
    X = torch.randn(1000, 96, generator=g)
    q = torch.randn(37, 96, generator=g).to(dev)
    bad = [5, 700, 701]
    far = X.clone()
    far[bad] = 1e18
    X[5, 17] = float("nan")
    X[700] = float("inf")
    X[701, 0] = -float("inf")
    for k in (10, 128):
        ia, da = fn(X.to(dev, tdt), q, k, **kw)
        ib, db = fn(far.to(dev, tdt), q, k, **kw)
        torch.cuda.synchronize()
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
