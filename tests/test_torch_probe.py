"""The probe-window top-k (``ops/probe.py``): its plain PyTorch version
against the JAX package's ``probe_topk_pallas`` run in interpret mode (as
tests/test_pallas_probe.py runs it) on a JAX-built packed view carried
across with ``PackedIndex.load``, on the CPU; the CUDA kernel against the
plain version on a card (``cuda`` marker, skipped without one).

Tolerance: per (query, table) the slots must be equal position by position
outside near-ties (adjacent reference distances within rtol 1e-5, the two
frameworks sum the same float32 squares in another order) and the
distances agree at rtol 1e-5 / atol 1e-5.  int8 rows are widened to
float32 in both, so the same bound holds there.

JAX is imported only inside the tests that compare with it, so the card
test also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_probe.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from approximatenn_tpu_torch.harness.scoring import ids_agree
from approximatenn_tpu_torch.index import PackedIndex
from approximatenn_tpu_torch.ops import exact as ex
from approximatenn_tpu_torch.ops import probe as pr

torch.set_num_threads(1)

N, D, K, TRIES, M = 2500, 24, 8, 4, 8


def T(a):
    return torch.from_numpy(np.array(a))


def assert_probe_match(pa, da, pb, db):
    """(m, tries, k) slots and distances, ``b`` the reference."""
    k = pa.shape[-1]
    pa, da, pb, db = (torch.as_tensor(np.array(x)).cpu().reshape(-1, k)
                      for x in (pa, da, pb, db))
    ok, _ = ids_agree(pa, pb, db, rtol=1e-5)
    assert ok, (pa, pb)
    fin = torch.isfinite(db)
    assert torch.equal(fin, torch.isfinite(da))
    np.testing.assert_allclose(da[fin].numpy(), db[fin].numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """A JAX index over an iid corpus, its f32 and int8 packed views, and
    the same views in the port (through the JAX npz files)."""
    import jax.numpy as jnp

    import approximatenn_tpu as jann

    rng = np.random.default_rng(31)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Y = rng.standard_normal((M, D)).astype(np.float32)
    jidx, _, _ = jann.build(jnp.asarray(X), K, tries=TRIES, seed=4, store_points=True)
    out = {}
    for name, dt in (("f32", None), ("int8", jnp.int8)):
        jpv = jidx.packed(dtype=dt)
        path = str(tmp_path_factory.mktemp("pv") / f"{name}.npz")
        jpv.save(path)
        out[name] = (jpv, PackedIndex.load(path, device="cpu"))
    return X, Y, out


def directed_starts(pv, Y, n_probes, window):
    """The fused path's window starts (engine/search.py), from the port."""
    from approximatenn_tpu_torch.engine.search import probe_starts

    return probe_starts(pv, T(Y), n_probes, window)


CASES = {
    # name: (view, window, P or None for directed starts, k, live bound offset)
    "f32_directed": ("f32", 24, None, K, 0),
    "overlapping": ("f32", 24, 4, K, 0),
    "clipped_at_end": ("f32", 40, 3, K, 0),
    "live_bound": ("f32", 24, None, K, 700),
    "k_over_distinct": ("f32", 5, 1, 40, 0),
    "int8_directed": ("int8", 24, None, K, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(views, case):
    import jax.numpy as jnp

    from approximatenn_tpu.ops.pallas_probe import probe_topk_pallas

    X, Y, vs = views
    name, window, P, k, cut = CASES[case]
    jpv, tpv = vs[name]
    n_pad = tpv.n_pad
    assert n_pad == jpv.n_rows * jpv.super_width
    rng = np.random.default_rng(3)
    if P is None:
        starts = directed_starts(tpv, Y, 4, window)
    elif case == "overlapping":
        base = rng.integers(0, n_pad - 4 * window, (M, TRIES, 1))
        starts = T((base + rng.integers(0, window, (M, TRIES, P))).astype(np.int32))
    elif case == "clipped_at_end":
        starts = T(np.full((M, TRIES, P), n_pad - window, np.int32))
        starts[:, :, 0] = int(rng.integers(0, n_pad - window))
    else:
        starts = T(rng.integers(0, n_pad - window, (M, TRIES, P)).astype(np.int32))
    n = tpv.live_bound - cut
    q = T(Y)
    if tpv.scale is not None:  # the fused path feeds q / scale to int8 rows
        q = q / tpv.scale
        np.testing.assert_array_equal(tpv.point_rows.numpy(),
                                      np.asarray(jpv.point_rows)[:, :D])
    jq = jnp.pad(jnp.asarray(q.numpy()), [(0, 0), (0, jpv.lane_dim - D)])
    jp, jd = probe_topk_pallas(jpv.point_rows, jq, jnp.asarray(starts.numpy()), k=k, n=n,
                               n_pad=n_pad, window=window, query_block=8, interpret=True)
    before = ex.launches["probe_topk"]
    tp_, td = pr.probe_topk(tpv.point_rows, q, starts, k=k, n=n, n_pad=n_pad,
                            window=window)
    assert ex.launches["probe_topk"] == before  # a CPU view runs the plain version
    assert tp_.shape == (M, TRIES, k) and tp_.dtype == torch.int32
    assert td.dtype == torch.float32
    assert_probe_match(tp_, td, jp, jd)
    assert (tp_[torch.isinf(td)] == n).all()
    assert not (tp_[torch.isfinite(td)] >= n).any()
    if case == "k_over_distinct":
        assert torch.isinf(td[..., 16:]).all()  # one widened window: 16 slots


def test_prepare_widens_and_aligns():
    rows = torch.zeros((2 * 64, 4))
    q = torch.zeros((1, 4))
    starts = torch.tensor([[[0, 13, 63], [7, 40, 56]]], dtype=torch.int32)
    _, st, w = pr.prepare(rows, q, starts, n_pad=64, window=10)
    assert w == 24  # ceil((10 + 7) / 8) * 8
    assert st.tolist() == [[[0, 8, 40], [0, 40, 40]]]
    _, st8, w8 = pr.prepare(rows.to(torch.int8), q, starts, n_pad=64, window=10)
    assert w8 == 64 and (st8 == 0).all()
    with pytest.raises(ValueError):
        pr.prepare(rows, q, starts, n_pad=60, window=10)
    qh, _, _ = pr.prepare(rows.to(torch.bfloat16), torch.full((1, 4), 1.001), starts,
                          n_pad=64, window=10)
    assert qh.dtype == torch.float32 and float(qh[0, 0]) == 1.0  # rounded to bf16


def test_probe_topk_checks():
    rows = torch.zeros((2 * 64, 4))
    q = torch.zeros((3, 4))
    starts = torch.zeros((3, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="k <= 128"):
        pr.probe_topk(rows, q, starts, k=129, n=10, n_pad=64, window=8)
    with pytest.raises(ValueError):
        pr.probe_topk(rows, q, starts, k=4, n=10, n_pad=32, window=8)
    with pytest.raises(TypeError):
        pr.probe_topk(rows.double(), q, starts, k=4, n=10, n_pad=64, window=8)
    pos, dd = pr.probe_topk(rows, q, starts, k=20, n=10, n_pad=64, window=8)
    assert (pos[..., :10] == torch.arange(10, dtype=torch.int32)).all()  # ties by slot
    assert (pos[..., 10:] == 10).all() and torch.isinf(dd[..., 10:]).all()


def _check_on_card(rows, q, starts, *, k, n, n_pad, window, **kw):
    """One launch of the kernel (``kw``: its geometry) against the plain
    version on the same prepared inputs: slots equal outside near-ties,
    distances at rtol 1e-5 / atol 1e-4, (n, +inf) past the live slots."""
    m, tries = starts.shape[:2]
    before = ex.launches["probe_topk"]
    pa, da = pr.probe_topk(rows, q, starts, k=k, n=n, n_pad=n_pad, window=window, **kw)
    assert ex.launches["probe_topk"] == before + 1
    qq, st, w = pr.prepare(rows, q, starts, n_pad=n_pad, window=window)
    pb, db = pr.probe_topk_plain(rows, qq, st, k=min(k + 1, 128), n=n, n_pad=n_pad,
                                 window=w)
    torch.cuda.synchronize()
    if k < 128:
        pb, dref = pb[..., :k], db
    else:
        dref = db
    pa, da, pb, dref = (x.cpu().reshape(m * tries, -1) for x in (pa, da, pb, dref))
    ok, _ = ids_agree(pa, pb, dref, rtol=1e-5)
    assert ok, kw
    dref = dref[:, :k]
    fin = torch.isfinite(dref)
    assert torch.equal(fin, torch.isfinite(da))
    np.testing.assert_allclose(da[fin].numpy(), dref[fin].numpy(), rtol=1e-5, atol=1e-4)
    assert (pa[~fin] == n).all()
    return pa


def _inputs(g, dev, dt, m, tries, P, d, n_pad, window, overlap, offset=False):
    """Random rows of type ``dt`` (``offset``: an f32 view 4 bytes past an
    allocation, so rows start off the 16-byte grid), queries as the wrapper
    takes them, starts (overlapping windows or spread ones)."""
    rows = torch.randn(tries * n_pad, d, generator=g).to(dev)
    q = torch.randn(m, d, generator=g).to(dev)
    if offset:
        flat = torch.empty(tries * n_pad * d + 1, device=dev)
        flat[1:] = rows.reshape(-1)
        rows = flat[1:].view(tries * n_pad, d)
    if dt == "bf16":
        rows = rows.to(torch.bfloat16)
    elif dt == "f16":
        rows = rows.to(torch.float16)
    elif dt == "int8":
        rows, scale = ex.quantize_corpus(rows)
        q = q / scale
    hi = n_pad - window
    if overlap:
        base = torch.randint(0, max(1, hi - window), (m, tries, 1), generator=g)
        starts = base + torch.randint(0, window, (m, tries, P), generator=g)
    else:
        starts = torch.randint(0, hi + 1, (m, tries, P), generator=g)
    return rows, q, torch.clamp(starts, max=hi).to(torch.int32).to(dev)


# the degenerate set: (m, tries, P, d, window, k, live bound, overlapping windows)
DEGENERATE = ((200, 4, 18, 128, 96, 10, 4000, False),
              (200, 4, 8, 96, 40, 50, 3000, True),
              (64, 3, 2, 128, 16, 128, 4000, False),
              (1, 1, 1, 128, 8, 10, 4000, False),
              (50, 2, 4, 128, 32, 10, 10, False))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16", "int8"])
def test_kernel_matches_plain_on_card(dt):
    dev = _card()
    g = torch.Generator().manual_seed(0)
    n_pad = 4096
    for m, tries, P, d, window, k, n, overlap in DEGENERATE:
        rows, q, starts = _inputs(g, dev, dt, m, tries, P, d, n_pad, window, overlap)
        _check_on_card(rows, q, starts, k=k, n=n, n_pad=n_pad, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16", "int8"])
def test_kernel_rows_of_any_width_on_card(dt):
    """Rows whose bytes are no multiple of 16 (d = 33: 4-byte f32, 2-byte
    bf16/f16 and 1-byte int8 loads), d = 96 (lanes left idle in a group),
    d = 300 (rows read in several passes) and, in f32, rows off the 16-byte
    grid (4-byte loads)."""
    dev = _card()
    g = torch.Generator().manual_seed(1)
    n_pad = 2048
    for d, offset in ((33, False), (96, False), (300, False), (128, dt == "f32")):
        for m, tries, P, window, k, n, overlap in ((120, 3, 12, 64, 10, 2000, True),
                                                   (30, 2, 3, 16, 128, 1900, False)):
            rows, q, starts = _inputs(g, dev, dt, m, tries, P, d, n_pad, window, overlap,
                                      offset)
            _check_on_card(rows, q, starts, k=k, n=n, n_pad=n_pad, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_kernel_every_geometry_on_card(dt):
    """The degenerate set at every launch geometry the kernel takes: lane
    groups of 4 to 32 lanes (one or several passes a row), 1, 2, 4 or 8
    warps a (query, table) pair."""
    dev = _card()
    g = torch.Generator().manual_seed(2)
    n_pad = 4096
    size = {"f32": 4, "bf16": 2, "int8": 1}[dt]
    for m, tries, P, d, window, k, n, overlap in DEGENERATE:
        rows, q, starts = _inputs(g, dev, dt, m, tries, P, d, n_pad, window, overlap)
        for lanes in (4, 8, 16, 32):
            geom = ex.gather_geometry(d, size, lanes=lanes)
            for wpp in (1, 2, 4, 8):
                _check_on_card(rows, q, starts, k=k, n=n, n_pad=n_pad, window=window,
                               geometry=geom, warps_per_pair=wpp)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_nan_and_inf_rows_never_return_on_card(dt):
    """Rows holding a NaN or an infinite coordinate score NaN or +inf: the
    kernel runs through them, never returns their slots, and equals the
    plain version (more finite slots than k in every window union)."""
    dev = _card()
    g = torch.Generator().manual_seed(3)
    n_pad, window = 2048, 128
    rows, q, starts = _inputs(g, dev, "f32", 100, 3, 6, 96, n_pad, window, True)
    bad = torch.randint(0, 3 * n_pad, (300,), generator=g).to(dev)
    rows[bad[:100], 5] = float("nan")
    rows[bad[100:200]] = float("inf")
    rows[bad[200:], 0] = -float("inf")
    if dt == "bf16":
        rows = rows.to(torch.bfloat16)
    for k in (10, 50):
        pa = _check_on_card(rows, q, starts, k=k, n=n_pad - 1, n_pad=n_pad, window=window)
        slots = bad.cpu() % n_pad
        tables = bad.cpu() // n_pad
        for t in range(3):
            got = pa.reshape(100, 3, k)[:, t]
            assert not torch.isin(got, slots[tables == t].to(got.dtype)).any(), (k, t)
