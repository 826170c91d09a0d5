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


MIN_M = pr.TILES_MIN_M  # the design rule's batch gate, whatever its value
BF16, F16 = torch.bfloat16, torch.float16

DESIGN_ROUTES = [
    # (rows, m, tries, P, d, k, design)
    (BF16, 10_000, 10, 18, 128, 10, "tiles"),  # the hash cell
    (F16, 10_000, 10, 18, 128, 10, "tiles"),
    (BF16, MIN_M, 10, 18, 128, 10, "tiles"),
    (BF16, MIN_M, 1, 1, 8, 1, "tiles"),
    (F16, 65_536, 6, 48, 96, 128, "tiles"),
    (BF16, 10_000, 10, pr.TILES_MAX_P, pr.TILES_MAX_D, 10, "tiles"),
    (BF16, MIN_M - 1, 10, 18, 128, 10, "pairs"),  # little to share
    (BF16, 1, 10, 18, 128, 10, "pairs"),
    (F16, 100, 10, 18, 128, 10, "pairs"),
    (torch.float32, 10_000, 10, 18, 128, 10, "pairs"),
    (torch.int8, 10_000, 6, 18, 96, 10, "pairs"),  # queries q / scale stay fp32
    (BF16, 10_000, 10, 18, 33, 10, "pairs"),  # rows of no whole 16-byte units
    (BF16, 10_000, 10, 18, pr.TILES_MAX_D + 8, 10, "pairs"),
    (BF16, 10_000, 10, pr.TILES_MAX_P + 1, 128, 10, "pairs"),
]


@pytest.mark.parametrize("route", DESIGN_ROUTES,
                         ids=lambda r: "-".join(str(x).replace("torch.", "") for x in r))
def test_probe_design_routes(route):
    """``probe_design``'s table: the tile design takes bf16 and f16 rows of
    d a multiple of 8 up to TILES_MAX_D, up to TILES_MAX_P windows, at
    batches of TILES_MIN_M queries and more; float32 and int8 rows, other
    widths and small batches keep the pair design."""
    dtype, m, tries, P, d, k, want = route
    assert pr.probe_design(dtype, m, tries, P, d, k) == want


DESIGN_CHECKS = {
    # (rows dtype, d, P, m, what is asked)
    "f32_rows": (torch.float32, 16, 2, 3, "tiles"),
    "int8_rows": (torch.int8, 16, 2, 3, "tiles"),
    "d_not_multiple_of_8": (BF16, 12, 2, 3, "tiles"),
    "d_past_max": (F16, pr.TILES_MAX_D + 8, 2, 3, "tiles"),
    "P_past_max": (BF16, 16, pr.TILES_MAX_P + 1, 3, "tiles"),
    "rows_on_cpu": (BF16, 16, 2, 3, "tiles"),
    "cpu_routes_plain": (BF16, 16, 2, MIN_M, "probe_topk"),
}


@pytest.mark.parametrize("case", sorted(DESIGN_CHECKS))
def test_probe_design_checks(case):
    """The tile design's launch (``_probe_tiles``) refuses, before it
    loads the kernel library, rows it does not take (float32, int8, d no
    multiple of 8 or past TILES_MAX_D, more than TILES_MAX_P windows) and
    rows off a card; ``probe_topk`` on the CPU runs the plain version
    whatever the design rule says of a card."""
    dtype, d, P, m, ask = DESIGN_CHECKS[case]
    g = torch.Generator().manual_seed(5)
    rows = torch.randn((2 * 64, d), generator=g).to(dtype)
    q = torch.randn((m, d), generator=g)
    starts = torch.randint(0, 56, (m, 2, P), dtype=torch.int32, generator=g)
    if ask == "probe_topk":
        assert pr.probe_design(dtype, m, 2, P, d, 4) == "tiles"
        got = pr.probe_topk(rows, q, starts, k=4, n=60, n_pad=64, window=8)
        qq, st, w = pr.prepare(rows, q, starts, n_pad=64, window=8)
        want = pr.probe_topk_plain(rows, qq, st, k=4, n=60, n_pad=64, window=w)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return
    qq, st, w = pr.prepare(rows, q, starts, n_pad=64, window=8)
    match = "runs on a card" if case == "rows_on_cpu" else "tile design takes"
    with pytest.raises(ValueError, match=match):
        pr._probe_tiles(rows, qq, st, k=4, n=60, n_pad=64, window=w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(10, 18, 1_000_008, 104), (6, 48, 10_000_000, 96),
                                   (1, 1, 64, 8), (10, 1024, 1 << 24, 256),
                                   (64, 1024, 1 << 26, 4096)],
                         ids=lambda s: "x".join(map(str, s)))
def test_tiles_block(shape):
    """Queries a tile-design launch takes (``probe_tiles_block``, from the
    workspace's own layout): at least one, its workspace within
    TILES_WORKSPACE where it takes more than one, one query more past it
    or past the sizes it takes; the hash cell's 10,000 queries in one
    launch."""
    _card()
    lib = ex._library("probe_knn")
    tries, P, n_pad, window = shape
    d, k = 128, 10
    b = lib.probe_tiles_block(tries, P, d, n_pad, window, k, pr.TILES_WORKSPACE)
    assert b >= 1
    assert b == 1 or lib.probe_tiles_workspace(b, tries, P, d, n_pad, window, k) \
        <= pr.TILES_WORKSPACE
    more = lib.probe_tiles_workspace(b + 1, tries, P, d, n_pad, window, k)
    assert more == -1 or more > pr.TILES_WORKSPACE
    if shape == (10, 18, 1_000_008, 104):
        assert b >= 10_000
    assert lib.probe_tiles_block(tries, P, 12, n_pad, window, k, pr.TILES_WORKSPACE) == -1


def _run(rows, q, starts, *, k, n, n_pad, window, design=None, **kw):
    """``probe_topk`` (``design`` None), or one design's launch on the
    prepared inputs (``kw``: the pair design's geometry)."""
    if design is None:
        return pr.probe_topk(rows, q, starts, k=k, n=n, n_pad=n_pad, window=window)
    qq, st, w = pr.prepare(rows, q, starts, n_pad=n_pad, window=window)
    launch = pr._probe_tiles if design == "tiles" else pr._probe_pairs
    return launch(rows, qq, st, k=k, n=n, n_pad=n_pad, window=w, **kw)


def _check_on_card(rows, q, starts, *, k, n, n_pad, window, **kw):
    """One launch of the kernel (``kw``: its design or geometry; one
    launch under "probe_topk", and under "probe_topk:tiles" where the tile
    design runs) against the plain
    version on the same prepared inputs: slots equal outside near-ties,
    distances at rtol 1e-5 / atol 1e-4, (n, +inf) past the live slots."""
    m, tries, P = starts.shape
    before = ex.launches["probe_topk"], ex.launches["probe_topk:tiles"]
    pa, da = _run(rows, q, starts, k=k, n=n, n_pad=n_pad, window=window, **kw)
    tiles = (kw.get("design") or pr.probe_design(rows.dtype, m, tries, P, rows.shape[1],
                                                 k)) == "tiles"
    assert ex.launches["probe_topk"] == before[0] + 1
    assert ex.launches["probe_topk:tiles"] == before[1] + tiles
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
    """The degenerate set at every launch geometry the pair design takes:
    lane groups of 4 to 32 lanes (one or several passes a row), 1, 2, 4 or
    8 warps a (query, table) pair."""
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
                               geometry=geom, warps_per_pair=wpp, design="pairs")


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


# the tile design's edges: (m, tries, P, d, window, k, live bound, starts)
# at n_pad 4096; starts "hot" (every query the same starts: a tile binned by
# more queries than one work item holds, and two windows of a pair on the
# same slots), "straddle" (every window across a tile edge), "overlap"
# (a pair's windows sharing slots), "end" (every start at n_pad - window),
# "spread" (uniform)
TILE_CASES = {
    "hot_tile": (300, 2, 4, 128, 96, 10, 4000, "hot"),
    "straddle": (200, 3, 6, 128, 96, 10, 4000, "straddle"),
    "overlap": (200, 4, 8, 96, 40, 50, 3000, "overlap"),
    "at_end": (100, 2, 3, 128, 96, 10, 4095, "end"),
    "live_in_tile": (150, 3, 6, 64, 104, 10, 3000 + 37, "spread"),
    "k1": (300, 3, 6, 128, 104, 1, 2000, "overlap"),
    "k128": (64, 3, 5, 128, 96, 128, 4000, "spread"),
    "one_window": (1, 1, 1, 8, 8, 10, 4000, "spread"),
    "wide_rows": (100, 2, 5, 256, 200, 32, 4000, "overlap"),
    "hash_cell_like": (500, 10, 18, 128, 96, 10, 4000, "spread"),
    "nothing_live": (50, 2, 4, 64, 32, 10, 0, "spread"),
}


def _tile_starts(g, kind, m, tries, P, n_pad, window):
    hi = n_pad - window
    if kind == "hot":
        one = torch.randint(0, hi + 1, (1, 1, P), generator=g)
        one[..., -1] = one[..., 0]
        return one.expand(m, tries, P).contiguous()
    if kind == "straddle":
        edge = torch.randint(1, n_pad // 128, (m, tries, P), generator=g) * 128
        return torch.clamp(edge - window // 2, 0, hi)
    if kind == "end":
        return torch.full((m, tries, P), hi)
    if kind == "overlap":
        base = torch.randint(0, max(1, hi - window), (m, tries, 1), generator=g)
        return torch.clamp(base + torch.randint(0, window, (m, tries, P), generator=g), max=hi)
    return torch.randint(0, hi + 1, (m, tries, P), generator=g)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TILE_CASES))
@pytest.mark.parametrize("dt", ["bf16", "f16"])
def test_tiles_match_plain_on_card(dt, case):
    """The tile design (``_probe_tiles``, one launch counted under
    "probe_topk" and "probe_topk:tiles") against the plain version at its
    edges, bf16 and f16 rows."""
    dev = _card()
    g = torch.Generator().manual_seed(7)
    m, tries, P, d, window, k, n, kind = TILE_CASES[case]
    n_pad = 4096
    rows, q, _ = _inputs(g, dev, dt, m, tries, P, d, n_pad, window, False)
    starts = _tile_starts(g, kind, m, tries, P, n_pad, window).to(torch.int32).to(dev)
    _check_on_card(rows, q, starts, k=k, n=n, n_pad=n_pad, window=window, design="tiles")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bf16", "f16"])
def test_tiles_nan_and_inf_rows_never_return_on_card(dt):
    """As test_nan_and_inf_rows_never_return_on_card, on the tile design:
    a row with a NaN or an infinite coordinate scores +inf."""
    dev = _card()
    g = torch.Generator().manual_seed(3)
    n_pad, window = 2048, 128
    rows, q, starts = _inputs(g, dev, "f32", 100, 3, 6, 96, n_pad, window, True)
    bad = torch.randint(0, 3 * n_pad, (300,), generator=g).to(dev)
    rows[bad[:100], 5] = float("nan")
    rows[bad[100:200]] = float("inf")
    rows[bad[200:], 0] = -float("inf")
    rows = rows.to(BF16 if dt == "bf16" else F16)
    for k in (10, 50):
        pa = _check_on_card(rows, q, starts, k=k, n=n_pad - 1, n_pad=n_pad, window=window,
                            design="tiles")
        slots = bad.cpu() % n_pad
        tables = bad.cpu() // n_pad
        for t in range(3):
            got = pa.reshape(100, 3, k)[:, t]
            assert not torch.isin(got, slots[tables == t].to(got.dtype)).any(), (k, t)


def _clustered_tables(dev, *, n, n_pad, tries, d, m, P, window, seed):
    """Packed rows at the hash cell's scale in bf16, laid out as the index
    lays out buckets: a clustered corpus (10,000 centres N(0, 4^2), Zipf 1.2
    weights, members N(centre, 1), as the SIFT-1M stand-in draws it), table
    t holding the rows sorted by cluster in its own cluster order, pad rows
    zero; m queries of the same mixture; each (query, table) pair's starts
    two thirds on its cluster's slots in that table, the rest on other
    clusters'.  The rows lie far from the origin beside their neighbours'
    distances (|x|^2 ~ 2,200, distances ~ 250)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nc = 10_000
    centres = 4.0 * torch.randn((nc, d), generator=g, device=dev)
    w = 1.0 / torch.arange(1, nc + 1, dtype=torch.float64, device=dev) ** 1.2
    cdf = torch.cumsum(w / w.sum(), 0)

    def draw(count):
        c = torch.searchsorted(cdf, torch.rand(count, generator=g, device=dev,
                                               dtype=torch.float64)).clamp_(max=nc - 1)
        return centres[c] + torch.randn((count, d), generator=g, device=dev), c

    x, cx = draw(n)
    q, cq = draw(m)
    rows = torch.zeros((tries * n_pad, d), dtype=BF16, device=dev)
    starts = torch.empty((m, tries, P), dtype=torch.int64, device=dev)
    own = (2 * P) // 3
    hi = n_pad - window
    for t in range(tries):
        rank = torch.randperm(nc, generator=g, device=dev)  # table t's cluster order
        order = torch.argsort(rank[cx], stable=True)
        rows[t * n_pad: t * n_pad + n] = x[order].to(BF16)
        sizes = torch.bincount(rank[cx], minlength=nc)
        first = torch.cumsum(sizes, 0) - sizes  # by rank
        base, size = first[rank[cq]], sizes[rank[cq]]
        room = torch.clamp(size - window // 2, min=1)[:, None]
        u = torch.rand((m, own), generator=g, device=dev)
        starts[:, t, :own] = base[:, None] + (u * room).long()
        other = torch.randint(0, nc, (m, P - own), generator=g, device=dev)
        starts[:, t, own:] = first[other]
    return rows, q, torch.clamp(starts, 0, hi).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 50])
def test_tiles_clustered_main_shape_on_card(k):
    """The tile design at the main path's shape (1M bf16 rows of d = 128
    in 10 tables, m = 1000, 18 probes, window 96) on clustered rows, where
    |x|^2 + |q|^2 - 2 q.x cancels most of its bits: against the plain
    version at the file's tolerance (distances rtol 1e-5 / atol 1e-4), as
    chip_smoke.py's check_probe holds the main shape.  k = 10 takes the
    threshold selection, k = 50 the general one."""
    dev = _card()
    n, n_pad, tries, m, P, window = 1_000_000, 1_000_008, 10, 1000, 18, 96
    rows, q, starts = _clustered_tables(dev, n=n, n_pad=n_pad, tries=tries, d=128, m=m, P=P,
                                        window=window, seed=21)
    assert pr.probe_design(BF16, m, tries, P, 128, k) == "tiles"
    _check_on_card(rows, q, starts, k=k, n=n, n_pad=n_pad, window=window)


@pytest.mark.cuda
def test_tiles_routed_and_blocked_on_card(monkeypatch):
    """The design rule on a card: bf16 rows at TILES_MIN_M queries take the
    tile design, one query fewer the pair design; a workspace cap that
    takes fewer queries than the batch splits it into query blocks, one
    launch each, with the same answers."""
    dev = _card()
    g = torch.Generator().manual_seed(11)
    n_pad, window, P, tries = 2048, 96, 6, 2
    rows, q, starts = _inputs(g, dev, "bf16", MIN_M, tries, P, 64, n_pad, window, True)
    _check_on_card(rows, q, starts, k=10, n=2000, n_pad=n_pad, window=window)
    _check_on_card(rows, q[1:], starts[1:], k=10, n=2000, n_pad=n_pad, window=window)
    want = pr.probe_topk(rows, q, starts, k=10, n=2000, n_pad=n_pad, window=window)
    wide = pr.prepare(rows, q, starts, n_pad=n_pad, window=window)[2]
    lib = ex._library("probe_knn")
    budget = lib.probe_tiles_workspace(MIN_M // 3, tries, P, 64, n_pad, wide, 10)
    monkeypatch.setattr(pr, "TILES_WORKSPACE", budget)
    step = lib.probe_tiles_block(tries, P, 64, n_pad, wide, 10, budget)
    assert step >= MIN_M // 3
    blocks = -(-MIN_M // step)
    assert blocks > 1
    before = ex.launches["probe_topk"], ex.launches["probe_topk:tiles"]
    got = pr.probe_topk(rows, q, starts, k=10, n=2000, n_pad=n_pad, window=window)
    assert ex.launches["probe_topk"] == before[0] + blocks
    assert ex.launches["probe_topk:tiles"] == before[1] + blocks
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_tiles_launch_checks_on_card():
    """The tile design's C entry points refuse what they do not take: the
    workspace query answers -1 for rows of d not a multiple of 8 or past 256,
    more than 1,024 windows, k outside [1, 128]; the launch refuses float32
    and int8 rows, rows or queries off the 16-byte grid and a workspace
    smaller than asked for."""
    dev = _card()
    lib = ex._library("probe_knn")
    m, tries, P, d, n_pad, window, k = 4, 2, 3, 64, 512, 64, 10
    assert lib.probe_tiles_workspace(m, tries, P, d, n_pad, window, k) > 0
    for bad in ((m, tries, P, 12, n_pad, window, k), (m, tries, P, 264, n_pad, window, k),
                (m, tries, 1025, d, n_pad, window, k), (m, tries, P, d, n_pad, window, 0),
                (m, tries, P, d, n_pad, window, 129), (m, tries, P, d, n_pad, n_pad + 8, k)):
        assert lib.probe_tiles_workspace(*bad) == -1, bad
        assert lib.probe_tiles_block(*bad[1:], 1 << 30) == -1, bad
    rows = torch.zeros((tries * n_pad, d), dtype=BF16, device=dev)
    q = torch.zeros((m, d), dtype=BF16, device=dev)
    # the same sizes 2 bytes past an allocation
    rows_off = torch.zeros(tries * n_pad * d + 1, dtype=BF16, device=dev)[1:].view(-1, d)
    q_off = torch.zeros(m * d + 1, dtype=BF16, device=dev)[1:].view(-1, d)
    starts = torch.zeros((m, tries, P), dtype=torch.int32, device=dev)
    nbytes = lib.probe_tiles_workspace(m, tries, P, d, n_pad, window, k)
    work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out_d = torch.empty((m, tries, k), device=dev)
    out_i = torch.empty((m, tries, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(dtype=1, r=rows, qq=q, size=nbytes):
        return lib.probe_tiles_launch(ex.device_index(dev), r.data_ptr(), dtype, qq.data_ptr(),
                                      starts.data_ptr(), m, tries, P, d, n_pad, window, n_pad - 1,
                                      k, work.data_ptr(), size, out_d.data_ptr(),
                                      out_i.data_ptr(), stream)

    assert launch() == 0
    torch.cuda.synchronize()
    for bad in (dict(dtype=0), dict(dtype=3), dict(r=rows_off), dict(qq=q_off),
                dict(size=nbytes - 1)):
        assert launch(**bad) != 0, bad
