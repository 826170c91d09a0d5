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
        out[name] = (jpv, PackedIndex.load(path))
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


def _card_case(g, dev, dt, m, tries, P, d, n_pad, window, k, n, overlap):
    rows = torch.randn(tries * n_pad, d, generator=g).to(dev)
    q = torch.randn(m, d, generator=g).to(dev)
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
    starts = torch.clamp(starts, max=hi).to(torch.int32).to(dev)
    before = ex.launches["probe_topk"]
    pa, da = pr.probe_topk(rows, q, starts, k=k, n=n, n_pad=n_pad, window=window)
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
    assert ok
    dref = dref[:, :k]
    fin = torch.isfinite(dref)
    assert torch.equal(fin, torch.isfinite(da))
    np.testing.assert_allclose(da[fin].numpy(), dref[fin].numpy(), rtol=1e-5, atol=1e-4)
    assert (pa[~fin] == n).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16", "int8"])
def test_kernel_matches_plain_on_card(dt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    n_pad = 4096
    # (m, tries, P, d, window, k, live bound, overlapping windows)
    for m, tries, P, d, window, k, n, overlap in (
            (200, 4, 18, 128, 96, 10, 4000, False),
            (200, 4, 8, 96, 40, 50, 3000, True),
            (64, 3, 2, 128, 16, 128, 4000, False),
            (1, 1, 1, 128, 8, 10, 4000, False),
            (50, 2, 4, 128, 32, 10, 10, False)):
        _card_case(g, dev, dt, m, tries, P, d, n_pad, window, k, n, overlap)
