"""The plain reference against brute force and loops at tiny sizes, and its
frozen copies of the index's conventions against the program's own."""

import itertools

import numpy as np
import pytest
import torch

from benchlib import check, data
from benchlib import reference as ref


def _brute(corpus, queries, k, exclude=None):
    x = corpus.double().numpy()
    q = queries.double().numpy()
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    if exclude is not None:
        d[np.arange(len(q)), exclude.numpy()] = np.inf
    ids = np.lexsort((np.broadcast_to(np.arange(len(x)), d.shape), d), axis=1)[:, :k]
    return ids, np.take_along_axis(d, ids, 1)


@pytest.mark.parametrize("n,block", [(257, 64), (1000, 1000)])
def test_knn_float64_is_brute_force(n, block):
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, 12, generator=g)
    q = torch.randn(37, 12, generator=g)
    ids, d = ref.knn(x, q, 5, corpus_block=block, query_block=16)
    want_i, want_d = _brute(x, q, 5)
    assert np.array_equal(ids.numpy(), want_i)
    assert np.allclose(d.numpy(), want_d, rtol=1e-12)


def test_knn_excludes_own_row():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(300, 8, generator=g)
    own = torch.arange(0, 300, 7)
    ids, _ = ref.knn(x, x[own], 4, exclude=own, corpus_block=50)
    want, _ = _brute(x, x[own], 4, exclude=own)
    assert np.array_equal(ids.numpy(), want)


def test_knn_half_corpus_ranks_stored_values():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(400, 16, generator=g).to(torch.bfloat16)
    q = torch.randn(9, 16, generator=g).to(torch.bfloat16).float()
    ids, d = ref.knn(x, q, 6)
    want_i, want_d = _brute(x.float(), q, 6)
    assert np.array_equal(ids.numpy(), want_i)
    assert np.allclose(d.numpy(), want_d)


def test_merge_by_id_is_the_loop():
    g = torch.Generator().manual_seed(7)
    ids = torch.randint(0, 12, (20, 30), generator=g)
    dd = torch.randint(0, 6, (20, 30), generator=g).double()
    got_i, got_d = ref.merge_by_id(ids, dd, 5)
    for r in range(20):
        best = {}
        for pos, (i, v) in enumerate(zip(ids[r].tolist(), dd[r].tolist())):
            if i not in best or v < best[i][0]:
                best[i] = (v, pos)
        want = sorted(best.items(), key=lambda kv: (kv[1][0], kv[1][1]))[:5]
        assert got_i[r].tolist() == [i for i, _ in want]
        assert got_d[r].tolist() == [v for _, (v, _) in want]


def test_directed_probes_enumerate_cheapest_flips():
    g = torch.Generator().manual_seed(11)
    ds = 6
    proj = torch.randn(4, ds, generator=g, dtype=torch.float64)
    codes = ref.pack_signs(proj)
    got = ref.directed_probes(codes, proj, 9)
    for r in range(4):
        a = proj[r].abs().tolist()
        flips = [((a[i],), 1 << (ds - 1 - i)) for i in range(ds)]
        flips += [((a[i] + a[j],), (1 << (ds - 1 - i)) | (1 << (ds - 1 - j)))
                  for i, j in itertools.combinations(range(ds), 2)]
        order = sorted(range(len(flips)), key=lambda p: (flips[p][0], p))[:8]
        want = [int(codes[r])] + [int(codes[r]) ^ flips[p][1] for p in order]
        assert got[r].tolist() == want


def test_layout_is_the_loop():
    g = torch.Generator().manual_seed(13)
    codes = torch.randint(0, 8, (2, 50), generator=g)
    lay = ref.layout(codes, 8, 3)
    for t in range(2):
        order = [i for b in range(8) for i in range(50) if codes[t, i] == b]
        assert lay.ids[t, :50].tolist() == order
        assert lay.ids[t, 50:].tolist() == [50] * (lay.n_pad - 50)
        for b in range(8):
            members = [i for i in range(50) if codes[t, i] == b]
            assert lay.starts[t, b] == sum(int((codes[t] == c).sum()) for c in range(b))
            row = members[:3] + [50] * (3 - len(members[:3]))
            assert lay.tables[t, b].tolist() == row
    assert lay.n_pad == 56


@pytest.mark.parametrize("d", [32, 33, 128])
def test_bases_are_the_programs(d):
    from approximatenn_tpu_torch.engine.build import sample_bases

    n, k, tries = 5000, 10, 3
    mine = ref.sample_bases(2**31 + 17, n, k, d, tries)
    ds = mine.shape[1]
    theirs = sample_bases(torch.Generator().manual_seed(2**31 + 17), d, ds, tries, 6, 1, 1, 1,
                          torch.float32)
    assert torch.allclose(mine.float(), theirs, atol=1e-6)
    if d & (d - 1) == 0:
        eye = mine @ mine.transpose(1, 2)
        assert torch.allclose(eye, torch.eye(ds, dtype=torch.float64).expand_as(eye),
                              atol=1e-12)


def test_draw_is_seeded_and_held_out():
    cfg = {"n": 3000, "d": 8, "n_queries": 100,
           "data": {"kind": "clustered_gaussian", "n_clusters": 50, "spread": 4.0, "zipf": 1.2}}
    a, qa = data.draw(cfg, 2**31 + 5, "cpu")
    b, qb = data.draw(cfg, 2**31 + 5, "cpu")
    c, _ = data.draw(cfg, 2**31 + 6, "cpu")
    assert torch.equal(a, b) and torch.equal(qa, qb) and not torch.equal(a, c)
    assert a.shape == (3000, 8) and qa.shape == (100, 8)
    # held out: no query is a corpus row
    assert torch.cdist(qa, a).min() > 0


def test_valid_ids():
    ids = torch.tensor([[0, 1, 2], [0, 0, 1], [0, 1, 5], [3, 1, 2]])
    ok = check.valid_ids(ids, 5, own=torch.tensor([4, 4, 4, 3]))
    assert ok.tolist() == [True, False, False, False]
