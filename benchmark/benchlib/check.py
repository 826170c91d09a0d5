"""The numbers that decide ``correct``, each held to its cell's limit.

Every distance gap is measured against the scale of the arithmetic that
produced it: a query's ``|q|^2`` plus the median ``|x|^2`` of the corpus
(the rank kernel ranks |x|^2 - 2 q.x, so its rounding grows with both).

- ``dist_err``: the widest gap between a returned distance and the
  reference's distance of the returned id (an invalid, repeated or missing
  id reads +inf); in hash search the nearer of its distances over the
  stored rows and over the float32 corpus.
- ``rank_gap``: the widest gap between the sorted true distances of the
  returned ids and the reference's k best (exact search); ``graph_gap``
  the same of sampled kNN-graph rows (index build, hash search).
- ``mismatch_share``: the share of sampled queries whose returned distance
  list departs from the reference's search by more than ``LIST_TOL``
  anywhere (hash search).
- ``code_flips``: the share of (table, row) bucket codes that differ from
  the reference's by a bit whose projection is not within ``CODE_TOL`` of
  zero (index build, hash search).
- ``layout_errors``: entries of the tables, counts and packed view that
  differ from what the codes determine (exact: limit 0).
"""

from __future__ import annotations

import torch

from . import reference as ref

# a returned distance list "departs" past this normalized gap: above float32
# rounding of a distance (about 1e-6 of the scale) and below the gap between
# a distance over bf16-rounded rows and one over the float32 corpus
LIST_TOL = 1e-5
# a code bit may differ from the float64 reference where its projection is
# within this share of the row's centred norm: float32 rounds there
CODE_TOL = 1e-5


def median_sq_norm(corpus: torch.Tensor, dtype=None, block: int = 1 << 20) -> float:
    """Median |x|^2 of the corpus rows as stored in ``dtype``."""
    parts = []
    for lo in range(0, corpus.shape[0], block):
        x = corpus[lo: lo + block]
        x = (x if dtype is None else x.to(dtype)).to(ref.F64)
        parts.append((x * x).sum(1))
    return float(torch.cat(parts).median())


def _scale(q: torch.Tensor, med: float) -> torch.Tensor:
    q = q.to(ref.F64)
    return (q * q).sum(1) + med


def valid_ids(ids: torch.Tensor, n: int, own=None) -> torch.Tensor:
    """(m,) rows whose ids lie in [0, n), differ from each other and from
    ``own`` (a graph row's id)."""
    ids = ids.long()
    ok = ((ids >= 0) & (ids < n)).all(1)
    s = torch.sort(ids, 1).values
    ok &= ~(s[:, 1:] == s[:, :-1]).any(1)
    if own is not None:
        ok &= ~(ids == own[:, None]).any(1)
    return ok


def _widest(gap: torch.Tensor, ok: torch.Tensor) -> float:
    gap = torch.where(ok[:, None], gap, float("inf"))
    return float(gap.max()) if gap.numel() else 0.0


def as_searched(queries: torch.Tensor, storage) -> torch.Tensor:
    """Queries as an exact search over a corpus stored in ``storage`` ranks
    them: rounded to a half type (the stored tier's convention, the JAX
    package's and the port's), float32 otherwise."""
    if storage in (torch.bfloat16, torch.float16):
        return queries.to(storage).float()
    return queries


def exact_numbers(ids, dists, queries, corpus, storage, ref_d, med: float) -> dict:
    """``dist_err`` and ``rank_gap`` of exact answers (ids, dists) to
    ``queries`` over ``corpus`` stored as ``storage``; ``ref_d`` the
    reference's k best distances (of ``queries`` as :func:`as_searched`
    gives them)."""
    n = corpus.shape[0]
    queries = as_searched(queries, storage)
    ok = valid_ids(ids, n)
    safe = ids.long().clamp(0, n - 1)
    true = ref.sqdist(queries, corpus[safe].to(storage))
    s = _scale(queries, med)[:, None]
    derr = (dists.to(ref.F64) - true).abs() / s
    gap = (torch.sort(true, 1).values - ref_d).abs() / s
    return {"dist_err": _widest(derr, ok), "rank_gap": _widest(gap, ok)}


def hash_numbers(ids, dists, queries, hr: "ref.HashReference", med: float,
                 found=None) -> dict:
    """``dist_err`` and ``mismatch_share`` of hash answers against
    :class:`~.reference.HashReference` (``found``: its ``search`` of these
    queries, where already made).  A returned id carries its distance over
    the stored rows (found through a probe) or over the float32 corpus
    (found through the graph): ``dist_err`` takes the nearer of the two.
    Which way an id is found turns on the last of a table's winners and on
    the probe order, which float32 and float64 rank differently where two
    values lie within rounding of each other; which ids are found is
    ``mismatch_share``'s to judge."""
    n = hr.n
    _, r_d, _, _ = hr.search(queries) if found is None else found
    ok = valid_ids(ids, n)
    rows = hr.corpus[ids.long().clamp(0, n - 1)]
    d_stored = ref.sqdist(queries.to(hr.row_dtype), rows.to(hr.row_dtype))
    d_float = ref.sqdist(queries, rows)
    d = dists.to(ref.F64)
    err = torch.minimum((d - d_stored).abs(), (d - d_float).abs())
    s = _scale(queries, med)[:, None]
    gap = (torch.sort(d, 1).values - r_d).abs() / s
    gap = torch.where(ok[:, None], gap, float("inf"))
    miss = (gap > LIST_TOL).any(1)
    return {"dist_err": _widest(err / s, ok),
            "mismatch_share": float(miss.double().mean()) if miss.numel() else 0.0}


def observed_codes(ids: torch.Tensor, starts: torch.Tensor, n: int):
    """Each row's bucket in each table as a packed view places it: (codes
    (tries, n) int64, False if the view's first n slots are not a
    permutation of the rows)."""
    tries = ids.shape[0]
    codes = torch.full((tries, n), -1, dtype=torch.int64, device=ids.device)
    slot = torch.arange(n, device=ids.device)
    perm_ok = True
    for t in range(tries):
        rows = ids[t, :n].long()
        if not torch.equal(torch.sort(rows).values, slot):
            perm_ok = False
            rows = rows.clamp(0, n - 1)
        b = torch.searchsorted(starts[t].long().contiguous(), slot, right=True) - 1
        codes[t, rows] = b
    return codes, perm_ok


def tolerated_codes(got: torch.Tensor, corpus: torch.Tensor, mean, bases):
    """(codes, flips): the reference's float64 codes of every row, with the
    observed code ``got`` in their place where every bit by which it
    differs has its projection within ``CODE_TOL`` of zero; and the share
    of (table, row) codes that differ by any other bit (a row the view lost
    reads as a flip)."""
    want = ref.corpus_codes(corpus, mean, bases)
    t_bad, r_bad = torch.nonzero(got != want, as_tuple=True)
    if not t_bad.numel():
        return want, 0.0
    proj = ref.projections(corpus[r_bad], mean, bases)  # (b, tries, ds)
    p = proj[torch.arange(r_bad.numel(), device=corpus.device), t_bad]
    xc = corpus[r_bad].to(ref.F64) - mean
    near = p.abs() <= CODE_TOL * xc.norm(dim=1, keepdim=True)
    bit = torch.ones((), dtype=torch.int64, device=p.device) << torch.arange(
        p.shape[1] - 1, -1, -1, device=p.device)
    differ = ((got[t_bad, r_bad] ^ want[t_bad, r_bad])[:, None] & bit) != 0
    bad = (differ & ~near).any(1) | (got[t_bad, r_bad] < 0)
    codes = want.clone()
    ok = ~bad
    codes[t_bad[ok], r_bad[ok]] = got[t_bad[ok], r_bad[ok]]
    return codes, int(bad.sum()) / float(got.numel())


def code_flips(got: torch.Tensor, corpus: torch.Tensor, mean, bases) -> float:
    """The share of codes ``got`` that :func:`tolerated_codes` counts as
    flips."""
    return tolerated_codes(got, corpus, mean, bases)[1]


def layout_errors(index, packed, got: torch.Tensor, corpus: torch.Tensor, n_buckets: int,
                  capacity, row_dtype, perm_ok: bool) -> float:
    """Entries of the counts, tables, packed order, starts and rows (in
    ``row_dtype``) that differ from what the codes ``got`` determine."""
    n = corpus.shape[0]
    lay = ref.layout(got.clamp(min=0), n_buckets, capacity)
    errors = 0 if perm_ok else n
    for mine, theirs in ((lay.counts, index.counts), (lay.tables, index.tables),
                         (lay.ids, packed.ids), (lay.starts, packed.starts)):
        theirs = theirs.long()
        errors += (mine.numel() if mine.shape != theirs.shape
                   else int((mine != theirs).sum()))
    rows = ref.stored_rows(corpus, lay.ids.reshape(-1), row_dtype)
    if rows.shape != packed.point_rows.shape or rows.dtype != packed.point_rows.dtype:
        errors += rows.shape[0]
    else:
        errors += int((rows != packed.point_rows).any(1).sum())
    return float(errors)


def graph_gap(graph: torch.Tensor, corpus: torch.Tensor, sample: torch.Tensor, k: int,
              med: float) -> float:
    """The widest ``rank_gap`` of the kNN-graph rows ``sample``."""
    n = corpus.shape[0]
    g = graph[sample].long()
    ok = valid_ids(g, n, own=sample)
    true = ref.sqdist(corpus[sample], corpus[g.clamp(0, n - 1)])
    _, ref_d = ref.knn(corpus, corpus[sample], k, exclude=sample)
    s = _scale(corpus[sample], med)[:, None]
    return _widest((torch.sort(true, 1).values - ref_d).abs() / s, ok)


def build_numbers(built, corpus: torch.Tensor, *, seed: int, k: int, tries: int,
                  capacity, row_dtype, sample: torch.Tensor, med: float) -> dict:
    """``code_flips``, ``layout_errors`` and ``graph_gap`` (graph rows
    ``sample``) of one whole build over ``corpus`` with the build's
    ``seed``.  ``built`` has ``index`` (tables, counts, graph) and
    ``packed`` (ids, starts, point_rows)."""
    n = corpus.shape[0]
    bases = ref.sample_bases(seed, n, k, corpus.shape[1], tries).to(corpus.device)
    mean = corpus.to(ref.F64).mean(0)
    got, perm_ok = observed_codes(built.packed.ids, built.packed.starts, n)
    return {"code_flips": code_flips(got, corpus, mean, bases),
            "layout_errors": layout_errors(built.index, built.packed, got, corpus,
                                           1 << bases.shape[1], capacity, row_dtype, perm_ok),
            "graph_gap": graph_gap(built.index.graph, corpus, sample, k, med)}


def judge(numbers: dict, limits: dict | None) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}).  Without limits (a run that
    calibrates them) nothing passes."""
    out = {}
    correct = limits is not None
    for name, value in numbers.items():
        lim = None if limits is None else limits.get(name)
        out[name] = {"value": value, "limit": lim}
        if lim is None or not value <= lim:
            correct = False
    return correct, out
