"""The plain reference: what every cell's answers should be, worked out
again from the benchmark's own inputs in float64 with plain PyTorch.

It imports nothing of the program under test and takes nothing the
program made.  Where the program's semantics fix a convention that decides
which rows are candidates (the hash transforms drawn from the build's
seed, the bucket-CSR order, the probe windows' alignment), this file
states it again as a frozen copy and derives it from the inputs:

- ``sample_bases``: the structured-orthogonal hash transforms, drawn from a
  CPU ``torch.Generator`` seeded with the build's seed in the order the
  index build draws them (Givens layers, embedding and projection
  permutations), materialised in float64.
- ``HashReference``: sign codes of every corpus row, the stable bucket
  order of each table, the directed probes of a query (own bucket, then
  the cheapest 1- and 2-bit flips by summed |projection|), each probe's
  window of the packed order widened to the probe's alignment, the
  per-table top-k over the rows as stored (bf16 rounding of query and
  row), the cross-table merge by id, and one supercharge round through
  the exact kNN graph over the float32 corpus.
- ``knn``: exhaustive k-NN in float64 (the reference) or with TF32
  products (the control of a float32 configuration).
- ``layout``: the padded bucket tables and the packed view that a set of
  codes determines.
"""

from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace

import torch

F64 = torch.float64


# --------------------------------------------------------------- exact k-NN
@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 products on or off for the block (restored after)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties away
    from zero), as TF32 products take their operands."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "float64") -> torch.Tensor:
    """``a @ b``; with ``precision="tf32"`` TF32 products: the operands
    rounded to TF32 (on any device, so the CPU computes what the card's
    TF32 tensor cores do), float32 accumulation."""
    if precision != "tf32":
        return a @ b
    with tf32(True):
        return round_tf32(a) @ round_tf32(b)


def sqdist(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Squared L2 in diff form, float64: queries (..., d), rows (..., L, d)
    -> (..., L)."""
    diff = rows.to(F64) - queries.to(F64)[..., None, :]
    return (diff * diff).sum(-1)


def knn(corpus: torch.Tensor, queries: torch.Tensor, k: int, *, exclude=None,
        precision: str = "float64", corpus_block: int = 1 << 17,
        query_block: int = 2048):
    """Exhaustive k nearest rows of ``corpus`` (any float type, ranked as
    stored) for each query: (ids int64 (m, k), squared distances (m, k)).

    ``precision="float64"``: scores in float64, then the k + 8 best
    re-scored in diff form and sorted by (distance, id); distances float64.
    ``precision="tf32"``: the control of a float32 configuration, scores
    |x|^2 - 2 q.x with TF32 products and the k best by those scores, |q|^2
    added; distances float32.  ``exclude``: (m,) row id a query may not
    return (a graph row's own id)."""
    m, n = queries.shape[0], corpus.shape[0]
    dt = F64 if precision == "float64" else torch.float32
    kk = min(n, k + 8) if precision == "float64" else min(n, k)
    out_i, out_d = [], []
    for qlo in range(0, m, query_block):
        q = queries[qlo: qlo + query_block].to(dt)
        ex = None if exclude is None else exclude[qlo: qlo + query_block].long()
        best_d = best_i = None
        for lo in range(0, n, corpus_block):
            xb = corpus[lo: lo + corpus_block].to(dt)
            s = (xb * xb).sum(1)[None, :] - 2.0 * matmul(q, xb.T, precision)
            if ex is not None:
                inside = (ex >= lo) & (ex < lo + xb.shape[0])
                rows = torch.nonzero(inside).squeeze(1)
                s[rows, ex[rows] - lo] = float("inf")
            d, i = torch.topk(s, min(kk, s.shape[1]), dim=1, largest=False)
            i = i + lo
            if best_d is not None:
                d, i = torch.cat([best_d, d], 1), torch.cat([best_i, i], 1)
                d, j = torch.topk(d, min(kk, d.shape[1]), dim=1, largest=False)
                i = torch.gather(i, 1, j)
            best_d, best_i = d, i
        if precision == "float64":
            dd = sqdist(q, corpus[best_i])
            if ex is not None:
                dd = torch.where(best_i == ex[:, None], float("inf"), dd)
            # sort by (distance, id): id first, then a stable sort by distance
            o = torch.argsort(best_i, dim=1)
            best_i, dd = torch.gather(best_i, 1, o), torch.gather(dd, 1, o)
            o = torch.sort(dd, dim=1, stable=True).indices[:, :k]
            out_i.append(torch.gather(best_i, 1, o))
            out_d.append(torch.gather(dd, 1, o))
        else:
            out_i.append(best_i[:, :k])
            out_d.append(best_d[:, :k] + (q * q).sum(1, keepdim=True))
    return torch.cat(out_i), torch.cat(out_d)


# ------------------------------------------------- hash transforms (frozen)
def derive_d_short(n: int, k: int, d: int) -> int:
    """Bits of a bucket code: ceil(log2(n / k)) clamped to [0, d_max], d_max
    the next power of two >= d (d_max when n < k)."""
    d_max = 1 if d <= 1 else 1 << (d - 1).bit_length()
    if n < k:
        return d_max
    return min(max(0, math.ceil(math.log2(n / k))), d_max)


def _rot_layers(gen, rots: int, rot_len: int, dim: int):
    layers = []
    for _ in range(rots):
        coords = torch.randperm(dim, generator=gen)[: 2 * rot_len]
        a = torch.rand(rot_len, generator=gen, dtype=F64) * math.pi
        # the index keeps its angles in float32
        layers.append((coords[0::2], coords[1::2], a.to(torch.float32).to(F64)))
    return layers


def _rotate(x, layers):
    for i, j, a in layers:
        c, s = torch.cos(a), torch.sin(a)
        xi, xj = x[:, i], x[:, j]
        x = x.clone()
        x[:, i] = xi * c - xj * s
        x[:, j] = xi * s + xj * c
    return x


def _walsh(x):
    d = x.shape[-1]
    h = 1
    while h < d:
        y = x.reshape(-1, d // (2 * h), 2, h)
        x = torch.stack((y[:, :, 0] + y[:, :, 1], y[:, :, 0] - y[:, :, 1]), 2).reshape(-1, d)
        h *= 2
    return x / math.sqrt(d)


def sample_bases(seed: int, n: int, k: int, d: int, tries: int, *, rots_before: int = 6,
                 rot_len_before: int = 1, rots_after: int = 1,
                 rot_len_after: int = 1) -> torch.Tensor:
    """The index's hash bases (tries, d_short, d), float64 on the CPU: each
    table's chain (Givens layers in d, embedding permutation d -> d_max,
    orthonormal Walsh-Hadamard, Givens layers in d_max, projection to the
    first d_short coordinates of a permutation) applied to the identity,
    drawn from ``torch.Generator().manual_seed(seed)`` in the build's
    order."""
    gen = torch.Generator().manual_seed(int(seed))
    d_short = derive_d_short(n, k, d)
    d_max = 1 if d <= 1 else 1 << (d - 1).bit_length()
    out = []
    for _ in range(tries):
        before = _rot_layers(gen, rots_before, rot_len_before, d)
        after = _rot_layers(gen, rots_after, rot_len_after, d_max)
        perm_b = torch.randperm(d_max, generator=gen)
        perm_ai = torch.randperm(d_max, generator=gen)
        x = _rotate(torch.eye(d, dtype=F64), before)
        x = torch.where(perm_b < d, x[:, perm_b.clamp(max=d - 1)], torch.zeros((), dtype=F64))
        x = _rotate(_walsh(x), after)
        x = x[:, torch.argsort(perm_ai)[:d_short]]
        out.append(x.T)
    return torch.stack(out)


def pack_signs(proj: torch.Tensor) -> torch.Tensor:
    """Sign bits of the last axis as an int64 code, coordinate 0 the most
    significant bit; -0.0 counts as negative."""
    ds = proj.shape[-1]
    w = torch.ones((), dtype=torch.int64, device=proj.device) << torch.arange(
        ds - 1, -1, -1, device=proj.device)
    return (torch.signbit(proj).long() * w).sum(-1)


def projections(x: torch.Tensor, mean: torch.Tensor, bases: torch.Tensor,
                precision: str = "float64") -> torch.Tensor:
    """(x - mean) against every basis row: (m, tries, d_short); float64, or
    float32 with TF32 products for the control."""
    tries, ds, d = bases.shape
    dt = F64 if precision == "float64" else torch.float32
    p = matmul(x.to(dt) - mean.to(dt), bases.reshape(tries * ds, d).to(dt).T, precision)
    return p.reshape(x.shape[0], tries, ds)


def corpus_codes(corpus: torch.Tensor, mean, bases, precision: str = "float64",
                 block: int = 1 << 18) -> torch.Tensor:
    """Codes (tries, n) int64 of every corpus row."""
    parts = [pack_signs(projections(corpus[lo: lo + block], mean, bases, precision))
             for lo in range(0, corpus.shape[0], block)]
    return torch.cat(parts).T.contiguous()


def directed_probes(codes: torch.Tensor, proj: torch.Tensor, n_probes: int) -> torch.Tensor:
    """The own code, then the ``n_probes - 1`` cheapest 1- and 2-bit flips
    (a flip costs the summed |projection| of its bits; ties to the earlier
    flip, singles before pairs, pairs in row-major upper-triangle order):
    (..., n_probes) codes; the own code repeats past the flips."""
    ds = proj.shape[-1]
    dev = proj.device
    a = proj.abs()
    single = torch.ones((), dtype=torch.int64, device=dev) << torch.arange(ds - 1, -1, -1,
                                                                          device=dev)
    iu, ju = torch.triu_indices(ds, ds, offset=1, device=dev)
    costs = torch.cat([a, a[..., iu] + a[..., ju]], -1)
    masks = torch.cat([single, single[iu] | single[ju]])
    n_extra = min(n_probes - 1, masks.shape[0])
    pos = torch.sort(costs, dim=-1, stable=True).indices[..., :n_extra]
    probes = torch.cat([torch.zeros(codes.shape + (1,), dtype=torch.int64, device=dev),
                        masks[pos]], -1)
    out = codes[..., None] ^ probes
    if n_extra + 1 < n_probes:
        out = torch.cat([out, codes[..., None].expand(codes.shape + (n_probes - n_extra - 1,))],
                        -1)
    return out


def capacity(counts: torch.Tensor, rule) -> int:
    """Bucket capacity: "auto" = min(max occupancy, ceil(max(32 x mean, 8)));
    None = max occupancy; an int is kept."""
    if rule == "auto":
        mean = counts.double().mean().item()
        return max(1, int(min(int(counts.max()), math.ceil(max(32.0 * mean, 8.0)))))
    if rule is None:
        return max(1, int(counts.max()))
    return max(1, int(rule))


def csr(codes: torch.Tensor, n_buckets: int, *, row_align: int = 8, super_width: int = 2):
    """The packed view's order that codes (tries, n) determine: ids (tries,
    n_pad) (rows sorted stably by bucket, sentinel n in the tail) and
    starts (tries, n_buckets) (each bucket's first slot), n_pad = n + 1
    rounded up to lcm(super_width, row_align)."""
    tries, n = codes.shape
    dev = codes.device
    n_pad = -(-(n + 1) // math.lcm(super_width, row_align)) * math.lcm(super_width, row_align)
    ids = torch.full((tries, n_pad), n, dtype=torch.int64, device=dev)
    starts = torch.empty((tries, n_buckets), dtype=torch.int64, device=dev)
    for t in range(tries):
        order = torch.argsort(codes[t], stable=True)
        ids[t, :n] = order
        starts[t] = torch.searchsorted(codes[t][order], torch.arange(n_buckets, device=dev))
    return ids, starts, n_pad


def layout(codes: torch.Tensor, n_buckets: int, cap_rule, *, row_align: int = 8,
           super_width: int = 2):
    """What a set of codes (tries, n) determines: counts (tries, n_buckets),
    the padded tables (tries, n_buckets, cap) of ids in stable bucket order
    (sentinel n past each bucket's first cap), and the packed view's ids
    and starts (:func:`csr`)."""
    tries, n = codes.shape
    dev = codes.device
    counts = torch.stack([torch.bincount(c, minlength=n_buckets)[:n_buckets] for c in codes])
    cap = capacity(counts, cap_rule)
    ids, starts, n_pad = csr(codes, n_buckets, row_align=row_align, super_width=super_width)
    tables = torch.full((tries, n_buckets, cap), n, dtype=torch.int64, device=dev)
    for t in range(tries):
        order = ids[t, :n]
        sc = codes[t][order]
        rank = torch.arange(n, device=dev) - torch.searchsorted(sc, sc)
        keep = rank < cap
        tables[t, sc[keep], rank[keep]] = order[keep]
    return SimpleNamespace(counts=counts, cap=cap, tables=tables, ids=ids, starts=starts,
                           n_pad=n_pad)


def stored_rows(corpus: torch.Tensor, ids: torch.Tensor, dtype) -> torch.Tensor:
    """The packed view's rows: corpus rows ``ids`` in ``dtype``, +inf where
    an id is the sentinel n."""
    n = corpus.shape[0]
    rows = corpus[ids.clamp(max=n - 1)].to(dtype)
    return torch.where((ids >= n)[..., None], torch.full((), float("inf"), dtype=dtype,
                                                         device=rows.device), rows)


# ------------------------------------------------------------ hash search
class HashReference:
    """The packed hash search of a configuration, worked out from the
    corpus, the build's seed and the serving knobs.  ``codes`` and
    ``graph``, where given, replace the reference's own corpus codes and
    exact graph: a code of a row whose projection is within rounding of
    zero decides which slot every later row of its table takes, so the
    search can be followed exactly only on the index's own codes, which
    are checked on their own (``check.build_numbers``).

    ``search(q)`` gives, per query, the final ids and their distances as
    the search defines them: a row found through a probe carries its
    distance over the stored rows (query and row rounded to ``row_dtype``),
    a row found through the graph its distance over the float32 corpus,
    and a row found both ways the smaller.  A graph id outside the corpus
    is no candidate.

    ``precision="tf32"`` is the control of a float32 configuration: query
    projections and distances (|x|^2 - 2 q.x + |q|^2) in float32 with TF32
    products, in the program's place."""

    # a probe window is widened to whole groups of this many slots and
    # its start rounded down to one (float rows; the probe's alignment)
    ROW_ALIGN = 8

    def __init__(self, corpus: torch.Tensor, *, k: int, seed: int, tries: int,
                 n_probes: int, window: int, row_dtype, bases=None, mean=None,
                 codes=None, graph=None, precision: str = "float64"):
        self.corpus, self.k, self.precision = corpus, k, precision
        n, d = corpus.shape
        self.n, self.d = n, d
        self.n_probes, self.row_dtype = n_probes, row_dtype
        dev = corpus.device
        self.bases = (sample_bases(seed, n, k, d, tries) if bases is None else bases).to(dev)
        self.mean = corpus.to(F64).mean(0) if mean is None else mean
        self.codes = corpus_codes(corpus, self.mean, self.bases) if codes is None else codes
        ds = self.bases.shape[1]
        self.ids, self.starts, self.n_pad = csr(self.codes, 1 << ds, row_align=self.ROW_ALIGN)
        self.window = min(window, self.n_pad)
        a = self.ROW_ALIGN
        self.wide = min(-(-(self.window + a - 1) // a) * a, self.n_pad)
        # a graph given (the program's, checked on its own) is followed
        self.graph = graph
        self._graph: dict = {}

    def windows(self, q: torch.Tensor) -> torch.Tensor:
        """Each probe's widened window start, (m, tries, P)."""
        proj = projections(q, self.mean, self.bases, self.precision)
        probes = directed_probes(pack_signs(proj), proj, self.n_probes)
        t = torch.arange(self.bases.shape[0], device=q.device)[None, :, None]
        start = torch.clamp(self.starts[t, probes], max=self.n_pad - self.window)
        a = self.ROW_ALIGN
        return torch.clamp(start // a, 0, (self.n_pad - self.wide) // a) * a

    def distinct_slots(self, q: torch.Tensor) -> int:
        """Packed slots (over all tables) that the windows of these queries
        cover together: the rows a probe pass over them has to read."""
        st = self.windows(q)
        tries = st.shape[1]
        hit = torch.zeros((tries, self.n_pad + 1), dtype=torch.int32, device=q.device)
        t = torch.arange(tries, device=q.device)[None, :, None].expand_as(st)
        hit.index_put_((t.reshape(-1), st.reshape(-1)),
                       torch.ones((), dtype=torch.int32, device=q.device), accumulate=True)
        hit.index_put_((t.reshape(-1), (st + self.wide).reshape(-1)),
                       torch.full((), -1, dtype=torch.int32, device=q.device), accumulate=True)
        covered = torch.cumsum(hit, 1)[:, : self.n] > 0
        return int(covered.sum())

    def graph_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """Exact k-NN rows (own id excluded) of corpus rows ``ids``, or the
        given graph's rows."""
        if self.graph is not None:
            return self.graph[ids]
        need = [i for i in torch.unique(ids).tolist() if i not in self._graph]
        if need:
            nid = torch.tensor(need, device=self.corpus.device)
            g, _ = knn(self.corpus, self.corpus[nid], self.k, exclude=nid)
            for i, row in zip(need, g):
                self._graph[i] = row
        return torch.stack([self._graph[i] for i in ids.reshape(-1).tolist()]).reshape(
            ids.shape + (self.k,))

    def dist(self, q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """Squared L2 of queries (..., d) to rows (..., L, d) at the
        reference's precision: (..., L)."""
        if self.precision == "float64":
            return sqdist(q, rows)
        qf, rf = q.float(), rows.float()
        dot = matmul(rf, qf[..., :, None], "tf32")[..., 0]
        return (rf * rf).sum(-1) - 2.0 * dot + (qf * qf).sum(-1)[..., None]

    def _probe_pass(self, q: torch.Tensor):
        """Per table, the k nearest window slots by (stored distance, slot),
        merged across tables by id: (ids (B, k), distances (B, k))."""
        B, tries = q.shape[0], self.bases.shape[0]
        st = self.windows(q)
        lane = torch.arange(self.wide, device=q.device)
        slots = torch.sort((st[..., None] + lane).reshape(B, tries, -1), -1).values
        dup = torch.zeros_like(slots, dtype=torch.bool)
        dup[..., 1:] = slots[..., 1:] == slots[..., :-1]
        t = torch.arange(tries, device=q.device)[None, :, None]
        ids = self.ids[t, slots]
        qs = q.to(self.row_dtype)
        dd = self.dist(qs[:, None, :], self.corpus[ids.clamp(max=self.n - 1)].to(self.row_dtype))
        dd = torch.where(dup | (slots >= self.n), float("inf"), dd)
        o = torch.sort(dd, dim=-1, stable=True).indices[..., : self.k]
        tid = torch.gather(ids, -1, o).reshape(B, -1)
        tdd = torch.gather(dd, -1, o).reshape(B, -1)
        return merge_by_id(tid, tdd, self.k)

    def search(self, queries: torch.Tensor, block: int = 16):
        """(ids (m, k), distances (m, k) float64, probe-pass ids (m, k),
        graph ids (m, k * k)) of the search."""
        passes = [self._probe_pass(queries[lo: lo + block])
                  for lo in range(0, queries.shape[0], block)]
        t1 = torch.cat([p[0] for p in passes])
        d1 = torch.cat([p[1] for p in passes])
        exp = self.graph_rows(t1.clamp(max=self.n - 1)).reshape(t1.shape[0], -1)
        exp = torch.where(((exp >= 0) & (exp < self.n)).reshape(exp.shape)
                          & (t1 < self.n).repeat_interleave(self.k, 1), exp, self.n)
        dexp = self.dist(queries, self.corpus[exp.clamp(max=self.n - 1)])
        dexp = torch.where(exp < self.n, dexp, float("inf"))
        ids, dd = merge_by_id(torch.cat([t1, exp], 1), torch.cat([d1, dexp], 1), self.k)
        return ids, dd, t1, exp


def merge_by_id(ids: torch.Tensor, dd: torch.Tensor, k: int):
    """Per row: each id once at its smallest distance, then the k smallest
    by (distance, position)."""
    L = ids.shape[1]
    pos = torch.arange(L, device=ids.device).expand_as(ids)
    # order by (id, distance, position) through stable sorts, minor key first
    o = torch.sort(dd, dim=1, stable=True).indices
    o = torch.gather(o, 1, torch.sort(torch.gather(ids, 1, o), dim=1, stable=True).indices)
    sid, sdd, spos = (torch.gather(x, 1, o) for x in (ids, dd, pos))
    first = torch.ones_like(sid, dtype=torch.bool)
    first[:, 1:] = sid[:, 1:] != sid[:, :-1]
    sdd = torch.where(first, sdd, float("inf"))
    # back to position order, then a stable sort by distance
    back = torch.argsort(spos, 1)
    sid, sdd = torch.gather(sid, 1, back), torch.gather(sdd, 1, back)
    o = torch.sort(sdd, dim=1, stable=True).indices[:, :k]
    return torch.gather(sid, 1, o), torch.gather(sdd, 1, o)
