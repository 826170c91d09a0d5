"""Approximate search through the packed hash index in a closed loop:
``Server.search`` on a hash server built once (with the run's seed) from
the configuration's ``serving["hash"]`` spec; ``hash_qps``.

The check works the served index out again from the corpus and the
seed, and compares on it:

- ``code_flips``: the served index's bucket codes (read from its packed
  order) against float64 codes from the seed's hash bases, a bit that
  differs counting only where its projection is not within rounding of
  zero;
- ``layout_errors``: the counts, tables, packed order, starts and stored
  rows against what those codes determine (exact);
- ``graph_gap``: the served kNN graph's rows that the sampled searches
  expand, and a sample of all rows drawn from the seed, against float64
  brute force;
- ``dist_err``: each sampled answer's distances against its ids' distances
  over the stored rows or the float32 corpus, whichever is nearer (the way
  an id is found turns on ties within rounding);
- ``mismatch_share``: the sampled answers' distance lists against the
  packed search worked out again (:class:`~benchlib.reference.HashReference`).

The reference follows the served codes only where they differ from its
own by a tolerated bit, and the served graph only once ``graph_gap`` has
judged it: a code within rounding of zero decides the slot of every later
row of its table, so the search could not be followed otherwise.

The control ``{"reference": "tf32"}`` puts the reference's index (TF32
projections, TF32 exact graph) and search (TF32 projections and
distances) in the program's place; ``{"server": {...}}`` the program with
a setting changed.
"""

import torch

from benchlib import check, system
from benchlib import reference as ref
from benchlib.serve import SearchRun

# graph rows the check reads besides those the sampled searches expand
GRAPH_SAMPLE = 1024


class Run(SearchRun):
    def make_engine(self, corpus, k: int):
        ctl = self.control_spec()
        spec = {**self.cell.spec, **ctl.get("server", {})}
        if ctl.get("reference") == "tf32":
            return system.ReferenceHashSearch(corpus, k, spec, self.seed)
        return system.ServerEngine(corpus, k, spec, self.seed)

    def release(self):
        self.index_state = self.engine.index_state()
        self.engine = None

    def check(self) -> dict:
        spec = self.cell.spec
        k = self.cell.config["k"]
        corpus, _ = self.draw()
        dev = corpus.device
        n, d = corpus.shape
        ids, dd, q = self.sampled(dev)
        row_dtype = system.DTYPES[spec["packed_dtype"]]
        med = check.median_sq_norm(corpus)
        index, packed = self.index_state
        self.index_state = None
        bases = ref.sample_bases(self.seed, n, k, d, spec["tries"]).to(dev)
        mean = corpus.to(ref.F64).mean(0)
        got, perm_ok = check.observed_codes(packed.ids, packed.starts, n)
        codes, flips = check.tolerated_codes(got, corpus, mean, bases)
        numbers = {"code_flips": flips,
                   "layout_errors": check.layout_errors(
                       index, packed, codes, corpus, 1 << bases.shape[1],
                       spec.get("capacity"), row_dtype, perm_ok)}
        graph = packed.graph
        hr = ref.HashReference(corpus, k=k, seed=self.seed, tries=spec["tries"],
                               n_probes=spec["n_probes"], window=spec["window"],
                               row_dtype=row_dtype, bases=bases, mean=mean, codes=codes,
                               graph=graph.long())
        found = hr.search(q)
        t1 = found[2].reshape(-1)
        rows = torch.unique(torch.cat([t1[t1 < n],
                                       self.sample(n, GRAPH_SAMPLE, salt=1).to(dev)]))
        numbers["graph_gap"] = check.graph_gap(graph, corpus, rows, k, med)
        numbers.update(check.hash_numbers(ids, dd, q, hr, med, found))
        self.hash_reference = hr
        return numbers

    def context(self):
        ctx = super().context()
        hr = getattr(self, "hash_reference", None)
        if hr is not None and self.slice is not None:
            # the slots a batch covers do not depend on its order
            b, P = self.cell.traffic["batch"], self.pool.shape[0]
            starts = [(j * b) % P for j in self.slice_batches]
            per = {lo: hr.distinct_slots(self.queries(lo // b).to(hr.corpus.device))
                   for lo in set(starts)}
            ctx.probe_slots = sum(per[lo] for lo in starts) / len(starts)
        return ctx
