"""Exact search in a closed loop: ``Server.search`` on an exact server
built once from the configuration's ``serving["exact"]`` spec, batches
from host memory to host memory; ``exact_qps``.

The check: for a sample of the window's answers drawn from the seed, the
widest gap between each returned distance and the distance of the
returned id (``dist_err``) and between the returned ids' true distances
and the reference's k best (``rank_gap``), in float64 over the corpus as
stored.  The control ``{"reference": "tf32"}`` puts the reference with
TF32 products in the program's place; ``{"server": {...}}`` the program
with a setting changed (its own lower tier).
"""

from benchlib import check, reference, system
from benchlib.serve import SearchRun


class Run(SearchRun):
    def make_engine(self, corpus, k: int):
        ctl = self.control_spec()
        if ctl.get("reference") == "tf32":
            return system.ReferenceSearch(corpus, k)
        return system.ServerEngine(corpus, k, {**self.cell.spec, **ctl.get("server", {})},
                                   self.seed)

    def check(self) -> dict:
        k = self.cell.config["k"]
        corpus, _ = self.draw()
        ids, dd, q = self.sampled(corpus.device)
        storage = system.DTYPES[self.cell.spec.get("storage_dtype", "float32")]
        stored = corpus.to(storage)
        del corpus
        med = check.median_sq_norm(stored)
        _, ref_d = reference.knn(stored, check.as_searched(q, storage), k)
        return check.exact_numbers(ids, dd, q, stored, storage, ref_d, med)
