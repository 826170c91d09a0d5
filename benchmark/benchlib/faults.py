"""Faults planted underneath the timed path, for the tests that show
``correct`` coming out false and for the readings that set a limit
(``calibrate.py --faults``).  Each wraps a search engine (``Run``'s
``wrap``); the state the check reads stays the program's own.

- ``stale``: the state returned unchanged, the last batch's answers;
- ``half``: half of the batch left out;
- ``altered``: an answer altered where it is produced;
- ``drop_table``: one hash table's winners lost (the last table's ids all
  the sentinel while it searches);
- ``drop_probes``: three of the directed probes skipped;
- ``codes``: rows of the first hash table moved into other buckets of the
  served index (ids and rows of slot pairs swapped);
- ``graph``: the served kNN graph's first neighbour altered in every
  other row.
"""

from __future__ import annotations

import dataclasses

import torch


class Broken:
    """A search engine broken underneath ``Server.search``."""

    def __init__(self, engine, fault: str):
        self.engine, self.fault, self.last = engine, fault, None
        if fault == "drop_table":
            srv = engine.server
            ids = srv.packed.ids.clone()
            ids[-1] = srv.packed.n
            self.broken_view = dataclasses.replace(srv.packed, ids=ids)
        elif fault == "codes":
            pv = engine.server.packed
            n = pv.n
            a = torch.arange(0, n // 2, 7, device=pv.ids.device)
            b = n - 1 - a
            pv.ids[0, a], pv.ids[0, b] = pv.ids[0, b].clone(), pv.ids[0, a].clone()
            pv.point_rows[a], pv.point_rows[b] = pv.point_rows[b].clone(), pv.point_rows[a].clone()
        elif fault == "graph":
            g = engine.server.packed.graph
            g[::2, 0] = (g[::2, 0] + 1) % g.shape[0]

    def describe(self):
        return self.engine.describe()

    def index_state(self):
        return self.engine.index_state()

    def search(self, q):
        if self.fault == "drop_table":
            srv = self.engine.server
            view, srv.packed = srv.packed, self.broken_view
            try:
                return self.engine.search(q)
            finally:
                srv.packed = view
        if self.fault == "drop_probes":
            srv = self.engine.server
            return srv.search(q, n_probes=srv.n_probes - 3)
        ids, dd = self.engine.search(q)
        if self.fault in ("codes", "graph"):
            return ids, dd
        if self.fault == "stale":
            out, self.last = (self.last or (ids, dd)), (ids, dd)
            return out
        if self.fault == "half":
            b = q.shape[0] // 2
            ids, dd = ids.clone(), dd.clone()
            ids[b:], dd[b:] = ids[:b].max() + 1, float("inf")
            return ids, dd
        if self.fault == "altered":
            ids = ids.clone()
            ids[:, 0] = (ids[:, 0] + 1) % (int(ids.max()) + 1)
            return ids, dd
        raise ValueError(f"unknown fault {self.fault!r}")


def wrap(fault: str):
    """``Run``'s ``wrap`` for a search fault."""
    return lambda engine: Broken(engine, fault)


def broken_build(fault: str, min_rows: int):
    """``Run``'s ``wrap`` for a build fault, on builds of ``min_rows`` rows
    or more (the warm-up's prefix build left sound)."""
    def wrap_build(build_fn):
        first = []

        def build(corpus, k, spec, seed, st=None):
            built = build_fn(corpus, k, spec, seed, st)
            if corpus.shape[0] < min_rows:
                return built
            if fault == "stale":
                first.append(built)
                return first[0]
            g = built.index.graph
            if fault == "half":
                g[g.shape[0] // 2:] = g.shape[0]
            elif fault == "altered":
                g[::2, 0] = (g[::2, 0] + 1) % g.shape[0]
            else:
                raise ValueError(f"unknown fault {fault!r}")
            return built
        return build
    return wrap_build
