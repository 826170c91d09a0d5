"""The closed loop of one client that the serving kinds share: a batch
starts with its queries in host memory and ends with its ids and
distances in host memory; the next starts when it ends.  The queries are
the pool over and over, each pass in its own order (``ORDERS``
permutations drawn from the seed, cycled), ``traffic["batch"]`` queries a
batch: a batch of the whole pool is the same set each time, never in the
last batch's order, so answers kept from an earlier batch read wrong.

A mix's ``host_memory`` says where the client keeps its batches and
answers: ``"pageable"`` (the default: ``.cpu()``, copies the host stages)
or ``"pinned"`` (page-locked buffers, as a GPU-serving client keeps them:
the copies are the DMA engines' work, so the rate does not follow the
load of the host's cores; on an H100 pageable copies took ~2.5 ms of the
1M exact cell's ~89 ms batch).
"""

from __future__ import annotations

import time

import torch

from . import tracing
from .harness import RunBase

# the traced slice: after this much of the window, about this long
SLICE_AFTER_S = 1.0
SLICE_S = 1.5
# orders of the query pool, cycled pass after pass
ORDERS = 16
# where the client keeps its batches and answers (a mix's ``host_memory``)
HOST_MEMORY = ("pageable", "pinned")


def to_host(x: torch.Tensor, pinned: bool) -> torch.Tensor:
    """``x`` in host memory; ``pinned``: a copy into a fresh page-locked
    buffer, in flight until the stream is synchronized."""
    if not pinned:
        return x.cpu()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return out.copy_(x, non_blocking=True)


class SearchRun(RunBase):
    """A kind that serves batches: ``make_engine`` builds the system (or
    the control) once, the window runs the closed loop, and ``<kind>_qps``
    is the queries answered over the window's seconds."""

    # sampled answers the reference judges
    SAMPLE = 2048

    def make_engine(self, corpus, k: int):
        raise NotImplementedError

    def setup(self):
        self.prepare()
        corpus, pool = self.draw()
        self.n, self.d = corpus.shape
        self.pool = pool.cpu()
        del pool
        g = torch.Generator().manual_seed((self.seed * 40503 + 11) % (1 << 63))
        P = self.pool.shape[0]
        self.passes = [self.pool[torch.randperm(P, generator=g)]
                       for _ in range(ORDERS)]
        memory = self.cell.traffic.get("host_memory", "pageable")
        if memory not in HOST_MEMORY:
            raise ValueError(f"host_memory {memory!r}: one of {HOST_MEMORY}")
        self.pinned = self.on_card and memory == "pinned"
        if self.pinned:
            self.passes = [p.pin_memory() for p in self.passes]
        self.engine = self.make_engine(corpus, self.cell.config["k"])
        if self.wrap:
            self.engine = self.wrap(self.engine)
        del corpus
        b = self.cell.traffic["batch"]
        if self.pool.shape[0] % b:
            raise ValueError("the query pool must hold whole batches")
        # the warm-up takes the cycle's first batches, the window goes on
        self.first_batch = self.cell.traffic.get("warmup_batches", 2)
        for i in range(self.first_batch):
            self._batch(i)

    def queries(self, i: int) -> torch.Tensor:
        """Batch i's queries (host memory, contiguous)."""
        b, P = self.cell.traffic["batch"], self.pool.shape[0]
        return self.passes[(i * b // P) % len(self.passes)][(i * b) % P:][:b]

    def _batch(self, i: int):
        """One batch of the closed loop: (host seconds in the search call,
        latency, ids, dists)."""
        q = self.queries(i)
        t = time.perf_counter()
        with torch.profiler.record_function("bench.search"):
            ids, dd = self.engine.search(q)
        t1 = time.perf_counter()
        with torch.profiler.record_function("bench.to_host"):
            ids, dd = to_host(ids, self.pinned), to_host(dd, self.pinned)
            if self.pinned:
                torch.cuda.current_stream(self.device).synchronize()
        return t1 - t, time.perf_counter() - t, ids, dd

    def window(self):
        host, lat, answers, untraced = [], [], [], []
        start = time.perf_counter()
        end = start + self.seconds
        i = i0 = self.first_batch
        while i == i0 or time.perf_counter() < end:
            if (self.trace and self.slice is None
                    and time.perf_counter() - start >= min(SLICE_AFTER_S, self.seconds / 4)):
                est = sum(lat[-8:]) / max(1, len(lat[-8:])) if lat else 0.01
                reps = max(4, min(400, int(SLICE_S / max(est, 1e-4))))
                with tracing.Slice(self.counters) as s:
                    for _ in range(reps):
                        _, t_lat, ids, dd = self._batch(i)
                        answers.append((ids, dd))
                        lat.append(t_lat)
                        i += 1
                    s.calls = reps
                self.slice = s.result
                self.slice_batches = range(i - reps, i)
                continue
            h, t_lat, ids, dd = self._batch(i)
            host.append(h)
            lat.append(t_lat)
            untraced.append(t_lat)
            answers.append((ids, dd))
            i += 1
        self.window_s = time.perf_counter() - start
        self.answers, self.host_s, self.latency_s = answers, host, lat
        self.untraced_latency_s = untraced

    def after_window(self):
        self.syncs = None
        if self.trace and self.on_card:
            self.syncs = self.system.count_syncs(lambda: self.engine.search(self.queries(0)))

    def describe(self):
        return self.engine.describe() if hasattr(self.engine, "describe") else None

    def quantities(self) -> dict:
        nq = len(self.answers) * self.cell.traffic["batch"]
        return {f"{self.cell.kind}_qps": nq / self.window_s}

    def release(self):
        self.engine = None

    def attempted(self) -> int:
        return len(self.answers) * self.cell.traffic["batch"]

    def sampled(self, device):
        """(ids, dists, queries) of the answers the check judges: a sample
        drawn from the seed of every query answered in the window."""
        b = self.cell.traffic["batch"]
        pick = self.sample(len(self.answers) * b, self.SAMPLE).tolist()
        ids = torch.stack([self.answers[j // b][0][j % b] for j in pick]).to(device)
        dd = torch.stack([self.answers[j // b][1][j % b] for j in pick]).to(device)
        q = torch.stack([self.queries(self.first_batch + j // b)[j % b] for j in pick])
        return ids, dd, q.to(device)

    def context(self):
        return self.base_context(batch=self.cell.traffic["batch"], host_s=self.host_s,
                                 latency_s=self.untraced_latency_s, syncs=self.syncs,
                                 stages=None, probe_slots=None)
