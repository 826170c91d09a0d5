"""Exact search over a corpus sharded across the cell's cards, in a closed
loop: ``ShardedServer.search`` of a server built once from the
configuration's ``serving["sharded"]`` spec, each rank over its own rows
drawn on its card, batches from rank 0's host memory to answers in rank 0's
host memory; ``exact_qps``.

This process launches the ranks (``benchlib/sharded.py``: one a card, rank
0 the client, the window, the traced slice and the check) and reports rank
0's result; ``device`` holds the card count and the fullest card's
``memory_peak_bytes``.  The check: for a sample of the window's answers
drawn from the seed, ``dist_err`` and ``rank_gap`` in float64 over the
corpus as stored, each shard ranked by the rank that holds it and the
shards' lists merged by (distance, global id).  The control ``{"server":
{...}}`` puts the program with a setting changed (its own lower tier) in
the program's place; a fault of ``faults.py`` is planted on every rank.
"""

from benchlib import sharded, system
from benchlib.harness import RunBase


class Run(RunBase):
    def run(self) -> dict:
        if self.on_card:
            self.kernel_build_s = system.prepare()
        out = sharded.launch_ranks(
            self.cell, seed=self.seed, seconds=self.seconds, trace=self.trace,
            control=self.control, wrap=self.wrap, t0=self.t0, sizes=self.sizes,
            device="cuda" if self.on_card else "cpu", world=int(self.cell.workload["chips"]))
        self.describe_line = out["describe"]
        return out["result"]
