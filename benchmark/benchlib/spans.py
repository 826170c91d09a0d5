"""The program's spans as the benchmark reads them: the ring of span
records that ``approximatenn_tpu_torch.utils.profiling`` keeps in memory
(``spans()``; a record is ``(name, start_ns, end_ns, self_ns, parent,
request, rows)``), reduced to one stage's host milliseconds a request.

This file and ``system.py`` are the benchmark's two importers of the
program; this one imports it when the records are read, never when it is
imported.  A program that keeps no spans yields no records, and every
reading is then None (the metric is left out of the line).
"""

from __future__ import annotations

import statistics

ROOT = "server.search"


def records() -> list:
    """The program's span records, oldest first; [] where it keeps none."""
    from approximatenn_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return [] if read is None else read()


def self_ms(recs, name: str, root: str = ROOT, nested: bool = False) -> float | None:
    """Median over the requests rooted at a ``root`` span of the summed
    self time of their spans named ``name``, in milliseconds; None where no
    such request holds such a span.  ``nested``: only the requests in which
    the root has a child span (where the engine below a root has no span,
    the root's self time is the engine's too).  The median leaves out the
    few slower requests of a run (the warm-up, the profiled slice, the sync
    count)."""
    roots = {r[5] for r in recs if r[0] == root and r[4] is None}
    if nested:
        roots &= {r[5] for r in recs if r[4] == root}
    sums: dict = {}
    for r in recs:
        if r[0] == name and r[5] in roots:
            sums[r[5]] = sums.get(r[5], 0) + r[3]
    if not sums:
        return None
    return statistics.median(sums.values()) * 1e-6


def stage_ms(name: str, nested: bool = False) -> float | None:
    """:func:`self_ms` of stage ``name`` over the run's records."""
    return self_ms(records(), name, nested=nested)
