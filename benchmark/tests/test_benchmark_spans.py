"""The readers of the program's spans (``benchlib/spans.py``,
``metrics/server.self_ms.py``, ``metrics/search.host_ms.*.py``): the
self-time sum a request, the median over requests, None where there is
nothing to read, and the readings of a real ring on the CPU."""

import pytest
import torch

from benchlib import spans
from benchlib.harness import load_cell

MS = 1_000_000
HASH = "sift-1m.hash-b10000"
STAGES = ("codes", "probe", "merge", "supercharge")


def rec(name, self_ms, parent, request):
    """A record as the program keeps it: (name, start_ns, end_ns, self_ns,
    parent, request, rows)."""
    return (name, 0, int(self_ms * MS), int(self_ms * MS), parent, request, 10)


def batch(request, entry, merge, merge_twice=False):
    out = [rec("search.codes", 1.0, "server.search", request),
           rec("search.merge", merge, "server.search", request)]
    if merge_twice:
        out.append(rec("search.merge", merge, "server.search", request))
    return out + [rec("server.search", entry, None, request)]


@pytest.fixture(autouse=True)
def _fresh_ring():
    from approximatenn_tpu_torch.utils.profiling import reset_spans

    reset_spans()
    yield
    reset_spans()


def test_self_time_summed_within_a_request_and_median_over_requests():
    recs = batch(1, 2.0, 5.0) + batch(2, 3.0, 6.0, merge_twice=True) + batch(3, 40.0, 7.0)
    assert spans.self_ms(recs, "search.merge") == pytest.approx(7.0)
    assert spans.self_ms(recs, "search.codes") == pytest.approx(1.0)
    # the slow third batch moves the mean, not the median
    assert spans.self_ms(recs, "server.search") == pytest.approx(3.0)


def test_only_requests_under_the_root_count():
    recs = batch(1, 2.0, 5.0)
    # a stage run outside Server.search (a root of its own), and a build
    recs += [rec("search.merge", 100.0, None, 2), rec("build.graph", 9.0, "server.build", 3),
             rec("server.build", 1.0, None, 3)]
    assert spans.self_ms(recs, "search.merge") == pytest.approx(5.0)
    assert spans.self_ms(recs, "build.graph") is None
    assert spans.self_ms(recs, "build.graph", root="server.build") == pytest.approx(9.0)


def test_nested_keeps_requests_whose_engine_has_a_span():
    recs = [rec("server.search", 4.0, None, 1)] + batch(2, 2.0, 5.0)
    assert spans.self_ms(recs, "server.search") == pytest.approx(3.0)
    assert spans.self_ms(recs, "server.search", nested=True) == pytest.approx(2.0)
    assert spans.self_ms(recs[:1], "server.search", nested=True) is None


def test_none_without_spans(monkeypatch):
    assert spans.self_ms([], "search.merge") is None
    assert spans.self_ms(batch(1, 2.0, 5.0), "search.probe") is None
    assert spans.records() == [] and spans.stage_ms("server.search") is None
    # a program that keeps no spans (an older one) reads as nothing
    from approximatenn_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert spans.records() == []


def test_the_hash_cell_reads_the_programs_ring(monkeypatch):
    """The hash cell's five span metrics, read by the readers the harness
    loads, from a ring a packed fused search filled on the CPU."""
    import approximatenn_tpu_torch as tann
    import approximatenn_tpu_torch.engine.serving as serving

    g = torch.Generator().manual_seed(5)
    X = torch.randn(1500, 16, generator=g)
    Y = torch.randn(30, 16, generator=g)
    srv = tann.Server.build(X, 5, mode="hash", layout="packed", tries=3, seed=1, window=16)
    cell = load_cell(HASH)
    names = ["server.self_ms.hash"] + [f"search.host_ms.{s}" for s in STAGES]
    assert all(n in cell.readers for n in names)
    assert all(cell.readers[n](None) is None for n in names)
    # the probe kernel's route, its plain version on the CPU
    monkeypatch.setattr(serving, "packed_route", lambda *a, **k: "fused")
    for _ in range(3):
        srv.search(Y)
    got = {n: cell.readers[n](None) for n in names}
    assert all(v is not None and v >= 0 for v in got.values()), got
    recs = spans.records()
    roots = [r for r in recs if r[0] == "server.search"]
    assert len(roots) == 3
    # a request's self times add up to its root's duration
    for r in roots:
        assert sum(x[3] for x in recs if x[5] == r[5]) == r[2] - r[1]
