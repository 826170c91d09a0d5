"""The port's spans (``approximatenn_tpu_torch/utils/profiling.py``): nesting,
self time and one request id per root; the ring's bound; no
``record_function`` and no card operation while no profiler records, and
``user_annotation`` ranges while one does; the spans of the packed fused
search, of ``Server.build`` and of the update path.

The ``cuda`` case runs the exact engines, the packed search and a build on
the card:

    python -m pytest --noconftest tests/test_torch_spans.py -m cuda -q
"""

import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import approximatenn_tpu_torch as tann
from approximatenn_tpu_torch.engine.search import search_packed_fused
from approximatenn_tpu_torch.utils import profiling
from approximatenn_tpu_torch.utils.profiling import (StageTimes, reset_spans, span,
                                                     span_summary, spans)

STAGES = ["search.codes", "search.probe", "search.merge", "search.supercharge"]
BUILD = ["build.hash", "build.tables", "build.graph", "build.pack"]


@pytest.fixture(autouse=True)
def _fresh_ring():
    reset_spans()
    yield
    reset_spans()


def _data(n=1500, d=16, m=40, seed=3):
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    Y = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    return X, Y


def _packed_server(X, **kw):
    return tann.Server.build(X, 5, mode="hash", layout="packed", tries=3, seed=1,
                             window=16, **kw)


def test_spans_nest_with_self_time_and_one_request_per_root():
    with span("root") as root:
        with span("a", rows=7):
            sum(range(20000))
        with span("b"):
            with span("c"):
                sum(range(20000))
        root.rows = 3
    with span("root"):
        pass
    recs = {(r.name, r.request): r for r in spans()}
    assert [r.name for r in spans()] == ["a", "c", "b", "root", "root"]
    first, second = [r for r in spans() if r.name == "root"]
    assert first.request != second.request and first.parent is None
    assert first.rows == 3 and recs[("a", first.request)].rows == 7
    a, b, c = (recs[(name, first.request)] for name in "abc")
    assert (a.parent, b.parent, c.parent) == ("root", "root", "b")
    dur = {r.name: r.end_ns - r.start_ns for r in (a, b, c, first)}
    assert first.self_ns == dur["root"] - dur["a"] - dur["b"]
    assert b.self_ns == dur["b"] - dur["c"] and c.self_ns == dur["c"]
    assert first.start_ns <= a.start_ns < a.end_ns <= b.start_ns < b.end_ns <= first.end_ns
    summary = span_summary()
    assert summary["root"][0] == 2 and summary["c"][0] == 1
    assert summary["b"][1] == pytest.approx(dur["b"] * 1e-9)
    assert summary["b"][2] == pytest.approx((dur["b"] - dur["c"]) * 1e-9)


def test_a_span_records_when_its_region_raises():
    with pytest.raises(KeyError):
        with span("outer"):
            with span("inner"):
                raise KeyError("x")
    assert [(r.name, r.parent) for r in spans()] == [("inner", "outer"), ("outer", None)]
    with span("after"):
        pass
    assert spans()[-1].parent is None


def test_threads_keep_their_own_nesting_and_the_totals_lose_nothing():
    import sys
    import threading

    per, workers = 400, 8
    errors = []

    def work():
        try:
            for _ in range(per):
                with span("t.outer"):
                    with span("t.inner"):
                        pass
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    summary = span_summary()
    assert summary["t.outer"][0] == summary["t.inner"][0] == per * workers
    # the totals are kept per name, not per thread: an ended thread leaves none
    assert set(profiling._totals) == {"t.outer", "t.inner"}
    recs = spans()
    outer = {r.request for r in recs if r.name == "t.outer"}
    assert len(outer) == per * workers
    assert all(r.parent == "t.outer" and r.request in outer
               for r in recs if r.name == "t.inner")


def test_the_ring_is_bounded():
    for i in range(profiling.RING + 10):
        with span("s", rows=i):
            pass
    recs = spans()
    assert len(recs) == profiling.RING
    assert recs[0].rows == 10 and recs[-1].rows == profiling.RING + 9
    assert span_summary()["s"][0] == profiling.RING + 10
    reset_spans()
    assert spans() == [] and span_summary() == {}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_no_record_function_and_no_device_work_without_a_profiler(monkeypatch, tmp_path):
    made = []
    real = profiling.record_function

    def counting(name):
        made.append(name)
        return real(name)

    def no_sync(*a, **kw):
        raise AssertionError("a span synchronized the card")

    monkeypatch.setattr(profiling, "record_function", counting)
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    with _Ops() as mode:
        with span("quiet.outer"):
            with span("quiet.inner", rows=2):
                pass
    assert made == [] and mode.ops == []
    assert [r.name for r in spans()] == ["quiet.inner", "quiet.outer"]

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("loud.outer"):
            with span("loud.inner"):
                torch.ones(8).sum()
    assert made == ["loud.outer", "loud.inner"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    marks = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"loud.outer", "loud.inner"} <= marks
    assert not {"quiet.outer", "quiet.inner"} & marks


def test_fused_search_records_its_four_stages_in_one_request():
    X, Y = _data()
    pv = _packed_server(X).packed
    ids, dd = search_packed_fused(pv, queries=Y)
    reset_spans()
    with span("caller"):
        ids0, dd0 = search_packed_fused(pv, queries=Y)
    recs = spans()
    assert [r.name for r in recs] == STAGES + ["caller"]
    assert {r.request for r in recs} == {recs[-1].request}
    assert all(r.parent == "caller" and r.rows == Y.shape[0] for r in recs[:-1])
    assert all(r.self_ns == r.end_ns - r.start_ns for r in recs[:-1])
    torch.testing.assert_close(ids0, ids, rtol=0, atol=0)
    torch.testing.assert_close(dd0, dd, rtol=0, atol=0)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ids1, dd1 = search_packed_fused(pv, queries=Y)
    names = {e.name for e in prof.events()}
    assert set(STAGES) <= names
    torch.testing.assert_close(ids1, ids, rtol=0, atol=0)
    torch.testing.assert_close(dd1, dd, rtol=0, atol=0)


def test_server_search_is_the_root_span():
    X, Y = _data()
    srv = tann.Server.build(X, 5, mode="exact")
    reset_spans()
    srv.search(Y)
    srv.search(Y[:7].numpy())
    recs = spans()
    assert [(r.name, r.parent, r.rows) for r in recs] == [
        ("server.search", None, Y.shape[0]), ("server.search", None, 7)]
    assert recs[0].request != recs[1].request


def test_server_build_records_its_stages_under_one_root():
    X, _ = _data()
    st = StageTimes()
    _packed_server(X, stage_times=st)
    assert list(st.totals) == ["hash", "tables", "graph", "pack"]
    recs = spans()
    assert [r.name for r in recs] == BUILD + ["server.build"]
    root = recs[-1]
    assert root.parent is None and root.rows == X.shape[0]
    assert all(r.parent == "server.build" and r.request == root.request
               and r.rows == X.shape[0] for r in recs[:-1])
    assert root.self_ns >= 0

    reset_spans()
    _packed_server(X)
    assert [r.name for r in spans()] == BUILD + ["server.build"]
    reset_spans()
    tann.build(X, 5, tries=3, seed=1, graph_mode="hash")
    # the hash graph builds its tables in its own stage; with no root each
    # stage is a request of its own
    recs = spans()
    assert [r.name for r in recs] == ["build.hash", "build.graph"]
    assert recs[0].request != recs[1].request and recs[0].parent is None


def test_add_points_ranges_are_spans():
    X, Y = _data()
    srv = _packed_server(X)
    reset_spans()
    srv.add_points(Y)
    names = [r.name for r in spans()]
    for name in ("add_points: bucket append", "add_points: exact rows",
                 "add_points: reverse-edge repair", "add_points: re-pack"):
        assert name in names
    rows = {r.name: r.rows for r in spans() if r.name.startswith("add_points:")}
    assert set(rows.values()) == {Y.shape[0]}


@pytest.fixture
def one_rank_mesh():
    """A one-rank gloo group on an in-process store and its CPU mesh,
    destroyed after the test."""
    import torch.distributed as dist

    from approximatenn_tpu_torch.parallel import multihost
    from approximatenn_tpu_torch.parallel.sharded import make_mesh

    multihost.initialize(backend="gloo", timeout=60)
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_sharded_server_spans_nest_under_sharded_search(one_rank_mesh, monkeypatch):
    """``sharded.build`` is the build's root; ``sharded.search`` the search's,
    with the engine's span and ``sharded.merge`` as its children in one
    request, its self time what they leave; no ``record_function`` while no
    profiler records, ranges on the trace while one does."""
    from approximatenn_tpu_torch.parallel.serving import ShardedServer

    X, Y = _data()
    srv = ShardedServer.build(X.to(torch.bfloat16), 5, mesh=one_rank_mesh, mode="exact",
                              storage_dtype=torch.bfloat16)
    assert [(r.name, r.parent, r.rows) for r in spans()] == [("sharded.build", None, X.shape[0])]
    # the two-phase engine, which a card mesh routes to, forced on the CPU
    srv._route_twophase = lambda *a, **kw: True
    made = []
    real = profiling.record_function
    monkeypatch.setattr(profiling, "record_function", lambda name: made.append(name) or real(name))
    reset_spans()
    ids, dd = srv.search(Y)
    recs = spans()
    assert [(r.name, r.parent) for r in recs] == [
        ("exact.twophase", "sharded.search"), ("sharded.merge", "sharded.search"),
        ("sharded.search", None)]
    assert {r.request for r in recs} == {recs[-1].request}
    assert all(r.rows == Y.shape[0] for r in recs)
    root = recs[-1]
    assert root.self_ns == (root.end_ns - root.start_ns) - sum(
        r.end_ns - r.start_ns for r in recs[:-1])
    assert made == []

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ids1, dd1 = srv.search(Y)
    assert made == ["sharded.search", "exact.twophase", "sharded.merge"]
    assert {"sharded.search", "exact.twophase", "sharded.merge"} <= {e.name for e in prof.events()}
    assert torch.equal(ids, ids1) and torch.equal(dd, dd1)


@pytest.mark.cuda
def test_the_engines_spans_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    X, Y = _data(n=20000, d=32, m=300)
    X, Y = X.cuda(), Y.cuda()
    rank = tann.Server.build(X, 10, mode="exact")
    two = tann.Server.build(X, 10, mode="exact", twophase_min_n=1000)
    hashed = _packed_server(X)
    reset_spans()
    rank.search(Y)
    two.search(Y)
    hashed.search(Y)
    torch.cuda.synchronize()
    recs = spans()
    by_req: dict = {}
    for r in recs:
        by_req.setdefault(r.request, []).append(r.name)
    assert list(by_req.values()) == [["exact.rank", "server.search"],
                                     ["exact.twophase", "server.search"],
                                     STAGES + ["server.search"]]
    reset_spans()
    _packed_server(X)
    names = [r.name for r in spans()]
    # the exact graph: one rank launch a chunk, inside build.graph
    assert names == ["build.hash", "build.tables", "exact.rank", "build.graph",
                     "build.pack", "server.build"]
    assert spans()[2].parent == "build.graph"
