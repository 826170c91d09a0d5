"""The exact-engine and serving-mode decisions of every entry point, as
one table: ``ops/twophase.py:route`` (what ``exact_search`` runs on a
CUDA corpus), ``Server._route_twophase`` / ``exact_engine``,
``ShardedServer._route_twophase`` / ``describe``, the ``twophase=None``
default of ``search_exact_sharded`` and both servers' ``mode="auto"``.

No card is needed: the CUDA side is read through stand-ins.  A ``Server``
gets a corpus stand-in that reports a CUDA device (the decisions read only
its device, shape and row width); a ``ShardedServer`` gets its mesh's
device replaced.  Where a search has to run, the mesh's device is
:class:`Card`, a device name that reports type "cuda" and places tensors
on the CPU, and the engines are replaced by recorders.  No JAX: the rules
are held to the JAX package by ``test_torch_deep10m.py::
test_server_auto_route_matches_jax`` and ``test_torch_sharded_serving.py::
test_route_twophase_predicate``.
"""

import dataclasses
import importlib
from types import SimpleNamespace

import pytest
import torch

import approximatenn_tpu_torch as tann
from approximatenn_tpu_torch.engine import serving
from approximatenn_tpu_torch.ops import exact as ex
from approximatenn_tpu_torch.ops import twophase as tp
from approximatenn_tpu_torch.parallel import serving as psrv
from approximatenn_tpu_torch.parallel import sharded as sh

torch.set_num_threads(1)

MIN_N = tp.TWOPHASE_MIN_N  # the rule's threshold, whatever its value
E = serving.EXACT_MAX_N_DEFAULT  # auto mode's bound for 4-byte rows
BF16, F64, I8 = torch.bfloat16, torch.float64, torch.int8


class Card(str):
    """A mesh device that the routing reads as a card and torch places on
    the CPU."""

    type = "cuda"


def _mesh(device=torch.device("cpu"), size: int = 1) -> sh.Mesh:
    return sh.Mesh(group=None, rank=0, size=size, device=device)


def _on_card(srv: tann.Server) -> tann.Server:
    pts = srv.points
    return dataclasses.replace(srv, points=SimpleNamespace(
        device=torch.device("cuda"), shape=pts.shape, dtype=pts.dtype,
        element_size=pts.element_size))


# name: (entry point, its inputs, its answer).
# "route": (n, k, kw, no_twophase) -> the engine on a CUDA corpus.
# "server": Server.build(n x 4 rows of dtype, k, mode="exact",
#   twophase_min_n=tp_min) on a stand-in card -> exact_engine(**kw), with
#   _route_twophase true exactly where that is "cuda-twophase".
# "sharded": the same ShardedServer on a one-rank mesh ("card": the
#   mesh's device replaced by a CUDA one) -> describe()'s exact_engine at
#   its k, with _route_twophase(k, no_twophase) true exactly where the
#   engine is "twophase".
# "default": search_exact_sharded(n x 1 rows, k, twophase=None) -> the
#   function it calls: "twophase" (exact_knn_twophase) or "exact_search"
#   (no_twophase=True, which routes k > 128 itself).
# "auto": Server / ShardedServer.build(n x 1 rows of dtype, k,
#   mode=...) -> the mode, or the ValueError's message.
ROUTES = {
    # the routing rule itself
    "small_n_rank": ("route", (MIN_N - 1, 10, {}, False), "rank"),
    "large_n_twophase": ("route", (MIN_N, 10, {}, False), "twophase"),
    "two_phase_knobs": ("route", (MIN_N, 10, {"seg": 64, "rescan": "xla"}, False), "twophase"),
    "k_plus_2_over_128": ("route", (MIN_N, 127, {}, False), "rank"),
    "no_twophase": ("route", (MIN_N, 10, {}, True), "rank"),
    "rank_knob_pinned": ("route", (MIN_N, 10, {"merge": "rank"}, False), "rank"),
    "big_k": ("route", (10_000, 200, {}, False), "twophase"),
    "big_k_no_twophase": ("route", (10_000, 200, {}, True), "twophase"),
    "big_k_near_n": ("route", (1_000, 200, {}, False), "brute"),
    "big_k_rank_knob": ("route", (10_000, 200, {"merge": "rank"}, False), "brute"),
    # at the two-phase threshold a pinned knob keeps the rank family
    "merge_rescan": ("route", (MIN_N, 10, {"merge": "rescan"}, False), "rank"),
    "stream": ("route", (MIN_N, 10, {"stream": True}, False), "rank"),
    "compute_dtype": ("route", (MIN_N, 10, {"compute_dtype": BF16}, False), "rank"),
    "rescan_big_k": ("route", (10_000, 200, {"merge": "rescan"}, False), "brute"),
    "k_128_rank": ("route", (MIN_N, 128, {}, False), "rank"),
    "k_126_twophase": ("route", (MIN_N, 126, {}, False), "twophase"),
    "big_k_at_bound": ("route", (8 * 202, 200, {}, False), "twophase"),
    "big_k_under_bound": ("route", (8 * 202 - 1, 200, {}, False), "brute"),
    # the single-card Server
    "server_cpu": ("server", dict(n=3000, k=10, tp_min=1000, cpu=True), "oracle"),
    "server_twophase": ("server", dict(n=3000, k=10, tp_min=1000), "cuda-twophase"),
    "server_at_min_n": ("server", dict(n=3000, k=10, tp_min=3000), "cuda-twophase"),
    "server_below_min_n": ("server", dict(n=3000, k=10, tp_min=3001), "cuda-rank"),
    "server_no_twophase": ("server", dict(n=3000, k=10, tp_min=1000,
                                          kw={"no_twophase": True}), "cuda-rank"),
    "server_seg_knobs": ("server", dict(n=3000, k=10, tp_min=1000,
                                        kw={"seg": 32, "pad_segments": 3}), "cuda-twophase"),
    "server_merge": ("server", dict(n=3000, k=10, tp_min=1000, kw={"merge": "rescan"}),
                     "cuda-rescan"),
    "server_stream": ("server", dict(n=3000, k=10, tp_min=1000, kw={"stream": True}),
                      "cuda-stream"),
    "server_compute_dtype": ("server", dict(n=3000, k=10, tp_min=1000,
                                            kw={"compute_dtype": BF16}), "cuda-rank"),
    "server_k127": ("server", dict(n=3000, k=127, tp_min=1000), "cuda-rank"),
    "server_k128": ("server", dict(n=3000, k=128, tp_min=1000), "cuda-rank"),
    "server_k200": ("server", dict(n=3000, k=200, tp_min=1000), "cuda-twophase"),
    "server_k200_below_min_n": ("server", dict(n=3000, k=200, tp_min=5000), "cuda-twophase"),
    "server_k200_no_twophase": ("server", dict(n=3000, k=200, tp_min=1000,
                                               kw={"no_twophase": True}), "cuda-twophase"),
    "server_k200_merge": ("server", dict(n=3000, k=200, tp_min=1000, kw={"merge": "rescan"}),
                          "oracle"),
    "server_k_near_n": ("server", dict(n=3000, k=2990, tp_min=1000), "oracle"),
    "server_float64": ("server", dict(n=3000, k=10, tp_min=1000, dtype=F64), "cuda-rank"),
    "server_float64_k200": ("server", dict(n=3000, k=200, tp_min=1000, dtype=F64),
                            "cuda-twophase"),
    "server_bf16": ("server", dict(n=3000, k=10, tp_min=1000, dtype=BF16), "cuda-twophase"),
    # the sharded server, one rank
    "sharded_cpu": ("sharded", dict(n=3000, k=10, tp_min=1000, card=False), "rank"),
    "sharded_twophase": ("sharded", dict(n=3000, k=10, tp_min=1000), "twophase"),
    "sharded_at_min_n": ("sharded", dict(n=3000, k=10, tp_min=3000), "twophase"),
    "sharded_below_min_n": ("sharded", dict(n=3000, k=10, tp_min=3001), "rank"),
    "sharded_no_twophase": ("sharded", dict(n=3000, k=10, tp_min=1000, no_tp=True), "rank"),
    "sharded_k127": ("sharded", dict(n=3000, k=127, tp_min=1000), "rank"),
    "sharded_k128": ("sharded", dict(n=3000, k=128, tp_min=1000), "rank"),
    "sharded_float64": ("sharded", dict(n=3000, k=10, tp_min=1000, dtype=F64), "rank"),
    "sharded_bf16": ("sharded", dict(n=3000, k=10, tp_min=1000, dtype=BF16), "twophase"),
    "sharded_cpu_k200": ("sharded", dict(n=3000, k=200, tp_min=1000, card=False), "rank"),
    # the describe repair: the engine a k > 128 search runs
    "sharded_k200": ("sharded", dict(n=8 * 202, k=200, tp_min=1000), "twophase"),
    "sharded_k200_near_n": ("sharded", dict(n=8 * 202 - 1, k=200, tp_min=1000), "oracle"),
    # search_exact_sharded's default
    "default_cpu": ("default", dict(n=MIN_N, k=10, card=False), "exact_search"),
    "default_twophase": ("default", dict(n=MIN_N, k=10), "twophase"),
    "default_below_min_n": ("default", dict(n=MIN_N - 1, k=10), "exact_search"),
    "default_k127": ("default", dict(n=MIN_N, k=127), "exact_search"),
    "default_k200": ("default", dict(n=10_000, k=200), "exact_search"),
    # auto mode: exact up to exact_max_n rows (x2 for 2-byte, x4 for
    # 1-byte stored rows), k > 128 where the big-k route applies, int8
    "server_auto_f32": ("auto", dict(cls="server", n=E), "exact"),
    "server_auto_f32_past": ("auto", dict(cls="server", n=E + 1), "hash"),
    "server_auto_bf16": ("auto", dict(cls="server", n=2 * E, dtype=BF16), "exact"),
    "server_auto_bf16_past": ("auto", dict(cls="server", n=2 * E + 1, dtype=BF16), "hash"),
    "server_auto_int8_rows": ("auto", dict(cls="server", n=4 * E, dtype=I8), "exact"),
    "server_auto_int8_rows_past": ("auto", dict(cls="server", n=4 * E + 1, dtype=I8), "hash"),
    "server_auto_quantized": ("auto", dict(cls="server", n=300, storage=I8, max_n=100),
                              "exact"),
    "server_auto_max_n": ("auto", dict(cls="server", n=300, max_n=100), "hash"),
    "server_auto_k128": ("auto", dict(cls="server", n=300, k=128), "exact"),
    "server_auto_k129_near_n": ("auto", dict(cls="server", n=8 * 131 - 1, k=129), "hash"),
    "server_auto_k200": ("auto", dict(cls="server", n=8 * 202, k=200), "exact"),
    "server_auto_k200_near_n": ("auto", dict(cls="server", n=8 * 202 - 1, k=200), "hash"),
    "server_int8_hash": ("auto", dict(cls="server", n=300, storage=I8, mode="hash"),
                         "exact engine only"),
    "server_bad_mode": ("auto", dict(cls="server", n=300, mode="banana"), "unknown mode"),
    "sharded_auto_f32": ("auto", dict(cls="sharded", n=E), "exact"),
    "sharded_auto_f32_past": ("auto", dict(cls="sharded", n=E + 1), "hash"),
    "sharded_auto_bf16": ("auto", dict(cls="sharded", n=2 * E, storage=BF16), "exact"),
    "sharded_auto_bf16_past": ("auto", dict(cls="sharded", n=2 * E + 1, storage=BF16), "hash"),
    # rows stored as float32 when storage_dtype is None, whatever they came in
    "sharded_auto_bf16_rows": ("auto", dict(cls="sharded", n=E + 1, dtype=BF16), "hash"),
    "sharded_auto_quantized": ("auto", dict(cls="sharded", n=5 * E, storage=I8), "exact"),
    "sharded_auto_max_n": ("auto", dict(cls="sharded", n=300, max_n=100), "hash"),
    "sharded_auto_k200": ("auto", dict(cls="sharded", n=8 * 202, k=200), "exact"),
    "sharded_auto_k200_near_n": ("auto", dict(cls="sharded", n=8 * 202 - 1, k=200), "hash"),
    "sharded_int8_hash": ("auto", dict(cls="sharded", n=300, storage=I8, mode="hash"),
                          "exact engine only"),
    "sharded_bad_mode": ("auto", dict(cls="sharded", n=300, mode="banana"), "unknown mode"),
}


def _server(p, want):
    X = torch.zeros((p["n"], 4), dtype=p.get("dtype", torch.float32))
    srv = tann.Server.build(X, p["k"], mode="exact", twophase_min_n=p["tp_min"])
    srv = srv if p.get("cpu") else _on_card(srv)
    kw = dict(p.get("kw", {}))
    assert srv.exact_engine(**kw) == want
    assert srv.describe(**kw)["exact_engine"] == want
    no_tp = bool(kw.pop("no_twophase", False))
    assert srv._route_twophase(p["k"], no_tp, kw) == (want == "cuda-twophase")


def _sharded(p, want):
    X = torch.zeros((p["n"], 4), dtype=torch.float32)
    srv = psrv.ShardedServer.build(X, p["k"], mesh=_mesh(), mode="exact",
                                   twophase_min_n=p["tp_min"], storage_dtype=p.get("dtype"))
    if p.get("card", True):
        srv = dataclasses.replace(srv, mesh=_mesh(torch.device("cuda")))
    no_tp = p.get("no_tp", False)
    assert srv._route_twophase(p["k"], no_tp) == (want == "twophase")
    if not no_tp:
        assert srv.describe()["exact_engine"] == want


def _default(p, want, monkeypatch):
    seen = []

    def recorder(name):
        def run(points, queries, k, **kw):
            seen.append((name, k, kw))
            m = queries.shape[0]
            return torch.zeros((m, k), dtype=torch.int32), torch.zeros((m, k))
        return run

    monkeypatch.setattr(tp, "exact_knn_twophase", recorder("twophase"))
    monkeypatch.setattr(ex, "exact_search", recorder("exact_search"))
    monkeypatch.setattr(sh, "_merge", lambda mesh, ids, dd, n_local, n, k: (ids, dd))
    mesh = _mesh(Card("cpu") if p.get("card", True) else torch.device("cpu"))
    X = torch.zeros((p["n"], 1))
    sh.search_exact_sharded(X, torch.zeros((2, 1)), p["k"], mesh=mesh)
    assert [name for name, *_ in seen] == [want]
    if want == "exact_search":
        assert seen[0][2]["no_twophase"] is True


def _auto(p, want, monkeypatch):
    stub = SimpleNamespace()
    build_mod = importlib.import_module("approximatenn_tpu_torch.engine.build")
    monkeypatch.setattr(build_mod, "build", lambda *a, **kw: (stub, None, None))
    monkeypatch.setattr(psrv, "build_sharded", lambda *a, **kw: stub)
    monkeypatch.setattr(psrv, "_all_reduce_max", lambda mesh, t: t)  # one rank
    dtype = p.get("dtype", torch.float32)
    kw = dict(mode=p.get("mode", "auto"), storage_dtype=p.get("storage"),
              exact_max_n=p.get("max_n"), layout="table")
    k = p.get("k", 10)

    def build():
        if p["cls"] == "server":
            # the rows themselves: 1 column, 32 MB at the largest
            return tann.Server.build(torch.zeros((p["n"], 1), dtype=dtype), k, **kw)
        # one row standing for a rank's slice of p["n"]: the mode reads the
        # slice size, the build the rows
        rows = sh.LocalRows(torch.zeros((1, 1), dtype=dtype), (p["n"], 1))
        return psrv.ShardedServer.build(rows, k, mesh=_mesh(), **kw)

    if want in ("exact", "hash"):
        assert build().mode == want
    else:
        with pytest.raises(ValueError, match=want):
            build()


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_exact_route_table(case, monkeypatch):
    entry, p, want = ROUTES[case]
    if entry == "route":
        assert tp.route(*p) == want
    elif entry == "server":
        _server(p, want)
    elif entry == "sharded":
        _sharded(p, want)
    elif entry == "default":
        _default(p, want, monkeypatch)
    else:
        _auto(p, want, monkeypatch)


@pytest.mark.parametrize("n,size,want", [(8 * 202, 1, "twophase"), (8 * 202 - 1, 1, "oracle"),
                                         (2 * 8 * 202, 2, "twophase"),
                                         (2 * 8 * 202 - 1, 2, "oracle")])
def test_sharded_describe_names_the_big_k_engine(n, size, want):
    """On a CUDA mesh an exact ``ShardedServer`` at k = 200 names the
    engine its search runs: the two-phase engine where the slice has
    n_local >= 8 * (k + 2) rows, brute force ("oracle", as the single-card
    ``Server`` names it) below.  The route reads the local k that
    ``search_exact_sharded`` searches: on two shards, n = 2 * 1616 - 1
    leaves a zero pad row on the last shard, k widens to 201 there, and
    1616 rows are too few for it."""
    X = torch.zeros((n, 4))
    srv = psrv.ShardedServer.build(X, 200, mesh=_mesh(size=size), mode="exact")
    assert srv.describe()["exact_engine"] == "rank"  # a CPU mesh
    card = dataclasses.replace(srv, mesh=_mesh(torch.device("cuda"), size=size))
    assert card.describe()["exact_engine"] == want
    assert card._route_twophase(200) == (want == "twophase")
    assert card._route_twophase(200, no_twophase=True) == (want == "twophase")


def test_sharded_big_k_search_takes_seg_to_the_two_phase_engine(monkeypatch):
    """A k = 200 search of an exact ``ShardedServer`` on a CUDA mesh
    reaches the two-phase engine with the call's ``seg``, ``pad_segments``
    and ``rescan``, as the single-card ``Server`` passes them."""
    seen = []

    def recorder(points, queries, k, **kw):
        seen.append((points.shape[0], k, kw))
        m = queries.shape[0]
        return torch.zeros((m, k), dtype=torch.int32), torch.zeros((m, k))

    monkeypatch.setattr(tp, "exact_knn_twophase", recorder)
    monkeypatch.setattr(sh, "_merge", lambda mesh, ids, dd, n_local, n, k: (ids, dd))
    X = torch.zeros((8 * 202, 4))
    srv = psrv.ShardedServer.build(X, 200, mesh=_mesh(Card("cpu")), mode="exact")
    assert srv.describe()["exact_engine"] == "twophase"
    ids, _ = srv.search(torch.zeros((3, 4)), seg=16, pad_segments=3, rescan="xla")
    assert ids.shape == (3, 200)
    assert len(seen) == 1
    rows, k, kw = seen[0]
    assert (rows, k) == (8 * 202, 200)
    assert (kw["seg"], kw["pad_segments"], kw["rescan"]) == (16, 3, "xla")
