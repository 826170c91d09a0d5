"""The port's side of the sharded parity tests: each rank of a gloo group
runs one suite of cases on numpy inputs and writes its results, and the
helpers the test files compare them with.  No JAX here: the ranks import
torch and the port only.

    python tests/torch_sharded_ranks.py --rank R --world S --store FILE \\
        --suite NAME --inputs IN.npz --out DIR [--port P]

The test files call :func:`start_suite`, which starts the ranks through
the port's own launcher (``parallel/dryrun.py:launch``), once per file,
while they compute their JAX references.  A case
that raises records its traceback under ``<case>.error``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import traceback
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from approximatenn_tpu_torch.harness.compare_results import ulp_units
from approximatenn_tpu_torch.harness.scoring import ids_agree
from approximatenn_tpu_torch.parallel import checkpoint as ck
from approximatenn_tpu_torch.parallel import dryrun, multihost
from approximatenn_tpu_torch.parallel import serving as sv
from approximatenn_tpu_torch.parallel import sharded as sh

WORKER = Path(__file__).resolve()
# the dry run's shapes: one zero pad row on the last of 2 shards
N, D, M, K, TRIES, CAP = 64 * 2 + 1, 16, 8, 4, 2, 16


def run_suite(suite: str, inputs: dict, tmp_path, world: int = 2, extra=(),
              timeout: float = 240.0) -> list[dict]:
    """Run ``suite`` on ``world`` gloo ranks over ``inputs``; every rank's
    results, in rank order."""
    tmp_path = Path(tmp_path)
    np.savez(tmp_path / "inputs.npz", **inputs)
    dryrun.launch([sys.executable, str(WORKER)], world,
                  ["--suite", suite, "--inputs", str(tmp_path / "inputs.npz"), "--out",
                   str(tmp_path), *extra], timeout=timeout)
    outs = []
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            outs.append({key: z[key] for key in z.files})
    return outs


def start_suite(suite: str, inputs: dict, tmp_path, **kw) -> Future:
    """:func:`run_suite` in a background thread, so that a test file
    computes its JAX references while the ranks run; ``inputs`` must be
    numpy arrays already."""
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        return pool.submit(run_suite, suite, inputs, tmp_path, **kw)
    finally:
        pool.shutdown(wait=False)


def ok(out: dict, case: str) -> None:
    """Fail with the rank's traceback if ``case`` raised there."""
    err = out.get(f"{case}.error")
    assert err is None, str(err)


def assert_parity(port_ids, port_d, ref_ids, ref_d, rtol: float | None = None) -> None:
    """The parity band of the sharded tests: ids the same set per row
    outside near-ties (adjacent reference distances within 1e-5 relative,
    ``ids_agree``), every finite distance within 1024 float32 ULPs of the
    reference (under one unit of ``compare_results.ulp_units``), the same
    entries infinite.  ``rtol`` replaces both bounds by one relative
    tolerance, for distances summed in a half-precision type."""
    pi, ri = np.asarray(port_ids), np.asarray(ref_ids)
    pd, rd = np.asarray(port_d, np.float32), np.asarray(ref_d, np.float32)
    assert pi.shape == ri.shape, (pi.shape, ri.shape)
    for r in range(pi.shape[0]):
        if set(pi[r].tolist()) != set(ri[r].tolist()):
            agree, _ = ids_agree(torch.from_numpy(pi[r: r + 1]), torch.from_numpy(ri[r: r + 1]),
                                 torch.from_numpy(rd[r: r + 1]), rtol=rtol or 1e-5)
            assert agree, (r, pi[r], ri[r], rd[r])
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(np.isfinite(pd), fin)
    if rtol is None:
        assert ulp_units(pd[fin], rd[fin]) == 0, np.abs(pd[fin] - rd[fin]).max()
    else:
        np.testing.assert_allclose(np.sort(pd, 1)[fin], np.sort(rd, 1)[fin], rtol=rtol)


def brute(X, Y, k):
    """Float64 exact kNN ids (ties to the smaller id) and distances."""
    d2 = ((np.asarray(Y, np.float64)[:, None, :] - np.asarray(X, np.float64)[None]) ** 2).sum(-1)
    ids = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(d2, ids, 1)


def jax_arrays(s, prefix: str) -> dict:
    """A JAX ``ShardedIndex``'s leaves as the port's stacked arrays (the
    keys of ``ShardedIndex.to_numpy``), each under ``prefix``."""
    out = {f"{prefix}{f}": np.asarray(getattr(s, f))
           for f in ("row_means", "bases", "tables", "counts", "graph")}
    out[f"{prefix}meta"] = np.array([s.n, s.n_local, s.k, s.d, s.d_short, s.tries, s.tmax,
                                     s.n_shards])
    out[f"{prefix}metric"] = np.array(s.metric)
    if s.points is not None:
        out[f"{prefix}points"] = np.asarray(s.points)
    return out


def edge_dists(X, graph, r: int, n_local: int) -> np.ndarray:
    """Float64 distances of shard ``r``'s graph edges over the corpus ``X``
    zero-padded to the shards (sentinel edges: +inf)."""
    X = np.asarray(X, np.float64)
    sl = np.concatenate([X, np.zeros((1, X.shape[1]))])[r * n_local: (r + 1) * n_local]
    own = np.concatenate([sl, np.full((1, X.shape[1]), np.inf)])
    return ((own[np.minimum(graph, n_local)] - sl[:, None]) ** 2).sum(-1)


def index_arrays(prefix: str, inputs: dict) -> dict:
    """The stacked index arrays stored under ``prefix`` in ``inputs``."""
    return {key[len(prefix):]: v for key, v in inputs.items() if key.startswith(prefix)}


# -- the suites (each case: (mesh, inputs) -> dict of arrays) -----------------

def _build(mesh, I):
    X = I["X"]
    out = {}
    s = sh.build_sharded(X, K, mesh=mesh, tries=TRIES, capacity=CAP, seed=0,
                         graph_mode="hash", bases=I["bases"])
    out.update(row_means=s.row_means.numpy(), tables=s.tables.numpy(),
               counts=s.counts.numpy(), graph=s.graph.numpy(),
               layout=np.array([s.n, s.n_local, s.n_shards, s.rank, s.tmax, s.d_short,
                                s.n_padded]))
    for name, cap in (("none", None), ("auto", "auto"), ("int", 5)):
        c = sh.build_sharded(I["Xskew"], K, mesh=mesh, tries=TRIES, capacity=cap, seed=0,
                             graph_mode="exact", bases=I["bases"])
        out[f"tmax_{name}"] = np.array([c.tmax, c.tables.shape[-1]])
    out["counts_skew"] = c.counts.numpy()
    return out


def _carried(mesh, I):
    s = sh.ShardedIndex.from_numpy(index_arrays("jh_", I), mesh)
    X, Y = I["X"], I["Y"]
    ids, dd = sh.search_sharded(s, X, Y, mesh=mesh, rerank_width=8, supercharge_rounds=2)
    ids_c, dd_c = sh.search_sharded(s, X, Y, mesh=mesh, rerank_width=8,
                                    supercharge_rounds=2, chunked=True)
    base, _ = sh.search_sharded(s, X, Y, mesh=mesh)
    back = s.to_numpy(mesh)
    same_back = all(np.array_equal(back[key], I["jh_" + key]) for key in
                    ("tables", "counts", "graph", "row_means", "bases", "meta"))
    return dict(ids=ids.numpy(), dd=dd.numpy(), base=base.numpy(),
                chunked_same=np.array(torch.equal(ids, ids_c) and torch.equal(dd, dd_c)),
                roundtrip=np.array(same_back))


def _own_roundtrip(mesh, I):
    s = sh.build_sharded(I["X"], K, mesh=mesh, tries=TRIES, capacity=CAP, seed=0,
                         store_points=True)
    t = sh.ShardedIndex.from_numpy(s.to_numpy(mesh), mesh)
    same = all(torch.equal(getattr(s, f), getattr(t, f)) for f in
               ("row_means", "bases", "tables", "counts", "graph", "points"))
    return dict(same=np.array(same and (s.n, s.n_local, s.tmax, s.rank) ==
                              (t.n, t.n_local, t.tmax, t.rank)))


def _exact(mesh, I):
    X, Y = I["X"], I["Y"]
    Xt = torch.from_numpy(X)
    out = {}
    for name, pts, kw in (("f32", X, {}), ("bf16", Xt.to(torch.bfloat16), {}),
                          ("f16", Xt.to(torch.float16), {}),
                          ("int8", I["Xq"], {"scale": float(I["scale"])}),
                          ("n_true", np.concatenate([X, np.zeros((1, X.shape[1]), np.float32)]),
                           {"n_true": X.shape[0]}),
                          ("f64", X.astype(np.float64), {}),
                          ("near_origin", X, {})):
        q = I["Y0"] if name == "near_origin" else Y
        q = q.astype(np.float64) if name == "f64" else q
        try:
            ids, dd = sh.search_exact_sharded(pts, q, K, mesh=mesh, **kw)
            out[f"exact_{name}_ids"], out[f"exact_{name}_dd"] = ids.numpy(), dd.numpy()
        except Exception:  # recorded per case: the test names the failing one
            out[f"exact_{name}.error"] = np.array(traceback.format_exc())
    try:
        sh.search_exact_sharded(I["Xq"], Y, K, mesh=mesh)
    except ValueError as e:
        out["int8_no_scale"] = np.array(str(e))
    return out


def _pads(mesh, I):
    """Zero pad rows may not take a top-k slot in the approximate paths: a
    corpus shifted off the origin, near-origin queries, tables and windows
    that hold every slot (d_short 1 at n_local 10, k 5)."""
    Xs, Y0 = I["Xs"], I["Y0"]
    s = sh.build_sharded(Xs, 5, mesh=mesh, tries=3, seed=0, capacity=64, store_points=True)
    spk = sh.packed_sharded(s, mesh=mesh, window=64)
    return dict(
        table=sh.search_sharded(s, Xs, Y0, mesh=mesh)[0].numpy(),
        packed=sh.search_packed_sharded(s, spk, Xs, Y0, mesh=mesh)[0].numpy(),
        fused=sh.search_packed_fused_sharded(s, spk, Xs, Y0, mesh=mesh)[0].numpy(),
        layout=np.array([s.n, s.n_padded, s.d_short]))


def _mesh_errors(mesh, I):
    out = {}
    for name, kw in (("n_devices", {"n_devices": mesh.size + 1}), ("no_card", {})):
        try:
            sh.make_mesh(**kw)
        except (ValueError, RuntimeError) as e:
            out[name] = np.array(f"{type(e).__name__}: {e}")
    m = sh.make_mesh(n_devices=mesh.size, device="cpu")
    out["mesh"] = np.array([m.rank, m.size, int(m.host_staged)])
    return out


def _packed(mesh, I):
    s = sh.ShardedIndex.from_numpy(index_arrays("jx_", I), mesh)
    X, Y = I["X"], I["Y"]
    out = {}
    for name, dt in (("f32", None), ("bf16", torch.bfloat16), ("int8", torch.int8)):
        spk = sh.packed_sharded(s, X, mesh=mesh, dtype=dt)
        rows = spk.point_rows
        out[f"{name}_rows"] = (rows.float() if dt == torch.bfloat16 else rows).numpy()
        out[f"{name}_ids"], out[f"{name}_starts"] = spk.ids.numpy(), spk.starts.numpy()
        out[f"{name}_meta"] = np.array([spk.n_pad_l, spk.window, spk.super_width])
        if spk.scale is not None:
            out[f"{name}_scale"] = spk.scale.numpy()
        ids, dd = sh.search_packed_sharded(s, spk, X, Y, mesh=mesh)
        out[f"{name}_search_ids"], out[f"{name}_search_dd"] = ids.numpy(), dd.numpy()
        if name == "f32":
            wide = sh.search_packed_sharded(s, spk, X, Y, mesh=mesh, rerank_width=40,
                                            supercharge_rounds=2)[0]
            out["wide_ids"] = wide.numpy()
            w8 = sh.search_packed_sharded(s, spk, X, Y, mesh=mesh, window=8)
            w8_view = dataclasses.replace(spk, window=8)
            w8b = sh.search_packed_sharded(s, w8_view, X, Y, mesh=mesh)
            out["window_same"] = np.array(torch.equal(w8[0], w8b[0]))
    ids, dd = sh.global_graph_sharded(s, X, mesh=mesh)
    out["gg_ids"], out["gg_dd"] = ids.numpy(), dd.numpy()
    return out


def _fused(mesh, I):
    X, Y = I["X"], I["Y"]
    out = {}
    own = sh.build_sharded(X, K, mesh=mesh, tries=TRIES, capacity=CAP, seed=0,
                           graph_mode="exact", chunk_rows=24)
    out["graph"] = own.graph.numpy()
    out["layout"] = np.array([own.n, own.n_local, own.rank])
    coarse = sh.build_sharded(X, K, mesh=mesh, tries=TRIES, capacity=CAP, seed=0,
                              graph_mode="exact", graph_precision="default")
    out["precision_same"] = np.array(torch.equal(coarse.graph, own.graph))
    s = sh.ShardedIndex.from_numpy(index_arrays("jx_", I), mesh)
    spk = sh.packed_sharded(s, X, mesh=mesh)
    ids, dd = sh.search_packed_fused_sharded(s, spk, X, Y, mesh=mesh, window=spk.window)
    out["fused_ids"], out["fused_dd"] = ids.numpy(), dd.numpy()
    spk8 = sh.packed_sharded(s, X, mesh=mesh, dtype=torch.int8)
    ids, dd = sh.search_packed_fused_sharded(s, spk8, X, Y, mesh=mesh, window=spk8.window)
    out["fused8_ids"], out["fused8_dd"] = ids.numpy(), dd.numpy()
    return out


def _twophase(mesh, I):
    out = {}
    for name, tp in (("twophase", True), ("auto", None), ("rank", False)):
        ids, dd = sh.search_exact_sharded(I["X"], I["Y"], K, mesh=mesh, twophase=tp)
        out[f"{name}_ids"], out[f"{name}_dd"] = ids.numpy(), dd.numpy()
    return out


def _angular(mesh, I):
    X, Y = I["X"], I["Y"]
    a = sh.ShardedIndex.from_numpy(index_arrays("ja_", I), mesh)
    ids, dd = sh.search_sharded(a, None, Y, mesh=mesh)
    spa = sh.packed_sharded(a, mesh=mesh)
    own = sh.build_sharded(X, K, mesh=mesh, tries=TRIES, seed=0, metric="angular",
                           graph_mode="exact")
    return dict(ids=ids.numpy(), dd=dd.numpy(), graph=own.graph.numpy(),
                points=own.points.numpy(),
                fused_ids=sh.search_packed_fused_sharded(a, spa, None, Y, mesh=mesh)[0].numpy())


def _multihost(mesh, I):
    """The two-process bring-up: each rank holds only its rows."""
    X, Y = I["X"], I["Y"]
    n = X.shape[0]
    lo, hi = multihost.host_shard_slice(n, mesh)
    Xg = multihost.process_local_array(X.shape, mesh, X[lo:hi])
    s = sh.build_sharded(Xg, K, mesh=mesh, tries=2, capacity=16, seed=0)
    ids, _ = sh.search_sharded(s, Xg, Y, mesh=mesh)
    eids, edd = sh.search_exact_sharded(Xg, Y, K, mesh=mesh)
    return dict(slice=np.array([lo, hi]), ids=ids.numpy(), eids=eids.numpy(),
                edd=edd.numpy(), n_local=np.array(s.n_local))


def _result(out: dict, name: str, res) -> None:
    """A search's (ids, distances) under ``name``, distances in float32."""
    out[f"{name}_ids"], out[f"{name}_dd"] = res[0].numpy(), res[1].float().numpy()


def _described(srv) -> np.ndarray:
    return np.array(json.dumps(srv.describe()))


def _server_exact(mesh, I):
    """ShardedServer's exact mode: auto, two-phase staging (and its knobs),
    the storage tiers and the angular metric."""
    X, Y = I["X"], I["Y"]
    out = {}
    for name, kw in (("auto", {}), ("tp", {"twophase_min_n": 16}),
                     ("int8", {"storage_dtype": torch.int8}),
                     ("bf16", {"storage_dtype": torch.bfloat16}),
                     ("angular", {"mode": "exact", "metric": "angular"})):
        srv = sv.ShardedServer.build(X, K, mesh=mesh, **kw)
        _result(out, name, srv.search(Y))
        out[f"{name}_desc"] = _described(srv)
        if name == "int8":
            out["int8_scale"] = np.float32(srv.scale)
    return out


def _server_twophase(mesh, I):
    """The two-phase staging: the knobs stripped on the rank route, and
    forwarded (C-A7-1) with the route forced on a CPU mesh."""
    X, Y = I["X"], I["Y"]
    srv = sv.ShardedServer.build(X, K, mesh=mesh, twophase_min_n=16)
    out = {"staged": np.array([srv._twophase, srv.points.shape[0], srv.points.shape[1]])}
    _result(out, "stripped", srv.search(Y, no_twophase=True, seg=16))
    _result(out, "stripped_tp", srv.search(Y, seg=16, pad_segments=3, rescan="xla"))
    # a seg that only the two-phase engine refuses (not a power of two)
    _result(out, "stripped_bad", srv.search(Y, seg=15))
    srv._route_twophase = lambda *a, **kw: True
    _result(out, "forced", srv.search(Y, seg=16, pad_segments=3, rescan="xla"))
    try:
        srv.search(Y, seg=15)
        out["forced_bad"] = np.array("no error")
    except ValueError as e:
        out["forced_bad"] = np.array(f"ValueError: {e}")
    return out


def _server_pads(mesh, I):
    """n = 75 on 2 ranks: a zero pad row on the last, near-origin queries."""
    srv = sv.ShardedServer.build(I["X75"], 5, mesh=mesh, mode="exact")
    out = {"rows": np.array(srv.points.shape[0])}
    _result(out, "pad", srv.search(I["Y0"]))
    return out


def _server_hash(mesh, I):
    """Hash mode over the JAX bases: the packed and table layouts, and auto
    resolving to hash under a small ``exact_max_n``."""
    X, Y = I["X"], I["Y"]
    kw = dict(tries=TRIES, seed=0, capacity=CAP, bases=I["bases"])
    out = {}
    for name, extra in (("packed", {"mode": "hash"}),
                        ("table", {"mode": "hash", "layout": "table"}),
                        ("auto", {"exact_max_n": 32})):
        srv = sv.ShardedServer.build(X, K, mesh=mesh, **extra, **kw)
        _result(out, name, srv.search(Y))
        out[f"{name}_desc"] = _described(srv)
    out["bases"] = srv.sidx.bases.numpy()
    return out


def _server_big_k(mesh, I):
    """k = 200 in auto mode stays exact where n_local >= 8 * (k + 2)."""
    X, Y = I["Xbig"], I["Ybig"]
    srv = sv.ShardedServer.build(X, 200, mesh=mesh)
    out = {"desc": _described(srv)}
    _result(out, "server", srv.search(Y))
    _result(out, "raw", sh.search_exact_sharded(X, Y, 200, mesh=mesh))
    return out


def _ckpt_own(mesh, I):
    """The port's checkpoints saved and loaded on 2 ranks: the index, the
    packed view (bf16 and int8), the exact int8 two-phase and hash servers."""
    X, Y, root = I["X"], I["Y"], Path(str(I["out_dir"]))
    s = sh.build_sharded(X, K, mesh=mesh, tries=TRIES, capacity=CAP, seed=0,
                         store_points=True)
    ck.save_sharded_index(s, root / "index", mesh)
    t = ck.load_sharded_index(root / "index", mesh)
    out = {f"index_{key}": v for key, v in s.to_numpy(mesh).items()}
    ints = ("n", "n_local", "k", "d", "d_short", "tries", "tmax", "n_shards", "rank", "metric")
    out["index_same"] = np.array(
        all(torch.equal(getattr(s, f), getattr(t, f)) for f in
            ("row_means", "bases", "tables", "counts", "graph", "points"))
        and all(getattr(s, f) == getattr(t, f) for f in ints))
    for name, dt in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        spk = sh.packed_sharded(s, mesh=mesh, dtype=dt)
        ck.save_sharded_packed(spk, root / f"packed_{name}", mesh)
        q = ck.load_sharded_packed(root / f"packed_{name}", mesh, d=X.shape[1])
        same = all(torch.equal(getattr(spk, f), getattr(q, f))
                   for f in ("point_rows", "ids", "starts"))
        same &= (spk.n_pad_l, spk.window, spk.super_width) == (q.n_pad_l, q.window,
                                                               q.super_width)
        same &= (spk.scale is None) == (q.scale is None)
        same &= spk.scale is None or torch.equal(spk.scale, q.scale)
        a = sh.search_packed_sharded(s, spk, None, Y, mesh=mesh)
        b = sh.search_packed_sharded(s, q, None, Y, mesh=mesh)
        out[f"packed_{name}_same"] = np.array(same and torch.equal(a[0], b[0])
                                              and torch.equal(a[1], b[1]))
        out[f"packed_{name}_rows"] = (spk.point_rows.float() if dt == torch.bfloat16
                                      else spk.point_rows).numpy()
    for name, kw in (("exact", {"storage_dtype": torch.int8, "twophase_min_n": 16}),
                     ("hash", {"mode": "hash", "tries": 3, "seed": 2, "capacity": 48})):
        srv = sv.ShardedServer.build(X, K, mesh=mesh, **kw)
        srv.save(root / f"srv_{name}")
        back = sv.ShardedServer.load(root / f"srv_{name}", mesh=mesh)
        a, b = srv.search(Y), back.search(Y)
        out[f"srv_{name}_same"] = np.array(
            srv.describe() == back.describe() and back._twophase == srv._twophase
            and torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
        out[f"srv_{name}_dtype"] = np.array(str(back.points.dtype if back.points is not None
                                                else back.spk.point_rows.dtype))
    return out


def _ckpt_jax(mesh, I):
    """Checkpoints the JAX package wrote (npz, orbax hidden), served here."""
    Y, root, d = I["Y"], Path(str(I["jax_dir"])), I["X"].shape[1]
    s = ck.load_sharded_index(root / "index", mesh)
    p = ck.load_sharded_packed(root / "packed", mesh, d=d)
    out = {"packed_width": np.array(p.point_rows.shape[1])}
    _result(out, "index", sh.search_sharded(s, None, Y, mesh=mesh))
    _result(out, "packed", sh.search_packed_sharded(s, p, None, Y, mesh=mesh))
    for name in ("exact", "hash"):
        srv = sv.ShardedServer.load(root / f"srv_{name}", mesh=mesh)
        _result(out, f"srv_{name}", srv.search(Y))
        out[f"srv_{name}_desc"] = _described(srv)
    return out


def _tune(mesh, I):
    """tune_sharded on a CPU mesh, with every ShardedServer.search call's
    batch and, at each exact build, the exact servers still alive."""
    X = I["Xtune"]
    cls = sv.ShardedServer
    raw_build, raw_search = cls.__dict__["build"], cls.search
    batches, alive_at_build, refs = [], [], []

    def build(*a, **kw):
        if kw.get("mode") == "exact":
            alive_at_build.append(sum(r() is not None for r in refs))
        srv = raw_build.__get__(None, cls)(*a, **kw)
        if srv.mode == "exact":
            refs.append(weakref.ref(srv))
        return srv

    def search(self, queries, *a, **kw):
        batches.append(int(queries.shape[0]))
        return raw_search(self, queries, *a, **kw)

    cls.build, cls.search = build, search
    try:
        rep = sv.tune_sharded(X, 5, mesh=mesh, n_queries=32, batch=12, target_recall=0.9,
                              probe_grid=(None,), window_grid=(16,), rerank_grid=(None,),
                              exact_tiers=(None, "bf16"), tries=3, capacity=32, seed=1)
        in_tune = list(batches)
        srv = rep.server()
        ids, _ = srv.search(X[:8])
    finally:
        cls.build, cls.search = raw_build, raw_search
    return dict(report=np.array(json.dumps(rep.as_dict())), batches=np.array(in_tune),
                alive_at_build=np.array(alive_at_build), server_ids=ids.numpy(),
                server_mode=np.array(srv.mode))


def _tune_parity(mesh, I):
    """tune_sharded over the JAX bases, every query scored in one batch:
    each trial's engine, knobs, raw recall and cost, and the winner's place."""
    rep = sv.tune_sharded(I["X"], 5, mesh=mesh, queries=I["Y"], batch=None, seed=3,
                          probe_grid=(None, 18), window_grid=(16,), rerank_grid=(None,),
                          exact_tiers=(None, "bf16"), tries=3, capacity=32, bases=I["bases"])
    return dict(report=np.array(json.dumps(rep.as_dict())),
                recalls=np.array([t.recall for t in rep.trials]),
                costs=np.array([t.cost for t in rep.trials]),
                best=np.array(next(i for i, t in enumerate(rep.trials) if t is rep.best)),
                bases=rep._srv_hash.sidx.bases.numpy())


SUITES = {
    "build": (_build, _carried, _own_roundtrip, _pads, _mesh_errors, _angular),
    "exact": (_exact, _twophase),
    "packed": (_packed,),
    "fused": (_fused,),
    "multihost": (_multihost,),
    "serving": (_server_exact, _server_twophase, _server_pads, _server_hash, _server_big_k),
    "checkpoint": (_ckpt_own, _ckpt_jax, _tune),
    "tune": (_tune_parity,),
}


def main() -> None:
    import torch.distributed as dist

    ap = dryrun.rank_parser()
    ap.add_argument("--suite", required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--port", type=int)
    args = ap.parse_args()
    if args.port:  # the host:port rendezvous, as a cluster would give it
        torch.set_num_threads(1)
        multihost.initialize(f"127.0.0.1:{args.port}", args.world, args.rank,
                             backend="gloo", timeout=60)
    else:
        dryrun.join(args, timeout=60)
    mesh = multihost.global_mesh(device="cpu")
    with np.load(args.inputs) as z:
        inputs = {key: z[key] for key in z.files}
    out = {}
    try:
        for case in SUITES[args.suite]:
            name = case.__name__.lstrip("_")
            try:
                out.update({f"{name}.{key}": v for key, v in case(mesh, inputs).items()})
            except Exception:  # recorded per case: the test names the failing one
                out[f"{name}.error"] = np.array(traceback.format_exc())
    finally:
        dist.destroy_process_group()
    np.savez(Path(args.out) / f"rank{args.rank}.npz", **out)


if __name__ == "__main__":
    main()
