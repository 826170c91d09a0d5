#!/usr/bin/env python
"""Headline benchmark of the PyTorch port: batched ANN query throughput on
one CUDA card.

    python3 bench_torch.py [--reps 20] [--no-1m]

Prints ONE JSON line on stdout with ``bench.py``'s keys and their meanings,
measured on the card: hash ``build`` cold and warm seconds, hash ``search``
latency and pipelined QPS with recall@10, ``exact_search`` QPS by
``bench.py``'s round-5 protocol (the headline ``value``), and the 1M x 128
exact tiers (f32 "highest", a bf16-stored copy, ``matmul_precision``
"split3").  Config: ``bench.py``'s ``CONFIG`` (n = 20,000 Gaussian points,
d = 128, k = 10, tries = 10, 1000 queries from ``default_rng(12345)``).
``vs_baseline`` is the QPS over the reference C library's QPS on a CPU at
the identical config (``baselines/reference_cpu.json``).

stderr carries what is no part of the line: the seconds to build or load
the kernel libraries (before the timed cold build), the host syncs of one
``search`` and one ``exact_search`` call under
``torch.cuda.set_sync_debug_mode("warn")`` with the source lines that made
them, and the kernel launch counts
of the run.  Where the environment names a directory in ``BENCH_TORCH_KEEP``
the run also writes the ids it scored (``ids.npz``) and the hash index
(``index.npz``) there, so that ``chip_smoke.py`` can hold them to a float64
oracle and to the CPU.

Deliberate differences from ``bench.py``:

- no failure is swallowed: ``bench.py`` wraps its exact and 1M parts in
  ``except Exception: pass``; here a failure propagates and the process
  exits non-zero (``--no-1m`` is the only way to leave the 1M keys out);
- there is no CPU fallback: without a CUDA card ``main`` exits non-zero;
  only ``run(device="cpu")``, which the tests call, runs on the CPU;
- the 1M data is drawn on the card by torch's generator, not by
  ``jax.random``: the same distribution, not the same numbers;
- ``serving_mode`` is checked, not only printed: ``run`` builds
  ``Server.build(X, k, mode="auto")`` at the config and raises unless it
  serves exact search through the rank kernel (on the CPU, the oracle).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import torch

import approximatenn_tpu_torch as ann
from approximatenn_tpu_torch.harness.scoring import recall_at_k
from approximatenn_tpu_torch.ops import exact as ex
from approximatenn_tpu_torch.utils.profiling import fence
from approximatenn_tpu_torch.utils.runtime import card_name_and_limit

CONFIG = dict(n=20_000, d=128, k=10, tries=10, ycnt=1000)
BASELINE_PATH = Path(__file__).parent / "baselines" / "reference_cpu.json"
KEEP_ENV = "BENCH_TORCH_KEEP"
N_1M = 1_000_000
# bench.py's keys, in its order; the baseline keys only where a reference
# record matches the config, the 1M keys only without --no-1m
KEYS = ("metric", "value", "unit", "vs_baseline", "config", "query_s", "latency_s",
        "build_s", "build_cold_s", "device", "baseline_qps", "build_vs_baseline",
        "baseline_recall_at_10", "recall_at_10", "exact_qps", "exact_qps_best",
        "exact_qps_cv", "exact_stat", "exact_rounds", "exact_reps", "matmul_precision",
        "exact_recall_at_10", "hash_qps", "hash_recall_at_10", "serving_mode",
        "exact_1m_qps", "exact_1m_recall_at_10", "exact_1m_bf16_qps",
        "exact_1m_bf16_recall_at_10", "exact_1m_split3_qps", "exact_1m_split3_recall_at_10")
# the engine Server(mode="auto") must serve at the config, by device type
SERVED_ENGINE = {"cuda": "cuda-rank", "cpu": "oracle"}


def note(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def load_baseline(config: dict = CONFIG) -> dict | None:
    """The reference CPU record whose n, d and ycnt match ``config``."""
    if BASELINE_PATH.exists():
        for rec in json.loads(BASELINE_PATH.read_text()):
            if all(rec[key] == config[key] for key in ("n", "d", "ycnt")):
                return rec
    return None


def bench_data(config: dict = CONFIG) -> tuple[np.ndarray, np.ndarray]:
    """(X, Y) float32 as ``bench.py`` draws them: X, then Y, from
    ``default_rng(12345)``."""
    rng = np.random.default_rng(12345)
    X = rng.standard_normal((config["n"], config["d"])).astype(np.float32)
    Y = rng.standard_normal((config["ycnt"], config["d"])).astype(np.float32)
    return X, Y


def data_1m(d: int, ycnt: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The 1M x d corpus and ycnt queries, float32, drawn on ``device`` from
    a generator seeded 0 (``bench.py`` draws them with ``jax.random`` from
    ``PRNGKey(0)``, which torch cannot reproduce: the same distribution,
    not the same numbers)."""
    g = torch.Generator(device=device).manual_seed(0)
    X1 = torch.randn((N_1M, d), generator=g, device=device)
    Y1 = torch.randn((ycnt, d), generator=g, device=device)
    return X1, Y1


def load_kernels() -> float:
    """Build (or load from ``approximatenn_tpu_torch/_build/``) every kernel
    library, untimed by the bench: the counterpart of ``bench.py``'s
    persistent compile cache, so that ``build_cold_s`` is the first build
    of a process whose compiled programs are already on disk."""
    t0 = time.perf_counter()
    for name in ex.build_libraries():
        ex._library(name)
    return time.perf_counter() - t0


def sync_sites(fn) -> Counter:
    """The host syncs that one call of ``fn`` on the card makes, as torch's
    sync debug mode reports them (one warning each), counted by the source
    line ("file:line") whose op made them."""
    fence()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    fence()
    return Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                   if "synchronizing CUDA operation" in str(w.message))


def pipelined_s(fn, reps: int, dev) -> float:
    """Seconds a call over ``reps`` calls queued back to back, then one
    fence (``bench.py``'s pipelined dispatch and ``drain``)."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    fence(dev)
    return (time.perf_counter() - t0) / reps


def recall(truth: torch.Tensor, ids: torch.Tensor, k: int) -> float:
    return round(recall_at_k(truth.cpu().numpy(), ids.cpu().numpy(), k), 4)


def build_stats(X: torch.Tensor, k: int, tries: int):
    """({build_cold_s, build_s}, index): two ``build(X, k, tries, seed=7)``
    calls, each ended by a fence (``bench.py:86-93``)."""
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        index, graph, _ = ann.build(X, k, tries=tries, seed=7)
        fence(graph)
        times.append(time.perf_counter() - t0)
    return {"build_s": round(times[1], 3), "build_cold_s": round(times[0], 3)}, index


def hash_stats(index, X: torch.Tensor, Y: torch.Tensor, truth: torch.Tensor,
               k: int, reps: int):
    """({query_s, latency_s, hash_qps, recall_at_10}, (ids, dists)) of hash
    ``search`` over the padded tables (``bench.py:95-149``): one warm-up
    call; latency the median of ``reps`` synchronous calls; query_s the
    seconds a call of ``reps`` calls queued, then one fence."""
    ids, dists = ann.search(index, X, Y)
    fence(X)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ann.search(index, X, Y)
        fence(X)
        times.append(time.perf_counter() - t0)
    query_s = pipelined_s(lambda: ann.search(index, X, Y), reps, X.device)
    return {"query_s": query_s, "latency_s": float(np.median(times)),
            "hash_qps": Y.shape[0] / query_s,
            "recall_at_10": recall(truth, ids, k)}, (ids, dists)


def exact_stats(X: torch.Tensor, Y: torch.Tensor, truth: torch.Tensor, k: int, reps: int):
    """The exact keys of ``bench.py:162-206`` and the warm-up call's (ids,
    dists).  Round-5 protocol: pipelined rounds of ``max(100, reps)``
    calls until the median's standard error (cv / sqrt(rounds)) is under
    3%, at least 6 rounds and at most 24; QPS is the median round's, the
    best round's beside it, with the CV."""
    ids, dists = ann.exact_search(X, Y, k)
    fence(X)
    reps_e = max(100, reps)
    round_times = []
    cv = float("inf")
    while len(round_times) < 24:
        round_times.append(pipelined_s(lambda: ann.exact_search(X, Y, k), reps_e, X.device))
        if len(round_times) >= 6:
            arr = np.asarray(round_times)
            cv = float(arr.std() / arr.mean())
            if cv / np.sqrt(len(arr)) < 0.03:
                break
    m = Y.shape[0]
    return {"exact_qps": round(m / float(np.median(round_times)), 1),
            "exact_qps_best": round(m / min(round_times), 1),
            "exact_qps_cv": round(cv, 4),
            "exact_stat": "median_of_rounds",
            "exact_rounds": len(round_times),
            "exact_reps": reps_e,
            "matmul_precision": "highest",
            "exact_recall_at_10": recall(truth, ids, k)}, (ids, dists)


def check_serving(X: torch.Tensor, k: int) -> dict:
    """``Server.build(X, k, mode="auto")``'s ``describe()``, which must name
    exact search through the rank kernel (the engine ``serving_mode``
    names); raises otherwise."""
    desc = ann.Server.build(X, k, mode="auto").describe()
    want = SERVED_ENGINE[X.device.type]
    if desc["mode"] != "exact" or desc.get("exact_engine") != want:
        raise RuntimeError(f"Server(mode='auto') does not serve exact search through "
                           f"{want} here: {desc}")
    return desc


def one_m_stats(d: int, ycnt: int, k: int, reps: int, dev, keep: dict | None = None) -> dict:
    """The 1M x d exact keys of ``bench.py:220-278``: f32 "highest", a
    bf16-stored copy and ``matmul_precision="split3"``, each the best of
    two pipelined rounds of ``max(100, reps)`` calls after a warm-up, with
    recall@10 against the float32 oracle."""
    X1, Y1 = data_1m(d, ycnt, dev)
    reps1 = max(100, reps)
    tq1 = ann.brute_force_knn(X1, Y1, k)[0]
    out = {}
    for key, kw in (("exact_1m", {}), ("exact_1m_bf16", {}),
                    ("exact_1m_split3", {"matmul_precision": "split3"})):
        corpus = X1.to(torch.bfloat16) if key == "exact_1m_bf16" else X1
        ids, _ = ann.exact_search(corpus, Y1, k, **kw)
        fence(dev)
        best_s = min(pipelined_s(lambda: ann.exact_search(corpus, Y1, k, **kw), reps1, dev)
                     for _ in range(2))
        out[f"{key}_qps"] = round(ycnt / best_s, 1)
        out[f"{key}_recall_at_10"] = recall(tq1, ids, k)
        if keep is not None:
            keep[f"{key}_ids"] = ids
        # bench.py frees the bf16 copy before split3
        del corpus
    return out


def run(config: dict = CONFIG, *, device="cuda", reps: int = 20, one_m: bool = True,
        keep: dict | None = None) -> dict:
    """``bench.py``'s one-line result at ``config`` on ``device``.  ``keep``,
    when given, receives the scored ids and distances (``hash_*``,
    ``exact_*``, ``exact_1m*_ids``) and the hash index (``index``)."""
    dev = torch.device(device)
    d, k, tries, ycnt = (config[key] for key in ("d", "k", "tries", "ycnt"))
    Xn, Yn = bench_data(config)
    X = torch.from_numpy(Xn).to(dev)
    Y = torch.from_numpy(Yn).to(dev)
    if dev.type == "cuda":
        note(f"kernel libraries built or loaded in {load_kernels():.3f} s (untimed)")
    ex.reset_launch_counts()

    builds, index = build_stats(X, k, tries)
    truth = ann.brute_force_knn(X, Y, k)[0]
    hs, (hids, hdists) = hash_stats(index, X, Y, truth, k, reps)
    base = load_baseline(config)
    result = {
        "metric": "query_qps",
        "value": round(hs["hash_qps"], 1),
        "unit": "queries/sec",
        "vs_baseline": round(hs["hash_qps"] / base["qps"], 2) if base else None,
        "config": config,
        "query_s": round(hs["query_s"], 6),
        "latency_s": round(hs["latency_s"], 6),
        **builds,
        "device": card_name(dev),
    }
    if base:
        result["baseline_qps"] = base["qps"]
        result["build_vs_baseline"] = round(base["build_s"] / builds["build_s"], 2)
        if "recall_at_10" in base:
            result["baseline_recall_at_10"] = base["recall_at_10"]
    result["recall_at_10"] = hs["recall_at_10"]

    es, (eids, edists) = exact_stats(X, Y, truth, k, reps)
    result.update(es)
    check_serving(X, k)
    # the headline is the framework's serving answer at this config (Server
    # auto -> exact through the rank kernel); the hash path keeps its own
    # numbers under hash_* (bench.py:207-213)
    result["hash_qps"] = result["value"]
    result["hash_recall_at_10"] = result["recall_at_10"]
    result["serving_mode"] = "exact (Server auto)"
    result["value"] = result["exact_qps"]
    result["recall_at_10"] = result["exact_recall_at_10"]
    if base:
        result["vs_baseline"] = round(result["value"] / base["qps"], 2)
    if dev.type == "cuda":
        sites = {"search": sync_sites(lambda: ann.search(index, X, Y)),
                 "exact_search": sync_sites(lambda: ann.exact_search(X, Y, k))}
        note("host syncs in one call: "
             + json.dumps({call: sum(c.values()) for call, c in sites.items()}))
        note(f"host sync sites: {json.dumps(sites)}")
    if keep is not None:
        keep.update(hash_ids=hids, hash_dists=hdists, exact_ids=eids, exact_dists=edists,
                    index=index)
    del index
    if one_m:
        result.update(one_m_stats(d, ycnt, k, reps, dev, keep))
    note(f"launches {json.dumps(ex.launches)}")
    return result


def card_name(dev: torch.device) -> str:
    """``device``: the card's name and power limit as nvidia-smi gives them,
    or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    smi = card_name_and_limit()
    if smi is None:
        raise RuntimeError("nvidia-smi did not give the card's name and power limit")
    return smi


def save_kept(keep: dict, where: str) -> None:
    """``keep`` as ``<where>/ids.npz`` (ids and distances) and
    ``<where>/index.npz`` (the hash index, the JAX package's npz layout)."""
    out = Path(where)
    out.mkdir(parents=True, exist_ok=True)
    keep.pop("index").save(str(out / "index.npz"))
    np.savez(out / "ids.npz", **{key: t.cpu().numpy() for key, t in keep.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-1m", action="store_true",
                    help="skip the 1M-point exact-search stat")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch: torch.cuda.is_available() is False; the bench "
                         "measures a CUDA card and has no CPU fallback")
    where = os.environ.get(KEEP_ENV)
    keep = {} if where else None
    result = run(device="cuda", reps=args.reps, one_m=not args.no_1m, keep=keep)
    if keep is not None:
        save_kept(keep, where)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
