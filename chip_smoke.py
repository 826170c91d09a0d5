"""GPU smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--kernel-only]

Phases, one line each, and a non-zero exit on the first failure:

0. environment: torch/CUDA versions, the card's name and power limit;
1. build of the exact-kNN CUDA kernel from ``approximatenn_tpu_torch/csrc``;
2. the kernel against its plain PyTorch version on the card, at the main
   path's shapes (serving f32 and bf16; one exact-graph chunk of 65,536
   corpus rows with ``exclude`` = own ids) and the degenerate ones (k = 1, k = 128, k > n, k = n - 1
   with exclusion, n not a tile multiple, d = 96, bf16, f16, int8, m = 1);
3. the main path at the SIFT-1M shape (n = 1M x d = 128 float32 from
   ``--seed``, 1000 queries, k = 10, tries = 10): ``build`` (exact kNN graph
   through the kernel) -> ``search`` -> ``Server.build``/``search`` in auto
   (exact) mode, f32 and bf16 storage, each checked against a float64
   oracle computed on the card; the card's hash search is also checked
   against the same search on the CPU for a subset of queries.

Before the last line it prints one JSON object with the kernel's launch
count on the main path, its error against the plain version and both
times; the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
card, or without the package beside it, the script fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

import approximatenn_tpu_torch as ann
from approximatenn_tpu_torch.harness.scoring import ids_agree, recall_at_k
from approximatenn_tpu_torch.ops import exact as ex
from approximatenn_tpu_torch.ops.distance import brute_force_knn
from approximatenn_tpu_torch.ops.hash import query_codes
from approximatenn_tpu_torch.utils.profiling import fence

KERNEL_SOURCE = "approximatenn_tpu_torch/csrc/exact_knn.cu"
REPLACES = "approximatenn_tpu/ops/pallas_exact.py:267"
N = 1_000_000  # SIFT-1M's shape: N x 128 float32
M = 1000  # queries per batch
GRAPH_CHUNK = 65536  # engine/build.py:exact_graph_chunked's chunk_q
CPU_CHECK_QUERIES = 50


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    fence()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    fence()
    return start.elapsed_time(end) / reps


def check_case(label, points, queries, k, *, exclude=None, scale=None,
               rtol=1e-5, atol=1e-4) -> float:
    ia, da = ex.exact_knn(points, queries, k, exclude=exclude, scale=scale)
    ib, db = ex.exact_knn_plain(points, queries, k + 1, exclude=exclude, scale=scale)
    fence()
    m = queries.shape[0]
    if ia.shape != (m, k) or ia.dtype != torch.int32 or da.dtype != torch.float32:
        raise AssertionError(f"{label}: bad output {ia.shape} {ia.dtype} {da.dtype}")
    ok, tied = ids_agree(ia, ib[:, :k], db, rtol=1e-5)
    if not ok:
        bad = torch.nonzero((ia != ib[:, :k]).any(1)).squeeze(1)[:3].tolist()
        raise AssertionError(f"{label}: ids differ outside near-ties, rows {bad}: "
                             f"{ia[bad].tolist()} vs {ib[bad, :k].tolist()}")
    fin = torch.isfinite(db[:, :k])
    if not torch.equal(fin, torch.isfinite(da)):
        raise AssertionError(f"{label}: sentinel pattern differs")
    if not torch.allclose(da[fin], db[:, :k][fin], rtol=rtol, atol=atol):
        err = (da[fin] - db[:, :k][fin]).abs().max().item()
        raise AssertionError(f"{label}: distances differ, max abs {err}")
    n = points.shape[0]
    if not bool((ia[~fin] == n).all()):
        raise AssertionError(f"{label}: sentinel rows must carry id n")
    err = (da[fin] - db[:, :k][fin]).abs().max().item() if fin.any() else 0.0
    phase("kernel", f"{label}: ok (max_abs_err {err:.3g}, near-tie rows {tied})")
    return err


def oracle64(points64, queries64, k):
    """(ids, distances) of the exact neighbours in float64 on the card."""
    return brute_force_knn(points64, queries64, k)


def recall_up_to_ties(points64, queries64, ids, true_d, k) -> tuple[float, float]:
    """(plain recall@k, recall@k counting a returned id as correct when its
    float64 distance is within 1e-6 relative of the true k-th distance)."""
    true_ids, true_dists = true_d
    return (recall_at_k(true_ids.cpu().numpy(), ids.cpu().numpy(), k),
            _tie_recall(points64, queries64, ids, true_dists, k))


def _tie_recall(points64, queries64, ids, kth_true, k) -> float:
    n = points64.shape[0]
    real = ids < n
    safe = torch.where(real, ids, torch.zeros_like(ids)).long()
    diff = points64[safe] - queries64[:, None, :]
    dd = (diff * diff).sum(-1)
    good = real & (dd <= kth_true[:, k - 1: k] * (1 + 1e-6))
    return float(good.float().mean())


def check_search_on_cpu(index, points, queries, ids, dists) -> tuple[int, int]:
    """The card's hash search against the same search on the CPU (index
    moved through ``ANNIndex.from_numpy``) for the given queries.  Rows whose
    bucket codes agree must give ids equal outside near-ties (the k-th id
    may differ only with an equal distance: its successor is not returned)
    and distances within rtol 1e-5.  Returns (rows compared, near-tie rows)."""
    cpu_index = ann.ANNIndex.from_numpy(index.to_numpy_dict(), device="cpu")
    q_cpu = queries.cpu()
    c_ids, c_d = ann.search(cpu_index, points.cpu(), q_cpu)
    codes_card, _ = query_codes(index.row_means, index.bases, queries)
    codes_cpu, _ = query_codes(cpu_index.row_means, cpu_index.bases, q_cpu)
    same = (codes_card.cpu() == codes_cpu).all(1)
    if int(same.sum()) < same.numel() - 1:
        raise AssertionError(f"bucket codes differ card vs CPU in "
                             f"{int((~same).sum())} of {same.numel()} rows")
    a_i, a_d = ids.cpu()[same], dists.cpu()[same]
    b_i, b_d = c_ids[same], c_d[same]
    k = b_i.shape[1]
    ok, tied = ids_agree(a_i[:, : k - 1], b_i[:, : k - 1], b_d)
    if not ok:
        raise AssertionError("hash search ids differ card vs CPU outside near-ties")
    if not torch.allclose(a_d, b_d, rtol=1e-5, atol=1e-4):
        err = (a_d - b_d).abs().max().item()
        raise AssertionError(f"hash search distances differ card vs CPU, max abs {err}")
    return int(same.sum()), tied


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel-only", action="store_true",
                    help="stop after the kernel-vs-plain phase")
    args = ap.parse_args()

    # -- phase 0: environment -------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    phase("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
                 f"cuda {torch.version.cuda} device {card} count "
                 f"{torch.cuda.device_count()} card [{smi}]")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- phase 1: build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = ex.build_library(verbose=True)
    ex._library()
    phase("build", f"nvcc sm_90a -> {lib_path.name} in {time.perf_counter() - t0:.2f} s")

    # -- phase 2: kernel against plain version ------------------------------------
    g = torch.Generator(device="cpu").manual_seed(args.seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    x20 = randn(20_000, 128)
    q1k = randn(1000, 128)
    check_case("n=20000 d=128 m=1000 k=10 f32", x20, q1k, 10)
    check_case("k=1", x20, q1k, 1)
    check_case("k=128", x20, q1k, 128)
    x20b = randn(20_011, 128)
    self_ids = torch.arange(1000, dtype=torch.int32, device=dev)
    check_case("n=20011 exclude=self k=10", x20b, x20b[:1000].contiguous(), 10,
               exclude=self_ids)
    x96 = randn(20_000, 96)
    check_case("d=96", x96, randn(1000, 96), 10)
    check_case("bf16 stored", x20.to(torch.bfloat16), q1k, 10, rtol=1e-3)
    check_case("f16 stored", x20.to(torch.float16), q1k, 10, rtol=1e-3)
    x8, s8 = ex.quantize_corpus(x20)
    check_case("int8 scale", x8, q1k, 10, scale=float(s8))
    check_case("m=1", x20, q1k[:1].contiguous(), 10)
    small = randn(100, 128)
    check_case("k=128 > n=100", small, q1k[:50].contiguous(), 128)
    x101 = randn(101, 32)
    check_case("k=100 = n-1 exclude=self", x101, x101,
               100, exclude=torch.arange(101, dtype=torch.int32, device=dev))

    # the main path's serving shape: n x 128 f32, 1000 queries, k = 10
    rng = np.random.default_rng(args.seed)
    X = torch.from_numpy(rng.standard_normal((N, 128), dtype=np.float32)).to(dev)
    Y = torch.from_numpy(rng.standard_normal((M, 128), dtype=np.float32)).to(dev)
    main_err = check_case(f"main shape n={N} m={M} k=10", X, Y, 10)
    check_case(f"graph chunk n={N} m={GRAPH_CHUNK} exclude=self k=10", X,
               X[:GRAPH_CHUNK], 10,
               exclude=torch.arange(GRAPH_CHUNK, dtype=torch.int32, device=dev))
    Xb = X.to(torch.bfloat16)
    check_case(f"bf16 main shape n={N} m={M} k=10", Xb, Y, 10, rtol=1e-3)
    kern_ms = cuda_ms(lambda: ex.exact_knn(X, Y, 10), reps=10)
    plain_ms = cuda_ms(lambda: ex.exact_knn_plain(X, Y, 10), reps=2)
    kern_bf16_ms = cuda_ms(lambda: ex.exact_knn(Xb, Y, 10), reps=10)
    plain_bf16_ms = cuda_ms(lambda: ex.exact_knn_plain(Xb, Y, 10), reps=2)
    del Xb
    phase("kernel", f"time n={N} m={M} k=10: f32 kernel {kern_ms:.3f} ms "
                    f"plain {plain_ms:.3f} ms; bf16 kernel {kern_bf16_ms:.3f} ms "
                    f"plain {plain_bf16_ms:.3f} ms")
    if args.kernel_only:
        phase("done", "kernel-only run: main path not driven, no result line")
        return

    # -- phase 3: main path ---------------------------------------------------------
    k, tries = 10, 10
    X64 = X.double()
    Y64 = Y.double()
    true_s = oracle64(X64, Y64, k)
    fence()

    ex.reset_launch_counts()  # every count starts at 0 for the main path
    t0 = time.perf_counter()
    index, graph, gd = ann.build(X, k, tries=tries, seed=0)
    fence()
    build_s = time.perf_counter() - t0
    build_launches = ex.launches["exact_knn"]
    if build_launches < 1:
        raise AssertionError("build did not launch the exact kernel for its graph")
    rows = torch.randperm(N, generator=g)[:200].to(dev)
    g_true = brute_force_knn(X64, X64[rows], k + 1)
    # drop the self-match (first entry, distance 0) from the oracle row
    g_ids = graph[rows]
    kth = g_true[1][:, 1:]
    gdd = ((X64[g_ids.long()] - X64[rows][:, None, :]) ** 2).sum(-1)
    g_ok = float(((gdd <= kth[:, k - 1: k] * (1 + 1e-6)) & (g_ids != rows[:, None])).float().mean())
    if g_ok != 1.0:
        raise AssertionError(f"exact graph disagrees with the float64 oracle: {g_ok}")
    phase("build", f"build n={N} d=128 k={k} tries={tries} d_short={index.d_short} "
                   f"tmax={index.tmax}: {build_s:.2f} s, graph through kernel "
                   f"({build_launches} launches), graph rows vs f64 oracle 1.0")

    ids, dists = ann.search(index, X, Y)  # warm-up
    fence()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        ids, dists = ann.search(index, X, Y)
    fence()
    hash_qps = M * reps / (time.perf_counter() - t0)
    if ids.shape != (M, k) or not torch.isfinite(dists).all():
        raise AssertionError("search returned a bad result")
    hash_recall, _ = recall_up_to_ties(X64, Y64, ids, true_s, k)
    sub = slice(0, CPU_CHECK_QUERIES)
    n_cmp, n_tied = check_search_on_cpu(index, X, Y[sub], ids[sub], dists[sub])
    phase("search", f"hash search n={N} m={M}: {hash_qps:.1f} QPS, "
                    f"recall@10 {hash_recall:.4f}; card vs CPU search on "
                    f"{CPU_CHECK_QUERIES} queries: {n_cmp} rows compared, ids equal "
                    f"outside near-ties ({n_tied} near-tie rows), distances rtol 1e-5")
    del index, graph, gd

    before = ex.launches["exact_knn"]
    results = {}
    for label, sdt in (("f32", None), ("bf16", torch.bfloat16)):
        srv = ann.Server.build(X, k, storage_dtype=sdt)
        desc = srv.describe()
        if desc["mode"] != "exact" or desc["exact_engine"] != "cuda-rank":
            raise AssertionError(f"Server auto did not resolve to the exact kernel: {desc}")
        sids, sd = srv.search(Y)  # warm-up
        fence()
        reps = 20
        t0 = time.perf_counter()
        outs = [srv.search(Y) for _ in range(reps)]
        fence()
        qps = M * reps / (time.perf_counter() - t0)
        sids, sd = outs[-1]
        if sids.shape != (M, k) or not torch.isfinite(sd).all():
            raise AssertionError("Server.search returned a bad result")
        rec, tie_rec = recall_up_to_ties(X64, Y64, sids, true_s, k)
        results[label] = (qps, rec, tie_rec)
        phase("server", f"Server exact {label} n={N} m={M}: pipelined "
                        f"{qps:.1f} QPS, recall@10 {rec:.4f} (up to ties {tie_rec:.4f})")
        del srv, outs
    if results["f32"][2] != 1.0:
        raise AssertionError(f"f32 exact recall up to ties is {results['f32'][2]}, not 1.0")
    server_launches = ex.launches["exact_knn"] - before
    if server_launches < 1:
        raise AssertionError("Server exact mode did not launch the kernel")
    total = ex.launches["exact_knn"]
    phase("counts", f"exact_knn launches on the main path: {total} "
                    f"(build {build_launches}, Server {server_launches})")

    print(json.dumps({"kernels": [{
        "name": "exact_knn", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": total, "max_abs_err": main_err,
        "ms": kern_ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
