"""GPU smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--kernel-only | --deep10m-only | --bench-only]
                          [--deep10m-graph-precision default|split3|highest]

Phases, one line each, and a non-zero exit on the first failure:

0. environment: torch/CUDA versions, the card's name and power limit;
1. build of the CUDA kernels from ``approximatenn_tpu_torch/csrc`` (one
   nvcc per source, started together);
1b. the headline bench: ``python3 bench_torch.py`` in its own process
   (``bench.py``'s config: 20,000 x 128 from ``default_rng(12345)``, a hash
   build at tries 10, 1000 queries, the exact round-5 protocol and the 1M
   tiers), its one JSON line parsed and gated: every key of ``bench.py``'s
   line, ``device`` the card's name and power limit, the exact ids at 20k
   and at 1M ("highest" and split3) 1.0 up to ties against the float64
   oracle, the 20k hash search equal to the same index's search on the
   CPU, ``Server`` auto on the rank kernel; its stderr (kernel-build
   seconds, host syncs, launch counts) echoed; the rank kernel at the bench's
   shape against its plain version, timed beside the library call and its
   bound.  ``--bench-only`` stops after it;
2. every kernel against its plain PyTorch version on the card, at the main
   path's shapes and the degenerate ones.  Rank kernel: serving f32 and
   bf16; one exact-graph chunk of 65,536 corpus rows with ``exclude`` = own
   ids; k = 1, k = 128, k > n, k = n - 1 with exclusion, n not a tile
   multiple, d = 96, bf16, f16, int8, m = 1; its two float32 designs at
   "highest", the Hopper pipeline and the tile loop, timed side by side at
   m = 1, 128, 256, the serving shape and the graph chunk, the design
   ``exact_knn`` routes to never the slower (``rank_designs``).  Two-phase emit and rescan:
   the serving shape (1M x 128 f32, m = 1000, k = 10: seg = 128, P = 12),
   k = 64 and k = 126, emit-all at k = 256 and k = 1000, n = 20,011 x 96
   (partial last segment), segments of 32 and 512 rows, bf16, f16, int8,
   m = 1, exhausted windows, emit with ``exclude``; emit also at d = 33,
   256, 960 and 2,048 with segments of 8, 256 and 1,024 rows over n =
   20,011 (splits take whole segments), m = 1 and 37, bf16, f16, int8, its
   time at the serving shape in f32 and bf16 stored beside the library's
   segment minimum.  The rescan also at d = 33 in four types (rows of no
   whole 16-byte vectors), emit-all over a split grid at add_points' block
   of 26 queries with more windows than segments (n = 100,003, P = 1,000),
   k = 1 and 128 merged from several splits, m = 1, NaN and infinite
   coordinates (never selected); its time at the serving shape and at
   add_points' emit-all shape (m = 26, P = 10,013), its effective read
   rates, and sweeps of the row scorer's lane groups (f32, bf16, int8)
   and of the emit-all split count.  Probe kernel:
   overlapping windows, clipped starts, a live bound below n, every window
   past the live bound, k = 128 over fewer distinct slots, P = m = tries =
   1, d = 96, bf16, f16, int8, d = 33 in four types, NaN and infinite
   coordinates (the main shape is checked in step 4, with its L2 read rate
   and a sweep of warps a pair and the row scorer's geometry).
   Rescan-merge and streaming kernels: the rank kernel's degenerate set
   plus d = 33 and m = 37, ``compute_dtype=torch.bfloat16`` on an f32
   corpus (the rank kernel too), and the serving shape.  Rank and rescan
   merge also d = 33, 256, 960 and 2,048 (feature chunks past d = 128 in
   f32) with k = 1 and 128, m = 1 and 37, ``exclude``, bf16, f16 and int8;
   the stream d = 256 and 768 (smaller ring slots).  All four
   tensor-core kernels (rank, rescan merge, stream, emit): one-hot integer
   rows that show a wrong fragment index (f32 and bf16, ids and distances
   or minima exact); the rank family: the float64
   oracle at the serving shape (recall@10 up to ties 1.0 in f32); all
   four: their times beside the library call's (f32 and bf16), the bound
   and their three TF32 passes' tensor-core time, and their effective L2
   read rates.  Then the ``matmul_precision`` tiers of a float32 stream
   (phase ``precision``): the JAX package's TPU-smoke gate (n = 20,000 x
   128, m = 1000, k = 10 from ``default_rng(0)``: recall@10 against the
   float64 oracle >= 1.0 / 1.0 / 0.985 at "highest" / "split3" /
   "default" for the rank kernel, the rescan merge, the stream and
   ``exact_knn_twophase``); at the serving shape each of the four
   tensor-core kernels at split3 and default against its plain version at
   that tier, recall@10 up to ties (split3 1.0), default's ids moved from
   highest's, every tier's time in one call ("highest" beside the kernel
   table's) with its bound and a library yardstick of bf16 matmuls; one
   graph chunk at each tier;
3. the main path at the SIFT-1M shape (n = 1M x d = 128 float32 from
   ``--seed``, 1000 queries, k = 10, tries = 10), each path with the launch
   counts set to 0 just before it and read just after: ``build`` (exact kNN
   graph through the rank kernel) -> ``search``; ``build`` with
   ``graph_precision`` split3 and default (seconds, edges shared with the
   "highest" graph, launches at the tier); the two-phase engine
   (``exact_knn_twophase`` at k = 10 and 64, ``exact_search`` at k = 256,
   ``Server`` with ``twophase_min_n`` = n in f32 and bf16); ``Server``
   auto (the engine ``TWOPHASE_MIN_N`` picks at n); the two-phase servers with
   ``no_twophase=True`` (the rank kernel); ``merge``: the f32 server with
   ``no_twophase=True``, ``merge="rescan"`` and ``stream=True`` pinned, each
   in f32 and with ``compute_dtype=torch.bfloat16`` (recall gated at 1.0 up
   to ties in f32, ids equal to the rank kernel's outside near-ties,
   ``describe()`` and the launch counts naming the pinned kernel);
   ``Server`` auto with ``matmul_precision`` highest, split3 and default
   (QPS in one call), the two-phase server and the pinned rescan merge
   and stream at split3 and default (the launch counts naming the tier's
   kernel on every path).  Results
   are checked against a float64 oracle on the card, and the card's hash
   search against the same search on the CPU; then the sharded layer
   (``parallel/``, phase ``sharded``) on a one-rank NCCL group at the same
   shape: ``build_sharded`` equal to ``build`` (bases, row means, tables,
   counts, exact graph), ``search_sharded`` equal to ``search``,
   ``search_exact_sharded`` through the rank kernel and with
   ``twophase=True`` (recall@10 1.0 up to ties, ids of ``exact_search``
   outside near-ties), each sharded call's QPS beside the single-card
   call's; then the serving surface on it (phase ``sharded_server``):
   the JAX TPU gate ``sharded_server_1chip`` (``ShardedServer`` exact with
   ``twophase_min_n`` = 10,000: engine "twophase", recall@10 1.0 on 200
   queries), that server, ``ShardedServer`` auto and the int8 tier against
   their single-card ``Server`` (ids equal outside near-ties, the int8
   scale equal, QPS beside the server's and the raw
   ``search_exact_sharded``'s), the int8 server saved and loaded;
4. packed hash serving at the SIFT-1M stand-in's full width: a clustered
   1M x 128 float32 corpus (``data/synthetic.clustered_gaussian``, 10,000
   clusters) with queries drawn as the JAX package's stand-ins draw them;
   ``Server(mode="hash", layout="packed")`` with bf16 rows at window 96 and
   18 directed probes (the probe kernel, checked against its plain version
   at that shape with k = 10 and 50; its two designs, ``probe_designs``,
   timed side by side at m = 1000, 10,000 and on each side of the design
   rule's batch gate, failing where the routed one is slower), window 192
   with ``rerank_width`` 50,
   the f32 and int8 views; recall@10 against a float64 oracle (>= 0.75 at
   window 96, a gross-error guard), the card against the same search on
   the CPU on 50 queries; the sharded layer on that corpus (one NCCL
   rank: ``build_sharded`` + ``packed_sharded`` bf16 equal to the packed
   ``Server``'s index and view, ``search_packed_fused_sharded`` equal to
   ``search_packed_fused`` and timed in turns with it, then the all-gather
   merge alone beside a merge that gathers ids and distances apart: host
   times, parts, profile; ``ShardedServer`` hash packed at the packed
   ``Server``'s settings, equal to it, saved and loaded; ``tune_sharded``
   on the corpus, every trial timed, with the card's memory at each
   build: the exact tiers freed before the hash build) and on two gloo
   ranks sharing the card
   (n = 200,001, a pad row on the last shard, hash graph; the fused packed
   search and ``search_exact_sharded`` with and without ``twophase``; gates:
   the exact searches equal the global ``exact_search``, no id >= n, the
   card equals the same two-rank search on the CPU on 50 queries with the
   index carried by ``to_numpy``/``from_numpy``; ``ShardedServer`` exact
   with ``twophase_min_n`` = 1 and hash packed equal to those raw
   searches, each saved and loaded on the two ranks); then ``tune`` on that
   corpus and those queries (k = 10, tries = 10, target recall 0.9, every
   trial timed, batch 1000, bf16 packed rows, 2 probe counts x 2 windows x
   2 rerank widths and the f32 and bf16 exact tiers: every trial and the
   winner; every packed trial on the probe kernel, and ``report.server()``
   serving the winner at its recall within 0.005); then updates on the
   packed server (remove 1% of ids, add 10,000 points; the path must launch the probe and the exact
   rows' kernels, and the add is replayed under ``torch.profiler`` and
   split by stage and kernel);
5. the harness CLIs on the card: ``test_correctness`` (index mode and
   ``-y 20``, "Prob correct" >= 0.8), ``time_results``, ``ann_bench`` on
   the gaussian-100k stand-in through the probe kernel (one JSON line);
   then the parity band, the JAX package's TPU gate as card vs CPU:
   ``compare_results`` at n = 2000, d = 64, k = 10, tries 4, seed 11, once
   with ``--arbitrate`` (the diff ids as tie_f64, tie_f32, real) and once
   with ``--max-diff-frac 0.0005``, which must exit 0;
6. the rank/two-phase crossover on prefixes of the corpus (250k, 500k,
   1M) and on 2M and 4M corpora drawn on the card (f32 and bf16), with the
   threshold the ``TWOPHASE_MIN_N`` rule takes from it, and
   ``torch.profiler`` breakdowns of two-phase and packed serving;
7. ``deep10m``, after the earlier phases' tensors are freed: the JAX
   package's largest one-chip deployment, Deep-10M (the stand-in
   ``synthesize("deep-10m", 10_000_000, 96, 1000)``, k = 10), where every
   engine the router picks is one that engages only past 8M rows.  The
   float64 oracle on the card in chunks and ``ensure_groundtruth``;
   ``exact_search`` (two-phase) and with ``no_twophase`` (the rank kernel)
   on the float32 corpus, ``Server`` auto with bf16 and int8 storage
   (two-phase): routes, launches, recall@10 (f32 1.0 up to ties), QPS at
   batches of 1000 and 32, peak memory; emit and rescan at ``seg`` 512
   (f32, bf16, int8) and the rank kernel against their plain versions on
   100 queries, their times at m = 1000 beside their bounds (library calls
   at m = 100); the Hopper emit (bf16: ``csrc/knn_wgmma.cuh``) at m = 1,
   26, 1,000 and the Deep-10M cell's 10,000 beside its bound, and at m = 1
   and 26 beside the tile loop that served 16-bit corpora before it (the
   Hopper emit must not be slower there); one exact-graph chunk at each
   tier, then ``Server.build``
   auto on the float32 corpus (hash: tries 6, capacity 48, exact graph at
   ``DEEP_GRAPH_PRECISION``, int8 packed rows, window 96) with each build
   stage's seconds and peak memory, the graph against its tier's float64
   oracle on 1,000 rows; the packed serving points (windows 32 and 96 x 18
   and 48 probes, and rerank 50) with recall@10, QPS and probe launches
   (recall >= 0.75 at window 96, 18 probes), the probe against its plain
   version at 18 and 48 probes, the card against the CPU on 50 queries;
   then ``Server`` int8 at 32M x 96 drawn on the card (two-phase, recall
   on 100 queries against the float64 oracle, QPS, peak memory; emit and
   rescan against their plain versions on 16 queries over the 3.07e9-byte
   corpus); then the crossover at 8M x 128 and 10M x 96 and the n its rule
   gives.  ``--deep10m-only`` runs this phase alone after the build, and
   ``--deep10m-graph-precision`` sets the graph's tier.

Before the last line it prints one JSON object with each kernel's launch
count on the main path, its error against the plain version, its time, the
plain version's, its bound and a library call's time where one exists; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
without the package beside it, the script fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import approximatenn_tpu_torch as ann
import bench_torch
from approximatenn_tpu_torch.data.datasets import ensure_groundtruth, synthesize
from approximatenn_tpu_torch.data.synthetic import clustered_gaussian, gaussian
from approximatenn_tpu_torch.engine.search import probe_starts
from approximatenn_tpu_torch.harness import ann_bench, compare_results, test_correctness
from approximatenn_tpu_torch.harness import time_results
from approximatenn_tpu_torch.harness.scoring import ids_agree, recall_at_k
from approximatenn_tpu_torch.ops import exact as ex
from approximatenn_tpu_torch.ops import probe as pr
from approximatenn_tpu_torch.ops import twophase as tp
from approximatenn_tpu_torch.ops.distance import brute_force_knn
from approximatenn_tpu_torch.ops.hash import query_codes
from approximatenn_tpu_torch.ops.topk import topk_no_dedup
from approximatenn_tpu_torch.parallel import dryrun, multihost
from approximatenn_tpu_torch.parallel import serving as sv
from approximatenn_tpu_torch.parallel import sharded as sh
from approximatenn_tpu_torch.utils.profiling import StageTimes, fence
from approximatenn_tpu_torch.utils.runtime import card_name_and_limit

KERNELS = {  # name: (source, the TPU kernel it replaces)
    "exact_knn": ("approximatenn_tpu_torch/csrc/exact_knn.cu",
                  "approximatenn_tpu/ops/pallas_exact.py:267"),
    "twophase_emit": ("approximatenn_tpu_torch/csrc/twophase_knn.cu",
                      "approximatenn_tpu/ops/pallas_exact.py:383"),
    "twophase_rescan": ("approximatenn_tpu_torch/csrc/twophase_knn.cu",
                        "approximatenn_tpu/ops/pallas_exact.py:1144"),
    # the same kernel's emit-all launches (k > 128: every window row)
    "twophase_rescan_all": ("approximatenn_tpu_torch/csrc/twophase_knn.cu",
                            "approximatenn_tpu/ops/pallas_exact.py:1144"),
    "probe_topk": ("approximatenn_tpu_torch/csrc/probe_knn.cu",
                   "approximatenn_tpu/ops/pallas_probe.py:59"),
    "exact_knn_rescan": ("approximatenn_tpu_torch/csrc/rescan_merge_knn.cu",
                         "approximatenn_tpu/ops/pallas_exact.py:433"),
    "exact_knn_stream": ("approximatenn_tpu_torch/csrc/stream_knn.cu",
                         "approximatenn_tpu/ops/pallas_exact.py:544"),
}
# the rank family: kernel -> (exact_knn's keywords, plain version, launch key)
VARIANTS = {
    "rank": ({}, ex.exact_knn_plain, "exact_knn"),
    "rescan": ({"merge": "rescan"}, ex.exact_knn_rescan_plain, "exact_knn_rescan"),
    "stream": ({"stream": True}, ex.exact_knn_stream_plain, "exact_knn_stream"),
}
N = 1_000_000  # SIFT-1M's shape: N x 128 float32
M = 1000  # queries per batch
GRAPH_CHUNK = 65536  # engine/build.py:exact_graph_chunked's chunk_q
CPU_CHECK_QUERIES = 50
# packed serving (the JAX package's fused SIFT-1M stand-in configuration)
N_CLUSTERS = 10_000
PACKED_WINDOW, PACKED_PROBES, RERANK = 96, 18, 50
PROBE_DESIGN_M = 10_000  # the hash cell's batch, where the probe designs are compared
# recall@10 at window 96: a gross-error guard.  This corpus (Zipf 1.2 over
# 10,000 clusters, spread 4) puts most points in buckets far deeper than
# 96 slots; the port's recall equals the JAX package's on a 100k prefix
# (tests/parity_packed_prefix.py), and the card's search equals the CPU's
RECALL_GUARD = 0.75
N_REMOVE, N_ADD = 10_000, 10_000
# tune on the packed corpus: target recall@10 and the grid (cut to the
# smoke's time: 2 probe counts x 2 windows x 2 rerank widths, 2 exact tiers)
TUNE_TARGET = 0.9
TUNE_GRID = dict(probe_grid=(None, PACKED_PROBES), window_grid=(PACKED_WINDOW, 192),
                 rerank_grid=(None, RERANK), exact_tiers=(None, "bf16"))
# report.server() must serve the winner at the recall the tuner measured
TUNE_SERVER_TOL = 0.005
# the card-vs-CPU parity gate of the JAX package's TPU smoke, band unchanged
PARITY_ARGS = ["-n", "2000", "-d", "64", "-k", "10", "-t", "4", "-o", "1", "--seed", "11"]
PARITY_BAND = "0.0005"
# the sharded phase's two gloo ranks on the one card: n not a multiple of 2,
# so the last shard holds a zero pad row
SHARDED_N2, SHARDED_RANKS, SHARDED_TIMEOUT = 200_001, 2, 600
# the JAX package's TPU gate sharded_server_1chip (harness/tpu_smoke.py:194-213):
# ShardedServer on one chip with this two-phase threshold, recall@10 1.0 on
# this many queries
SERVER_TWOPHASE_MIN_N, SERVER_GATE_QUERIES = 10_000, 200
# tune_sharded on packed-1M: the exact f32 and bf16 tiers, 18 probes, 2 windows
# x 2 rerank widths
SHARDED_TUNE_GRID = dict(probe_grid=(PACKED_PROBES,), window_grid=(PACKED_WINDOW, 192),
                         rerank_grid=(None, RERANK), exact_tiers=(None, "bf16"))
# add_points' exact rows after the removals: k + 1 (the self-match) + the
# tombstones, through the two-phase engine's emit-all rescan
ADD_K = 10 + 1 + N_REMOVE
# H100 SXM datasheet peaks at 700 W (not measured here): fp32 on the CUDA
# cores and HBM3; a kernel's bound is the larger of its two times
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12  # tensor cores, dense
PEAK_BF16 = 989e12  # tensor cores, dense
PEAK_BYTES = 3.35e12
# profiler rows with device time that are no kernel: the tracer's mark for
# a full launch queue (the host waiting to launch)
NOT_KERNELS = ("Command Buffer Full",)
# the precision tiers of a float32 stream and the JAX package's TPU-smoke
# recall@10 floors for them (harness/tpu_smoke.py:72-84), at its shape
TIER_FLOORS = {"highest": 1.0, "split3": 1.0, "default": 0.985}
TIER_GATE_SHAPE = (20_000, 128, 1000, 10)  # n, d, m, k
BF16_PASSES = {"split3": 3, "default": 1}  # bf16 MMA passes a tier makes
# the tensor-core kernels, which take a tier
TIER_KERNELS = ("exact_knn", "exact_knn_rescan", "exact_knn_stream", "twophase_emit")
# their "highest" ms at the serving shape in PERF.md's kernel table, taken
# before the tiers existed: the tier work must leave that path in place
HIGHEST_REFERENCE_MS = {"exact_knn": 8.735, "twophase_emit": 9.511,
                        "exact_knn_rescan": 8.701, "exact_knn_stream": 15.606}
PEAK_INT8 = 1979e12  # tensor cores, dense int8 (TOP/s)
# the Deep-10M deployment, the JAX package's largest one-chip configuration
# (baselines/logs_r3_10m_exactgraph.txt): the stand-in's shape, the hash
# index's settings and its serving points (window, probes, rerank_width)
DEEP_N, DEEP_D, DEEP_NQ, DEEP_K = 10_000_000, 96, 1000, 10
DEEP_TRIES, DEEP_CAPACITY = 6, 48
DEEP_POINTS = ((32, 18, None), (32, 48, None), (96, 18, None), (96, 48, None), (96, 18, 50))
DEEP_BATCHES = (1000, 32)
DEEP_CHECK_QUERIES = 100  # kernels against their plain versions, library calls
DEEP_GRAPH_ROWS = 1000  # exact-graph rows held to the oracle
# the 10M graph's tier in the whole smoke: at "split3" (the JAX build's
# advice for huge builds) the build alone takes ~620 s on one H100, which
# does not fit the smoke's time beside the earlier phases; run it alone
# with --deep10m-only --deep10m-graph-precision split3
DEEP_GRAPH_PRECISION = "default"
# the int8 route's edge: EXACT_MAX_N_DEFAULT x 4 rows; queries for the
# plain versions (2^31-byte corpora) and for the float64 oracle
EDGE_N, EDGE_CHECK_QUERIES, EDGE_RECALL_QUERIES = 32_000_000, 16, 100
# bench_torch.py run in its own process: its time limit, and the head of
# the stderr line that carries its launch counts
BENCH_TIMEOUT = 600
BENCH_LAUNCHES = "[bench] launches "


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
               rtol=1e-5, atol=1e-4, kernel="rank", compute_dtype=None,
               matmul_precision="highest") -> float:
    """A kernel of the rank family against its plain version (at the same
    precision tier)."""
    kw, plain, _ = VARIANTS[kernel]
    ia, da = ex.exact_knn(points, queries, k, exclude=exclude, scale=scale,
                          compute_dtype=compute_dtype, matmul_precision=matmul_precision, **kw)
    ib, db = plain(points, queries, k + 1, exclude=exclude, scale=scale,
                   compute_dtype=compute_dtype, matmul_precision=matmul_precision)
    fence()
    if kernel != "rank":
        label = f"{kernel} {label}"
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
    tol = torch.maximum(atol + rtol * db[:, :k].abs(),
                        term_floor(ex.compute_corpus(points, compute_dtype), queries,
                                   ib[:, :k], scale, with_qn=True))
    if not bool(((da - db[:, :k]).abs() <= tol)[fin].all()):
        err = (da[fin] - db[:, :k][fin]).abs().max().item()
        raise AssertionError(f"{label}: distances differ, max abs {err}")
    n = points.shape[0]
    if not bool((ia[~fin] == n).all()):
        raise AssertionError(f"{label}: sentinel rows must carry id n")
    err = (da[fin] - db[:, :k][fin]).abs().max().item() if fin.any() else 0.0
    phase("kernel", f"{label}: ok (max_abs_err {err:.3g}, near-tie rows {tied})")
    return err


def bound(flop: float, nbytes: float) -> tuple[float, str]:
    """(least milliseconds the card could take, what bounds it)."""
    t_ops, t_bytes = flop / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def gather_sweep(label, fn, d: int, itemsize: int, reps: int = 20, extra=(None,)) -> None:
    """Times of a gather kernel (the probe or the rescan) at every lane
    group its row scorer takes (G = 4 to 32 lanes a row; ``fn(geometry,
    e)`` for each ``e`` of ``extra``), one line, CUDA events, ``reps``
    calls each."""
    times = []
    for e in extra:
        for lanes in (4, 8, 16, 32):
            ms = cuda_ms(lambda: fn(ex.gather_geometry(d, itemsize, lanes=lanes), e), reps=reps)
            times.append((ms, f"{'' if e is None else f'{e} '}G{lanes}"))
    best = min(times)
    phase("kernel", f"sweep {label} (default G{ex.gather_geometry(d, itemsize)[1]}; best "
                    f"{best[1]} {best[0]:.3f} ms): "
                    + ", ".join(f"{name} {ms:.3f}" for ms, name in times))


def check_tile_layout(dev) -> None:
    """The fragment layout of the four tensor-core kernels (rank, rescan
    merge, stream, two-phase emit): one-hot integer rows (row r holds 1 +
    r // d in feature r % d) against unit-vector queries, so that a wrong
    row, feature or query index of any element shows, which random data
    hides.  Every product is exact in every type, so ids and distances (emit:
    segment minima and their ids) must equal the plain version's bit for
    bit: the rank kernel's and emit's (ties by id), the stream's on the
    kernel's 128-row tiles and the rescan merge's on its tiles and corpus
    splits (which decide the ids kept among equal distances)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, d in ((1000, 128), (700, 33)):
        r = torch.arange(n, device=dev)
        X = torch.zeros((n, d), device=dev)
        X[r, r % d] = (1 + r // d).float()
        Y = torch.eye(d, device=dev)
        excl = torch.arange(d, dtype=torch.int32, device=dev)
        for kern in ("rank", "rescan", "stream"):
            for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                for k, e in ((10, None), (10, excl), (128, None)):
                    ia, da = ex.exact_knn(X.to(dt), Y, k, exclude=e, **VARIANTS[kern][0])
                    if kern == "rank":
                        ib, db = ex.exact_knn_plain(X.to(dt), Y, k, exclude=e)
                    elif kern == "rescan":
                        qb, tn = ex.tile_geometry("rescan_merge_knn")
                        ib, db = ex.exact_knn_rescan_plain_by_splits(
                            X.to(dt), Y, k, ex.splits(d, n, sms, qb, tn), tn, exclude=e)
                    else:
                        ib, db = ex.exact_knn_stream_plain(X.to(dt), Y, k, exclude=e, tile=128)
                    fence()
                    if not (torch.equal(ia, ib) and torch.equal(da, db)):
                        raise AssertionError(f"{kern} layout {label} n={n} d={d} k={k}: ids or "
                                             "distances differ from the plain version's")
            phase("kernel", f"{kern} fragment layout n={n} d={d} m={d} k=10,128 exclude f32 "
                            "bf16: ids and distances equal to the plain version's "
                            "(max_abs_err 0)")
        for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            for seg, e in ((8, None), (128, excl), (256, None), (256, excl)):
                va, ia = tp.segment_minima(X.to(dt), Y, seg, exclude=e)
                vb, ib = tp.segment_minima_plain(X.to(dt), Y, seg, exclude=e)
                fence()
                if not (torch.equal(va, vb) and torch.equal(ia, ib)):
                    raise AssertionError(f"emit layout {label} n={n} d={d} seg={seg}: minima or "
                                         "ids differ from the plain version's")
        phase("kernel", f"emit fragment layout n={n} d={d} m={d} seg=8,128,256 exclude f32 "
                        "bf16: minima and ids equal to the plain version's (max_abs_err 0)")


def near_tie_ok(points, q, ids_a, ids_b, rtol=1e-5, tier="highest") -> bool:
    """Rows (r, id_a, id_b) of a kernel/plain id disagreement are allowed
    when both ids lie at float64 squared distances within ``rtol``; at a
    bf16 tier, distances |x|^2 + |q|^2 - 2 q.x with q.x summed in float64
    from the tier's bf16 factors (what the kernel and its plain version
    both round to float32)."""
    x = points.double()
    qd = q.double()
    xa, xb, qr = x[ids_a[:, 1].long()], x[ids_b.long()], qd[ids_a[:, 0]]
    if tier == "highest":
        da = (xa - qr).pow(2).sum(-1)
        db = (xb - qr).pow(2).sum(-1)
    else:
        def dist(xr):
            (qh, ql), (xh, xl) = ex.split_bf16(qr), ex.split_bf16(xr)
            qh, ql, xh, xl = qh.double(), ql.double(), xh.double(), xl.double()
            dot = qh * xh if tier == "default" else qh * xh + qh * xl + ql * xh
            return (xr * xr).sum(-1) + (qr * qr).sum(-1) - 2.0 * dot.sum(-1)

        da, db = dist(xa), dist(xb)
    return bool(((da - db).abs() <= rtol * db.abs()).all())


def kernel_queries(points, queries, scale):
    """Queries as the kernels multiply them (rounded to a half corpus's
    type, quantised for int8)."""
    q, _, _ = ex._prepare(points, queries, scale)
    if points.dtype in (torch.bfloat16, torch.float16):
        q = q.to(points.dtype).float()
    return q


# fp32 ulps of the largest term: the kernel and its plain version both
# round |x|^2 and 2 q.x (each up to ~|x|^2 + |q||x|) and sum them in other
# orders, so where those terms are large against the result (scores of
# rows far from the query, corpora of large norm) their difference is a
# few ulps of the terms, not of the result
TERM_ULPS = 16 * 2.0 ** -23


def term_floor(points, queries, ids, scale=None, with_qn=False):
    """Per result element, :data:`TERM_ULPS` of the terms the kernels
    round: |x|^2 + 2 |q| |x| (+ |q|^2 for a distance, ``with_qn``) of the
    row ``ids`` and its query, in the kernels' domain (int8: quantised,
    then times scale^2 for a distance)."""
    _, qn, scale2 = ex._prepare(points, queries, scale)
    pn = ex.point_norms(points)[ids.clamp(0, points.shape[0] - 1).long()]
    qn = qn[:, None]
    terms = pn + 2.0 * torch.sqrt(pn * qn) + (qn if with_qn else 0.0)
    return TERM_ULPS * terms * (scale2 if with_qn else 1.0)


def check_emit(label, points, queries, seg, *, exclude=None, scale=None,
               matmul_precision="highest") -> float:
    """The emit kernel against its plain version (at the same precision
    tier): minima at rtol 1e-5 / atol 1e-4 (both widen to fp32; only the
    summation order differs), argmin ids equal outside near-ties."""
    va, ia = tp.segment_minima(points, queries, seg, exclude=exclude, scale=scale,
                               matmul_precision=matmul_precision)
    vb, ib = tp.segment_minima_plain(points, queries, seg, exclude=exclude, scale=scale,
                                     matmul_precision=matmul_precision)
    fence()
    n_seg = -(-points.shape[0] // seg)
    if va.shape != (queries.shape[0], n_seg) or ia.dtype != torch.int32:
        raise AssertionError(f"{label}: bad output {va.shape} {ia.dtype}")
    fin = torch.isfinite(vb)
    if not torch.equal(fin, torch.isfinite(va)):
        raise AssertionError(f"{label}: +inf pattern differs")
    tol = torch.maximum(1e-4 + 1e-5 * vb.abs(), term_floor(points, queries, ib, scale))
    if not bool(((va - vb).abs() <= tol)[fin].all()):
        err = (va[fin] - vb[fin]).abs().max().item()
        raise AssertionError(f"{label}: minima differ, max abs {err}")
    bad = torch.nonzero((ia != ib) & fin)
    if bad.numel():
        pairs = torch.stack([bad[:, 0], ia[bad[:, 0], bad[:, 1]]], 1)
        if not near_tie_ok(points.float(), kernel_queries(points, queries, scale), pairs,
                           ib[bad[:, 0], bad[:, 1]],
                           tier=ex.stream_tier(points.dtype, matmul_precision)):
            raise AssertionError(f"{label}: argmin ids differ outside near-ties")
    err = (va[fin] - vb[fin]).abs().max().item() if fin.any() else 0.0
    phase("kernel", f"emit {label}: ok (max_abs_err {err:.3g}, near-tie "
                    f"segments {bad.shape[0]})")
    return err


def window_starts(points, queries, P, seg, scale=None):
    """The rescan's windows: the P best segments per query (start n for an
    exhausted pick), as exact_knn_twophase picks them."""
    n = points.shape[0]
    sel, _ = tp.segment_merge(points, queries, P, seg, scale=scale)
    return torch.where(sel < n, sel // seg * seg, torch.full_like(sel, n))


def check_rescan(label, points, q, starts, seg, k) -> float:
    """The rescan kernel against its plain version: ids equal outside
    near-ties (emit-all: equal), distances at rtol 1e-5 / atol 1e-4."""
    ia, da = tp.rescan_windows(points, q, starts, seg, k)
    if k is None:  # emit-all: every window row, positions fixed
        ib, db = tp.rescan_windows_plain(points, q, starts, seg, None)
        fence()
        if not torch.equal(ia, ib):
            raise AssertionError(f"{label}: emit-all ids differ")
        fin = torch.isfinite(db)
        ok_fin = torch.equal(fin, torch.isfinite(da))
        tied = 0
    else:
        ib, db = tp.rescan_windows_plain(points, q, starts, seg, k + 1)
        fence()
        if ia.shape != (q.shape[0], k) or ia.dtype != torch.int32:
            raise AssertionError(f"{label}: bad output {ia.shape} {ia.dtype}")
        ok, tied = ids_agree(ia, ib[:, :k], db, rtol=1e-5)
        if not ok:
            raise AssertionError(f"{label}: ids differ outside near-ties")
        db = db[:, :k]
        fin = torch.isfinite(db)
        ok_fin = torch.equal(fin, torch.isfinite(da)) and bool((ia[~fin] == points.shape[0]).all())
    if not ok_fin:
        raise AssertionError(f"{label}: sentinel pattern differs")
    if not torch.allclose(da[fin], db[fin], rtol=1e-5, atol=1e-4):
        err = (da[fin] - db[fin]).abs().max().item()
        raise AssertionError(f"{label}: distances differ, max abs {err}")
    err = (da[fin] - db[fin]).abs().max().item() if fin.any() else 0.0
    phase("kernel", f"rescan {label}: ok (max_abs_err {err:.3g}, near-tie rows {tied})")
    return err


def rescan_rows(starts, n, seg) -> tuple[int, int]:
    """(the (query, row) pairs the rescan scores for these windows, the
    distinct corpus rows they cover).  The pairs set its operations; the
    distinct rows are the least it must read, since queries that pick the
    same segment share its rows."""
    pairs = int(torch.clamp(n - starts.long(), 0, seg).sum())
    uniq = torch.unique(starts[starts < n].long())
    return pairs, int(torch.clamp(n - uniq, 0, seg).sum())


def check_probe(label, rows, queries, starts, *, k, n, n_pad, window) -> float:
    """The probe kernel against its plain version on the same prepared
    inputs: per (query, table) the slots equal outside near-ties, distances
    at rtol 1e-5 / atol 1e-4 (both widen to fp32; only the summation order
    differs), (n, +inf) past the live candidates."""
    pa, da = pr.probe_topk(rows, queries, starts, k=k, n=n, n_pad=n_pad, window=window)
    q, st, w = pr.prepare(rows, queries, starts, n_pad=n_pad, window=window)
    kk = min(k + 1, ex.KMAX)
    pb, db = pr.probe_topk_plain(rows, q, st, k=kk, n=n, n_pad=n_pad, window=w)
    fence()
    m, tries = starts.shape[:2]
    if pa.shape != (m, tries, k) or pa.dtype != torch.int32 or da.dtype != torch.float32:
        raise AssertionError(f"probe {label}: bad output {pa.shape} {pa.dtype} {da.dtype}")
    pa, da = pa.reshape(m * tries, k), da.reshape(m * tries, k)
    pb, db = pb.reshape(m * tries, kk), db.reshape(m * tries, kk)
    ok, tied = ids_agree(pa, pb[:, :k], db, rtol=1e-5)
    if not ok:
        raise AssertionError(f"probe {label}: slots differ outside near-ties")
    db = db[:, :k]
    fin = torch.isfinite(db)
    if not torch.equal(fin, torch.isfinite(da)) or not bool((pa[~fin] == n).all()):
        raise AssertionError(f"probe {label}: sentinel pattern differs")
    if not torch.allclose(da[fin], db[fin], rtol=1e-5, atol=1e-4):
        err = (da[fin] - db[fin]).abs().max().item()
        raise AssertionError(f"probe {label}: distances differ, max abs {err}")
    err = (da[fin] - db[fin]).abs().max().item() if fin.any() else 0.0
    phase("kernel", f"probe {label}: ok (max_abs_err {err:.3g}, near-tie rows {tied})")
    return err


def union_slots(starts, window: int) -> torch.Tensor:
    """Slots covered by the union of the equal-length windows of each row
    of ``starts`` (..., P)."""
    s, _ = torch.sort(starts.long(), dim=-1)
    prev_end = torch.cat([s[..., :1], s[..., :-1] + window], dim=-1)
    return torch.clamp(s + window - torch.maximum(s, prev_end), min=0).sum(-1)


def probe_work(starts, window: int) -> tuple[int, int]:
    """(distinct (query, table, slot) triples the probe scores, distinct
    (table, slot) rows its windows cover) for widened ``starts`` (m, tries,
    P): the triples set its operations; the rows are the least it must
    read, since queries probing the same buckets share their rows."""
    triples = int(union_slots(starts, window).sum())
    rows = sum(int(union_slots(torch.unique(starts[:, t].reshape(-1))[None], window).sum())
               for t in range(starts.shape[1]))
    return triples, rows


def rescan_gather_checks(randn, dev) -> None:
    """The rescan's row scorer and split grid beyond the main shapes: rows
    of no whole 16-byte vectors (d = 33, four types), emit-all over a
    split grid at add_points' block of 26 queries with more windows than
    segments, k = 1 and 128 merged from several splits, one query, and
    rows holding NaN or infinite coordinates (never selected)."""
    x33, q33 = randn(20_011, 33), randn(200, 33)
    x8, s8 = ex.quantize_corpus(x33)
    for label, pts, sc in (("f32", x33, None), ("bf16", x33.to(torch.bfloat16), None),
                           ("f16", x33.to(torch.float16), None), ("int8", x8, float(s8))):
        st = window_starts(pts, q33, 12, 64, scale=sc)
        qk = kernel_queries(pts, q33, sc)
        check_rescan(f"{label} d=33 n=20011 m=200 seg=64 k=10", pts, qk, st, 64, 10)
        check_rescan(f"{label} d=33 n=20011 m=200 seg=64 emit-all", pts, qk, st, 64, None)
    x, q = randn(100_003, 128), randn(26, 128)
    st = window_starts(x, q, 1000, 128)  # 782 segments: 218 exhausted picks a query
    check_rescan("emit-all n=100003 m=26 P=1000 seg=128 (P x seg > n, split grid)", x, q, st,
                 128, None)
    for kk in (1, 128):
        check_rescan(f"split grid n=100003 m=26 P=40 seg=128 k={kk}", x, q,
                     st[:, :40].contiguous(), 128, kk)
    check_rescan("split grid n=100003 m=1 P=40 seg=128 k=10", x, q[:1].contiguous(),
                 st[:1, :40].contiguous(), 128, 10)
    xb, qb = randn(20_011, 96), randn(300, 96)
    st = window_starts(xb, qb, 12, 64)  # windows picked on the finite rows
    bad = torch.randperm(20_011, generator=torch.Generator().manual_seed(9))[:600].to(dev)
    xb[bad[:200], 3] = float("nan")
    xb[bad[200:400]] = float("inf")
    xb[bad[400:], 0] = -float("inf")
    for label, pts in (("f32", xb), ("bf16", xb.to(torch.bfloat16))):
        qk = kernel_queries(pts, qb, None)
        for kk in (10, None):
            check_rescan(f"NaN and infinite coordinates {label} n=20011 m=300 seg=64 k={kk}",
                         pts, qk, st, 64, kk)
        ids, _ = tp.rescan_windows(pts, qk, st, 64, 10)
        if torch.isin(ids, bad.to(ids.dtype)).any():
            raise AssertionError(f"rescan {label}: a NaN or infinite row was selected")


def synthetic_probe_checks(randn, dev) -> None:
    """The probe kernel's degenerate shapes on random rows (the main shape
    is checked on the packed view in :func:`packed_serving`)."""
    g = torch.Generator(device="cpu").manual_seed(1)
    n_pad = 4096

    def case(label, dt, m, tries, P, d, window, k, n, starts=None, overlap=False):
        rows = randn(tries * n_pad, d)
        q = randn(m, d)
        if dt == "int8":
            rows, s8 = ex.quantize_corpus(rows)
            q = q / s8
        elif dt is not None:
            rows = rows.to(dt)
        hi = n_pad - window
        if starts is None:
            if overlap:
                base = torch.randint(0, hi - window, (m, tries, 1), generator=g)
                starts = base + torch.randint(0, window, (m, tries, P), generator=g)
            else:
                starts = torch.randint(0, hi + 1, (m, tries, P), generator=g)
        starts = torch.clamp(starts, max=hi).to(torch.int32).to(dev)
        check_probe(label, rows, q, starts, k=k, n=n, n_pad=n_pad, window=window)

    case("overlapping windows m=500 tries=4 P=18 w=96 k=10", None, 500, 4, 18, 128, 96,
         10, 4000, overlap=True)
    case("clipped starts", None, 200, 4, 6, 128, 96, 10, 4000,
         starts=torch.full((200, 4, 6), n_pad, dtype=torch.int32))
    case("live bound 2000 < n", None, 200, 4, 18, 128, 96, 10, 2000)
    case("every window past the live bound", None, 100, 2, 4, 128, 32, 10, 10,
         starts=torch.randint(100, 4000, (100, 2, 4), generator=g))
    case("k=128 over fewer distinct slots", None, 100, 2, 2, 128, 16, 128, 4000)
    case("P=1 m=1 tries=1", None, 1, 1, 1, 128, 96, 10, 4000)
    case("d=96", None, 300, 3, 8, 96, 40, 50, 4000, overlap=True)
    for dt, label in ((torch.bfloat16, "bf16"), (torch.float16, "f16"), ("int8", "int8")):
        case(f"{label} m=300 tries=3 P=8", dt, 300, 3, 8, 128, 96, 10, 3500, overlap=True)
    # rows of no whole 16-byte vectors: 4-, 2- and 1-byte loads
    for dt, label in ((None, "f32"), (torch.bfloat16, "bf16"), (torch.float16, "f16"),
                      ("int8", "int8")):
        case(f"{label} d=33 m=300 tries=3 P=8", dt, 300, 3, 8, 33, 96, 10, 3500, overlap=True)
    # rows holding NaN or infinite coordinates score NaN or +inf: never returned
    rows, q = randn(3 * n_pad, 96), randn(100, 96)
    bad = torch.randperm(3 * n_pad, generator=g)[:300].to(dev)
    rows[bad[:100], 5] = float("nan")
    rows[bad[100:200]] = float("inf")
    rows[bad[200:], 0] = -float("inf")
    base = torch.randint(0, n_pad - 256, (100, 3, 1), generator=g)
    starts = (base + torch.randint(0, 128, (100, 3, 6), generator=g)).to(torch.int32).to(dev)
    for label, r in (("f32", rows), ("bf16", rows.to(torch.bfloat16))):
        check_probe(f"NaN and infinite coordinates {label} m=100 tries=3 P=6 w=128 k=50", r, q,
                    starts, k=50, n=n_pad - 1, n_pad=n_pad, window=128)
        pa, _ = pr.probe_topk(r, q, starts, k=50, n=n_pad - 1, n_pad=n_pad, window=128)
        flat = pa.long() + (torch.arange(3, device=dev) * n_pad)[None, :, None]
        if torch.isin(flat, bad).any():
            raise AssertionError(f"probe {label}: a NaN or infinite row was returned")


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
    moved through ``ANNIndex.from_numpy``) for the given queries
    (:func:`compare_with_cpu`)."""
    cpu_index = ann.ANNIndex.from_numpy(index.to_numpy_dict(), device="cpu")
    c_ids, c_d = ann.search(cpu_index, points.cpu(), queries.cpu())
    return compare_with_cpu("hash search", index, queries, ids, dists, c_ids, c_d)


def tier_gate(smi) -> None:
    """The JAX TPU smoke's exact-kernel gate (``harness/tpu_smoke.py:72-84``)
    on the card: n = 20,000 x 128 float32, m = 1000, k = 10 drawn from
    ``default_rng(0)``, recall@10 against the float64 oracle at each tier's
    floor (:data:`TIER_FLOORS`), for the rank kernel, the rescan merge, the
    stream and ``exact_knn_twophase`` (emit, then the rescan)."""
    n, d, m, k = TIER_GATE_SHAPE
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
    Y = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).cuda()
    true_ids = oracle64(X.double(), Y.double(), k)[0].cpu().numpy()
    calls = {kern: (lambda tier, kw=VARIANTS[kern][0]:
                    ex.exact_knn(X, Y, k, matmul_precision=tier, **kw)) for kern in VARIANTS}
    calls["exact_knn_twophase"] = lambda tier: tp.exact_knn_twophase(X, Y, k,
                                                                     matmul_precision=tier)
    failed = []
    for name, fn in calls.items():
        recs = {tier: recall_at_k(true_ids, fn(tier)[0].cpu().numpy(), k) for tier in TIER_FLOORS}
        failed += [f"{name} {tier} {r}" for tier, r in recs.items() if r < TIER_FLOORS[tier]]
        phase("precision", f"gate n={n} d={d} m={m} k={k} {name}: recall@{k} vs f64 oracle "
                           + ", ".join(f"{t} {r:.5f} (floor {TIER_FLOORS[t]})"
                                       for t, r in recs.items()) + f"; card [{smi}]")
    if failed:
        raise AssertionError(f"tier gate below its floor: {failed}")


def tier_kernels(X, Y, X64, Y64, true_s, seg, smi) -> dict:
    """The four tensor-core kernels at the serving shape (1M x 128 float32,
    m = 1000, k = 10; emit at ``seg``) at "split3" and "default": each
    against its plain version at that tier (ids outside near-ties,
    max_abs_err), recall@10 up to ties against the float64 oracle (split3
    gated at 1.0; emit through ``exact_knn_twophase``), "default"'s ids (emit:
    segment argmins) differing from "highest"'s somewhere (the bf16 path
    ran); CUDA-event ms of every tier in this call, "highest" beside
    :data:`HIGHEST_REFERENCE_MS`; each tier's bound and library yardstick
    (the corpus's bf16 halves made once, as a server would keep them; the
    queries' split in the call).  Returns {kernel: {field: value}} for the
    kernels line."""
    bf16 = torch.bfloat16
    k = 10
    n_seg = -(-N // seg)
    calls = {VARIANTS[kern][2]: (lambda tier, kw=VARIANTS[kern][0]:
                                 ex.exact_knn(X, Y, k, matmul_precision=tier, **kw))
             for kern in VARIANTS}
    calls["twophase_emit"] = lambda tier: tp.segment_minima(X, Y, seg, matmul_precision=tier)
    out = {name: {} for name in TIER_KERNELS}
    for tier in BF16_PASSES:
        for kern in VARIANTS:
            out[VARIANTS[kern][2]][f"max_abs_err_{tier}"] = check_case(
                f"{tier} main shape n={N} m={M} k={k}", X, Y, k, kernel=kern,
                matmul_precision=tier)
        out["twophase_emit"][f"max_abs_err_{tier}"] = check_emit(
            f"{tier} main shape n={N} m={M} seg={seg}", X, Y, seg, matmul_precision=tier)
        for name in TIER_KERNELS:
            if name == "twophase_emit":
                ids = tp.exact_knn_twophase(X, Y, k, matmul_precision=tier)[0]
                moved = not torch.equal(calls[name](tier)[1], calls[name]("highest")[1])
            else:
                ids = calls[name](tier)[0]
                moved = not torch.equal(ids, calls[name]("highest")[0])
            rec, tie = recall_up_to_ties(X64, Y64, ids, true_s, k)
            phase("precision", f"{name} {tier} n={N} m={M} k={k} vs f64 oracle: recall@{k} "
                               f"{rec:.4f} (up to ties {tie:.4f}); ids moved from highest's: "
                               f"{moved}")
            if tier == "split3" and tie != 1.0:
                raise AssertionError(f"{name} split3 recall up to ties {tie}, not 1.0")
            if tier == "default" and not moved:
                raise AssertionError(f"{name} default: ids equal highest's everywhere; "
                                     "the bf16 path did not show")
    # times: every tier of a kernel in turn, then the library's yardsticks
    ms = {name: {tier: cuda_ms(lambda: fn(tier), reps=10) for tier in TIER_FLOORS}
          for name, fn in calls.items()}
    Xb = X.to(bf16)
    Xh, Xl = ex.split_bf16(X)

    def lib_scores(tier):
        pn = (X * X).sum(-1)
        if tier == "default":
            return pn - 2.0 * (Y.to(bf16) @ Xb.T).float()
        Yh, Yl = ex.split_bf16(Y)
        return pn - 2.0 * (((Yh @ Xh.T).float() + (Yh @ Xl.T).float()) + (Yl @ Xh.T).float())

    lib = {tier: (cuda_ms(lambda: torch.topk(lib_scores(tier), k, largest=False), reps=5),
                  cuda_ms(lambda: seg_min_scores(lib_scores(tier), seg), reps=5))
           for tier in BF16_PASSES}
    del Xb, Xh, Xl
    for name in TIER_KERNELS:
        nbytes = 4.0 * (N * 128 + M * 128) + (8.0 * M * n_seg if name == "twophase_emit"
                                              else 8.0 * M * k)
        if name in ("exact_knn_rescan", "exact_knn_stream"):
            nbytes += 4.0 * (N + M)  # pn and |q|^2
        t = ms[name]
        ref = HIGHEST_REFERENCE_MS[name]
        parts = []
        for tier, passes in BF16_PASSES.items():
            # operations bound it: 0.259 ms a pass against 0.153 ms of bytes
            b_ms = 1e3 * max(passes * 2.0 * M * N * 128 / PEAK_BF16, nbytes / PEAK_BYTES)
            lib_ms = lib[tier][1 if name == "twophase_emit" else 0]
            out[name].update({f"ms_{tier}": t[tier], f"bound_ms_{tier}": b_ms,
                              f"library_ms_{tier}": lib_ms})
            parts.append(f"{tier} {t[tier]:.3f} ms ({t[tier] / t['highest']:.3f} x highest, "
                         f"{t[tier] / b_ms:.2f} x bound {b_ms:.3f} ms, library "
                         f"{lib_ms:.3f} ms)")
        phase("precision", f"time {name} n={N} m={M}: highest {t['highest']:.3f} ms "
                           f"({t['highest'] / ref:.3f} x the table's {ref:.3f} ms), "
                           + ", ".join(parts) + f"; card [{smi}]")
    return out


def tier_graph_chunk(X, smi) -> None:
    """One exact-graph chunk (65,536 corpus rows as queries, ``exclude`` =
    own id, k = 10) at each tier beside its bound: what ``build``'s
    ``graph_precision`` buys per chunk."""
    excl = torch.arange(GRAPH_CHUNK, dtype=torch.int32, device=X.device)
    parts = []
    for tier in TIER_FLOORS:
        ms = cuda_ms(lambda: ex.exact_knn(X, X[:GRAPH_CHUNK], 10, exclude=excl,
                                          matmul_precision=tier), reps=1)
        flop = 2.0 * GRAPH_CHUNK * N * 128
        b_ms = 1e3 * (flop / PEAK_FP32 if tier == "highest"
                      else BF16_PASSES[tier] * flop / PEAK_BF16)
        parts.append(f"{tier} {ms:.3f} ms (bound {b_ms:.3f} ms)")
    phase("precision", f"time graph chunk n={N} m={GRAPH_CHUNK} k=10: " + ", ".join(parts)
                       + f"; card [{smi}]")


def tier_graphs(X, k, tries, graph_hi, build_s, smi, read_counts) -> None:
    """``build`` with ``graph_precision`` = split3 and default at 1M: build
    seconds beside the "highest" build's, the share of graph edges also in
    the "highest" graph (the JAX docstring's 0.99999 for split3 is a TPU
    figure, reported, not a floor), and the launches at the tier."""
    for tier in BF16_PASSES:
        ex.reset_launch_counts()
        t0 = time.perf_counter()
        _, graph, _ = ann.build(X, k, tries=tries, seed=0, graph_precision=tier)
        fence()
        secs = time.perf_counter() - t0
        agree = float((graph[:, :, None] == graph_hi[:, None, :]).any(-1).float().mean())
        counts = read_counts(f"build graph_precision={tier}", (f"exact_knn:{tier}",))
        if counts[f"exact_knn:{tier}"] != counts["exact_knn"]:
            raise AssertionError(f"build graph_precision={tier}: a graph chunk ran another tier")
        phase("precision", f"build n={N} d=128 k={k} tries={tries} graph_precision={tier}: "
                           f"{secs:.2f} s (highest {build_s:.2f} s), edges also in the highest "
                           f"graph {agree:.6f}; card [{smi}]")
        del graph


def tier_server(X, k, srv_twophase, serve, results, read_counts, smi) -> None:
    """``Server`` exact at 1M with ``matmul_precision`` per call: auto (the
    engine ``TWOPHASE_MIN_N`` picks) at the three tiers, QPS in one call;
    then split3 and default on the two-phase server (emit) and with the
    rescan merge and the stream pinned.  Each serve's launch counts name
    its tier's kernel (none at "highest"); recall@10 up to ties 1.0 at
    split3 on every path."""
    auto = ann.Server.build(X, k)
    engine = auto.describe()["exact_engine"].removeprefix("cuda-")
    keys = {"rank": "exact_knn", "twophase": "twophase_emit"}
    paths = [("auto", auto, {}, keys[engine], TIER_FLOORS),
             ("twophase_min_n=N", srv_twophase, {}, "twophase_emit", BF16_PASSES),
             ("merge=rescan", srv_twophase, {"merge": "rescan"}, "exact_knn_rescan", BF16_PASSES),
             ("stream", srv_twophase, {"stream": True}, "exact_knn_stream", BF16_PASSES)]
    for name, srv, kw, key, tiers in paths:
        qps = {}
        for tier in tiers:
            ex.reset_launch_counts()
            label = f"exact f32 {name} matmul_precision={tier} (launches {key})"
            serve(label, srv, name="precision", matmul_precision=tier, **kw)
            counts = read_counts(f"Server {name} matmul_precision={tier}",
                                 (key,) if tier == "highest" else (key, f"{key}:{tier}"))
            # tier counters (a design's counter, as "exact_knn:wgmma", is no tier)
            stray = [c for c, v in counts.items() if c.rpartition(":")[2] in BF16_PASSES
                     and v and c != f"{key}:{tier}"]
            if stray:
                raise AssertionError(f"Server {name} matmul_precision={tier} launched {stray}")
            if tier == "split3" and results[label][2] != 1.0:
                raise AssertionError(f"Server {name} split3 recall up to ties is not 1.0")
            qps[tier] = results[label][0]
        phase("precision", f"Server {name} n={N} m={M} k={k} QPS by tier: "
                           + ", ".join(f"{t} {q:.1f}" for t, q in qps.items())
                           + f"; card [{smi}]")


def bench_phase(dev, smi, read_counts) -> dict:
    """``python3 bench_torch.py`` in a fresh process, so that its cold build
    is cold in its own process and its one-line contract is what is read;
    it writes the ids it scored and its hash index to a temporary directory
    (``bench_torch.KEEP_ENV``).  Gates: every key of ``bench.py``'s line;
    ``device`` the card's name and power limit; the exact ids at 20k and at
    1M ("highest" and split3) 1.0 up to ties against the float64 oracle (the
    1M corpus drawn again here from the bench's generator, its float32
    recall equal to the line's); the 20k hash search equal to the same
    index's search on the CPU; ``Server`` auto on the rank kernel; the rank
    kernel at the bench's shape against its plain version.  Returns the
    bench's launch counts (its own process's, the main path of the run)
    and the rank kernel's row at the bench's shape."""
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as keep_dir:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(root / "bench_torch.py")], cwd=root,
                              env={**os.environ, bench_torch.KEEP_ENV: keep_dir},
                              capture_output=True, text=True, timeout=BENCH_TIMEOUT)
        bench_s = time.perf_counter() - t0
        for line in proc.stderr.splitlines():
            phase("bench", f"bench_torch.py stderr: {line}")
        if proc.returncode != 0:
            raise AssertionError(f"bench_torch.py exited {proc.returncode}")
        out = proc.stdout.strip().splitlines()
        if len(out) != 1:
            raise AssertionError(f"bench_torch.py printed {len(out)} lines on stdout, not one")
        result = json.loads(out[0])
        with np.load(Path(keep_dir) / "ids.npz") as z:
            kept = {key: torch.from_numpy(z[key]).to(dev) for key in z.files}
        index = ann.ANNIndex.load(str(Path(keep_dir) / "index.npz"), device=dev)
    launches = [json.loads(line[len(BENCH_LAUNCHES):]) for line in proc.stderr.splitlines()
                if line.startswith(BENCH_LAUNCHES)]
    if not launches:
        raise AssertionError("bench_torch.py printed no launch counts on stderr")
    missing = [key for key in bench_torch.KEYS if key not in result]
    if missing:
        raise AssertionError(f"bench_torch.py's line lacks bench.py's keys {missing}")
    if result["device"] != smi:
        raise AssertionError(f"bench_torch.py's device {result['device']!r} is not {smi!r}")
    phase("bench", f"python3 bench_torch.py: exit 0 in {bench_s:.2f} s; line: " + ", ".join(
        f"{key} {result[key]}" for key in bench_torch.KEYS if key != "config"))
    counts = read_counts("bench (bench_torch.py, its own process)",
                         ("exact_knn", "exact_knn:split3"), launches[-1])

    cfg = bench_torch.CONFIG
    n, d, k, m = cfg["n"], cfg["d"], cfg["k"], cfg["ycnt"]
    Xn, Yn = bench_torch.bench_data()
    X, Y = torch.from_numpy(Xn).to(dev), torch.from_numpy(Yn).to(dev)
    X64, Y64 = X.double(), Y.double()
    true20 = oracle64(X64, Y64, k)
    rec, tie = recall_up_to_ties(X64, Y64, kept["exact_ids"], true20, k)
    if tie != 1.0:
        raise AssertionError(f"bench exact ids at {n}: recall up to ties {tie}, not 1.0")
    h_rec, h_tie = recall_up_to_ties(X64, Y64, kept["hash_ids"], true20, k)
    sub = slice(0, CPU_CHECK_QUERIES)
    n_cmp, n_tied = check_search_on_cpu(index, X, Y[sub], kept["hash_ids"][sub],
                                        kept["hash_dists"][sub])
    desc = ann.Server.build(X, k, mode="auto").describe()
    if desc["mode"] != "exact" or desc["exact_engine"] != "cuda-rank":
        raise AssertionError(f"Server auto at the bench's config is not the rank kernel: {desc}")
    phase("bench", f"n={n} d={d} m={m} k={k}: exact ids vs f64 oracle recall@10 {rec:.4f} "
                   f"(up to ties {tie:.4f}); hash ids {h_rec:.4f} (up to ties {h_tie:.4f}); "
                   f"card vs CPU hash search on {CPU_CHECK_QUERIES} queries: {n_cmp} rows "
                   f"compared, ids equal outside near-ties ({n_tied} near-tie rows); "
                   f"Server auto: {desc['exact_engine']}")
    del X64, Y64, index

    X1, Y1 = bench_torch.data_1m(d, m, dev)
    tq1 = brute_force_knn(X1, Y1, k)[0]
    if round(recall_at_k(tq1.cpu().numpy(), kept["exact_1m_ids"].cpu().numpy(), k), 4) \
            != result["exact_1m_recall_at_10"]:
        raise AssertionError("the 1M corpus drawn here is not the bench's: its float32 "
                             "recall differs from the line's")
    X164, Y164 = X1.double(), Y1.double()
    true1 = oracle64(X164, Y164, k)
    ties = {}
    for key in ("exact_1m", "exact_1m_split3", "exact_1m_bf16"):
        ties[key] = recall_up_to_ties(X164, Y164, kept[f"{key}_ids"], true1, k)[1]
        if key != "exact_1m_bf16" and ties[key] != 1.0:
            raise AssertionError(f"bench {key} ids: recall up to ties {ties[key]}, not 1.0")
    phase("bench", f"1M x {d} m={m} k={k} ids vs f64 oracle, recall@10 up to ties: " + ", ".join(
        f"{key} {v:.4f}" for key, v in ties.items()))
    del X1, Y1, X164, Y164, tq1, true1

    # the rank kernel at the bench's shape: what exact_search launches there
    err = check_case(f"bench shape n={n} d={d} m={m} k={k}", X, Y, k)
    ms = cuda_ms(lambda: ex.exact_knn(X, Y, k), reps=200)
    plain_ms = cuda_ms(lambda: ex.exact_knn_plain(X, Y, k), reps=20)
    lib_ms = cuda_ms(lambda: torch.topk((X * X).sum(-1) - 2.0 * (Y @ X.T), k, largest=False),
                     reps=200)
    b = bound(2.0 * m * n * d, 4.0 * (n * d + m * d) + 8.0 * m * k)
    call_ms = 1e3 * m / result["exact_qps"]
    phase("kernel", f"time rank bench shape n={n} d={d} m={m} k={k}: kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, library topk {lib_ms:.4f} ms, bound {b[0]:.4f} "
                    f"ms ({b[1]}); exact_search's pipelined call in the bench {call_ms:.4f} ms")
    return {"launches": counts,
            "rows": {"exact_knn": at_scale_row(f"{n} x {d} f32, m={m}, k={k} (bench_torch.py)",
                                               ms, plain_ms, b, lib_ms, err,
                                               call_ms=call_ms)}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel-only", action="store_true",
                    help="stop after the kernel-vs-plain phase")
    ap.add_argument("--deep10m-only", action="store_true",
                    help="build the kernels, then run the deep10m phase alone")
    ap.add_argument("--bench-only", action="store_true",
                    help="build the kernels, then run the bench phase alone")
    ap.add_argument("--deep10m-graph-precision", default=DEEP_GRAPH_PRECISION,
                    choices=tuple(TIER_FLOORS),
                    help="the 10M exact graph's tier (default: %(default)s)")
    # one rank of the sharded phase's two-rank run (dryrun.launch appends these)
    for flag in ("--rank", "--world"):
        ap.add_argument(flag, type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt", help=argparse.SUPPRESS)  # the two ranks' checkpoint directory
    args = ap.parse_args()
    if args.rank is not None:
        sharded_rank(args)
        return

    # -- phase 0: environment -------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke needs a CUDA card")
    smi = card_name_and_limit()
    if smi is None:
        raise SystemExit("chip_smoke: nvidia-smi did not give the card's name and power limit")
    card = torch.cuda.get_device_name(0)
    phase("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
                 f"cuda {torch.version.cuda} device {card} count "
                 f"{torch.cuda.device_count()} card [{smi}]")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- phase 1: build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = ex.build_libraries(verbose=True)
    for name in libs:
        ex._library(name)
    phase("build", f"nvcc sm_90a -> {', '.join(p.name for p in libs.values())} "
                   f"in {time.perf_counter() - t0:.2f} s")

    total = dict.fromkeys(ex.launches, 0)

    def read_counts(path: str, need: tuple, counts: dict | None = None) -> dict:
        counts = dict(ex.launches) if counts is None else counts
        for name in need:
            if counts[name] < 1:
                raise AssertionError(f"{path}: kernel {name} was not launched")
        for name, c in counts.items():
            total[name] += c
        phase("counts", f"{path}: " + ", ".join(f"{a} {b}" for a, b in counts.items()))
        return counts

    if args.deep10m_only:
        Y128 = torch.from_numpy(np.random.default_rng(args.seed).standard_normal(
            (M, 128), dtype=np.float32)).to(dev)
        at_scale = deep10m(args.seed, dev, smi, read_counts, Y128, None,
                           args.deep10m_graph_precision)
        print(json.dumps({"at_scale": at_scale, "launches": total}))
        phase("done", "deep10m-only run: the earlier paths not driven, no result line")
        return

    # -- phase 1b: the headline bench, bench_torch.py in its own process ------------
    bench = bench_phase(dev, smi, read_counts)
    if args.bench_only:
        phase("done", "bench-only run: the other paths not driven, no result line")
        return

    # -- phase 2: kernels against plain versions ----------------------------------
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
    # numpy inputs with no device go to the card, as tensors there do
    for name, fn in (("exact_search", ann.exact_search),
                     ("exact_knn_twophase", ann.exact_knn_twophase)):
        a_ids, a_d = fn(x20.cpu().numpy(), q1k.cpu().numpy(), 10)
        b_ids, b_d = fn(x20, q1k, 10)
        if a_ids.device != dev or not (torch.equal(a_ids, b_ids) and torch.equal(a_d, b_d)):
            raise AssertionError(f"{name} on numpy inputs differs from the card tensors")
        phase("kernel", f"{name} on numpy inputs: ran on {a_ids.device}, same result as "
                        "on card tensors")

    # the main path's serving shape: n x 128 f32, 1000 queries, k = 10
    rng = np.random.default_rng(args.seed)
    X = torch.from_numpy(rng.standard_normal((N, 128), dtype=np.float32)).to(dev)
    Y = torch.from_numpy(rng.standard_normal((M, 128), dtype=np.float32)).to(dev)
    errs = {"exact_knn": check_case(f"main shape n={N} m={M} k=10", X, Y, 10)}
    chunk_excl = torch.arange(GRAPH_CHUNK, dtype=torch.int32, device=dev)
    check_case(f"graph chunk n={N} m={GRAPH_CHUNK} exclude=self k=10", X,
               X[:GRAPH_CHUNK], 10, exclude=chunk_excl)
    chunk_ms = cuda_ms(lambda: ex.exact_knn(X, X[:GRAPH_CHUNK], 10, exclude=chunk_excl),
                       reps=1, warmup=0)
    chunk_bound, chunk_by = bound(2.0 * GRAPH_CHUNK * N * 128,
                                  4.0 * (N * 128 + GRAPH_CHUNK * 129) + 8.0 * GRAPH_CHUNK * 10)
    chunk_b3 = 1e3 * 3 * 2.0 * GRAPH_CHUNK * N * 128 / PEAK_TF32
    phase("kernel", f"time graph chunk n={N} m={GRAPH_CHUNK} k=10: kernel {chunk_ms:.3f} ms, "
                    f"bound {chunk_bound:.3f} ms ({chunk_by}), 3xTF32 {chunk_b3:.3f} ms (three "
                    f"TF32 passes at the tensor cores' dense peak)")
    Xb = X.to(torch.bfloat16)
    check_case(f"bf16 main shape n={N} m={M} k=10", Xb, Y, 10, rtol=1e-3)
    kern_ms = cuda_ms(lambda: ex.exact_knn(X, Y, 10), reps=10)
    plain_ms = cuda_ms(lambda: ex.exact_knn_plain(X, Y, 10), reps=2)
    kern_bf16_ms = cuda_ms(lambda: ex.exact_knn(Xb, Y, 10), reps=10)
    plain_bf16_ms = cuda_ms(lambda: ex.exact_knn_plain(Xb, Y, 10), reps=2)
    lib_ms = cuda_ms(lambda: torch.topk((X * X).sum(-1) - 2.0 * (Y @ X.T), 10,
                                        largest=False), reps=5)
    phase("kernel", f"time n={N} m={M} k=10: f32 kernel {kern_ms:.3f} ms "
                    f"plain {plain_ms:.3f} ms library topk {lib_ms:.3f} ms; bf16 "
                    f"kernel {kern_bf16_ms:.3f} ms plain {plain_bf16_ms:.3f} ms")
    rank_designs(X, Y, chunk_excl, kern_ms, chunk_ms, smi)

    # two-phase kernels: the serving shape first (seg = auto_seg(1M) = 128)
    seg = tp.auto_seg(N)
    k, P = 10, 10 + 2
    errs["twophase_emit"] = check_emit(f"main shape n={N} m={M} seg={seg}", X, Y, seg)
    starts = window_starts(X, Y, P, seg)
    errs["twophase_rescan"] = check_rescan(f"main shape n={N} m={M} k={k} P={P} seg={seg}",
                                           X, Y, starts, seg, k)
    check_emit(f"exclude=self n={N} m={M}", X, X[:M], seg,
               exclude=torch.arange(M, dtype=torch.int32, device=dev))
    check_emit(f"bf16 main shape n={N}", Xb, Y, seg)
    check_rescan(f"bf16 main shape n={N} k={k}", Xb, kernel_queries(Xb, Y, None),
                 window_starts(Xb, Y, P, seg), seg, k)
    for kk in (64, 126):
        check_rescan(f"n={N} m={M} k={kk} P={kk + 2}", X, Y,
                     window_starts(X, Y, kk + 2, seg), seg, kk)
    y100 = Y[:100].contiguous()
    for kk in (256, 1000):
        check_rescan(f"emit-all n={N} m=100 k={kk} P={kk + 2}", X, y100,
                     window_starts(X, y100, kk + 2, seg), seg, None)
    check_rescan(f"m=1 n={N} k={k}", X, Y[:1].contiguous(), starts[:1].contiguous(),
                 seg, k)
    check_emit(f"m=1 n={N}", X, Y[:1].contiguous(), seg)
    q96 = randn(1000, 96)
    x96b = randn(20_011, 96)
    for sg in (tp.auto_seg(20_011), 512):
        check_emit(f"n=20011 d=96 seg={sg}", x96b, q96, sg)
        check_rescan(f"n=20011 d=96 seg={sg} k={k}", x96b, q96,
                     window_starts(x96b, q96, P, sg), sg, k)
    check_emit("n=20011 d=96 seg=512 exclude", x96b, x96b[:1000].contiguous(), 512,
               exclude=torch.arange(1000, dtype=torch.int32, device=dev))
    for label, pts, sc in (("bf16", x20.to(torch.bfloat16), None),
                           ("f16", x20.to(torch.float16), None),
                           ("int8", x8, float(s8))):
        check_emit(f"{label} n=20000 seg=32", pts, q1k, 32, scale=sc)
        check_rescan(f"{label} n=20000 seg=32 k={k}", pts, kernel_queries(pts, q1k, sc),
                     window_starts(pts, q1k, P, 32, scale=sc), 32, k)
    # more windows than segments: the picks run out and their windows read nothing
    check_rescan("exhausted n=100 seg=32 k=10 P=12", small, q1k[:50],
                 window_starts(small, q1k[:50], P, 32), 32, k)
    check_rescan("exhausted emit-all n=100 seg=32 P=12", small, q1k[:50],
                 window_starts(small, q1k[:50], P, 32), 32, None)
    rescan_gather_checks(randn, dev)

    synthetic_probe_checks(randn, dev)

    # the rescan-merge and streaming kernels: the rank kernel's degenerate set
    x33, q33 = randn(20_011, 33), randn(999, 33)
    bf16 = torch.bfloat16
    check_case("compute_dtype=bf16 on f32 n=20000", x20, q1k, 10, compute_dtype=bf16, rtol=1e-3)
    for kern in ("rescan", "stream"):
        check_case("n=20000 d=128 m=1000 k=10 f32", x20, q1k, 10, kernel=kern)
        check_case("k=1", x20, q1k, 1, kernel=kern)
        check_case("k=128", x20, q1k, 128, kernel=kern)
        check_case("n=20011 exclude=self k=10", x20b, x20b[:1000].contiguous(), 10,
                   exclude=self_ids, kernel=kern)
        check_case("d=33 n=20011 m=999", x33, q33, 10, kernel=kern)
        if kern == "stream":  # 64- and 16-row ring slots
            for dd in (256, 768):
                check_case(f"d={dd} n=20011 m=999", randn(20_011, dd), randn(999, dd), 10,
                           kernel=kern)
        check_case("d=96", x96, q96, 10, kernel=kern)
        check_case("bf16 stored", x20.to(bf16), q1k, 10, rtol=1e-3, kernel=kern)
        check_case("f16 stored", x20.to(torch.float16), q1k, 10, rtol=1e-3, kernel=kern)
        check_case("int8 scale", x8, q1k, 10, scale=float(s8), kernel=kern)
        check_case("m=1", x20, q1k[:1].contiguous(), 10, kernel=kern)
        check_case("m=37", x20, q1k[:37].contiguous(), 10, kernel=kern)
        check_case("k=128 > n=100", small, q1k[:50].contiguous(), 128, kernel=kern)
        check_case("k=100 = n-1 exclude=self", x101, x101, 100,
                   exclude=torch.arange(101, dtype=torch.int32, device=dev), kernel=kern)
        check_case("compute_dtype=bf16 on f32 n=20000", x20, q1k, 10, compute_dtype=bf16,
                   rtol=1e-3, kernel=kern)
        errs[VARIANTS[kern][2]] = check_case(f"main shape n={N} m={M} k=10", X, Y, 10,
                                             kernel=kern)
    # rank and rescan merge at any d: one feature chunk up to d = 128 in
    # f32, several past it
    for dd in (33, 256, 960, 2048):
        xd, qd = randn(20_011, dd), randn(37, dd)
        ed = torch.arange(37, dtype=torch.int32, device=dev)
        xd8, sd8 = ex.quantize_corpus(xd)
        for kern in ("rank", "rescan"):
            check_case(f"d={dd} n=20011 m=37 k=128", xd, qd, 128, kernel=kern)
            check_case(f"d={dd} n=20011 m=37 k=1 exclude", xd, qd, 1, exclude=ed, kernel=kern)
            check_case(f"d={dd} n=20011 m=1 k=10 exclude", xd, qd[:1].contiguous(), 10,
                       exclude=ed[:1], kernel=kern)
            for label, pts, sc, rtol in (("bf16", xd.to(bf16), None, 1e-3),
                                         ("f16", xd.to(torch.float16), None, 1e-3),
                                         ("int8", xd8, float(sd8), 1e-5)):
                check_case(f"{label} d={dd} n=20011 m=37 k=128 exclude", pts, qd, 128,
                           exclude=ed, scale=sc, rtol=rtol, kernel=kern)
        # emit at any d; segments of 8 (lane groups), 256 and 1,024 rows
        # (several tiles; n = 20,011 is a multiple of none, so splits must
        # take whole segments)
        for sg in (8, 256, 1024):
            check_emit(f"d={dd} n=20011 m=37 seg={sg} exclude", xd, qd, sg, exclude=ed)
            check_emit(f"d={dd} n=20011 m=1 seg={sg}", xd, qd[:1].contiguous(), sg)
        for label, pts, sc in (("bf16", xd.to(bf16), None), ("f16", xd.to(torch.float16), None),
                               ("int8", xd8, float(sd8))):
            check_emit(f"{label} d={dd} n=20011 m=37 seg=256 exclude", pts, qd, 256,
                       exclude=ed, scale=sc)
    check_tile_layout(dev)
    # the tensor-core kernels' dot products are three TF32 passes, not the
    # plain versions' IEEE fp32: hold them to the float64 oracle directly
    X64, Y64 = X.double(), Y.double()
    true_s = oracle64(X64, Y64, 10)
    for kern in VARIANTS:
        for label, pts in (("f32", X), ("bf16 stored", Xb)):
            s_ids, _ = ex.exact_knn(pts, Y, 10, **VARIANTS[kern][0])
            rec, tie = recall_up_to_ties(X64, Y64, s_ids, true_s, 10)
            phase("kernel", f"{kern} {label} n={N} m={M} k=10 vs f64 oracle: recall@10 "
                            f"{rec:.4f} (up to ties {tie:.4f})")
            if label == "f32" and tie != 1.0:
                raise AssertionError(f"{kern} f32 recall up to ties {tie}, not 1.0")
    rescan_ms = cuda_ms(lambda: ex.exact_knn(X, Y, 10, merge="rescan"), reps=10)
    rescan_plain_ms = cuda_ms(lambda: ex.exact_knn_rescan_plain(X, Y, 10), reps=2)
    stream_ms = cuda_ms(lambda: ex.exact_knn(X, Y, 10, stream=True), reps=10)
    stream_plain_ms = cuda_ms(lambda: ex.exact_knn_stream_plain(X, Y, 10), reps=2)
    phase("kernel", f"time n={N} m={M} k=10: rescan merge {rescan_ms:.3f} ms plain "
                    f"{rescan_plain_ms:.3f} ms; stream {stream_ms:.3f} ms plain "
                    f"{stream_plain_ms:.3f} ms")
    # half-width streams: a stored bf16 corpus, and bf16 compute on the f32
    # corpus (which adds the per-call conversion)
    half_ms = {label: cuda_ms(fn, reps=5) for label, fn in (
        ("rank compute_dtype=bf16", lambda: ex.exact_knn(X, Y, 10, compute_dtype=bf16)),
        ("rescan merge bf16 stored", lambda: ex.exact_knn(Xb, Y, 10, merge="rescan")),
        ("rescan merge compute_dtype=bf16",
         lambda: ex.exact_knn(X, Y, 10, merge="rescan", compute_dtype=bf16)),
        ("stream bf16 stored", lambda: ex.exact_knn(Xb, Y, 10, stream=True)),
        ("stream compute_dtype=bf16",
         lambda: ex.exact_knn(X, Y, 10, stream=True, compute_dtype=bf16)),
        ("bf16 conversion alone", lambda: ex.compute_corpus(X, bf16)))}
    phase("kernel", f"time n={N} m={M} k=10 half width: "
                    + ", ".join(f"{label} {t:.3f} ms" for label, t in half_ms.items()))

    lib_bf16_ms = cuda_ms(lambda: torch.topk((Xb.float() ** 2).sum(-1)
                                             - 2.0 * (Y.to(bf16) @ Xb.T).float(), 10,
                                             largest=False), reps=5)
    norms_ms = cuda_ms(lambda: ex.point_norms(X), reps=5)

    emit_ms = cuda_ms(lambda: tp.segment_minima(X, Y, seg), reps=10)
    emit_plain_ms = cuda_ms(lambda: tp.segment_minima_plain(X, Y, seg), reps=2)
    emit_bf16_ms = cuda_ms(lambda: tp.segment_minima(Xb, Y, seg), reps=10)
    n_seg = -(-N // seg)

    lib_emit_ms = cuda_ms(lambda: seg_min_scores((X * X).sum(-1) - 2.0 * (Y @ X.T), seg),
                          reps=5)
    lib_emit_bf16_ms = cuda_ms(lambda: seg_min_scores((Xb.float() ** 2).sum(-1)
                                                      - 2.0 * (Y.to(bf16) @ Xb.T).float(), seg),
                               reps=5)
    tp_rescan_ms = cuda_ms(lambda: tp.rescan_windows(X, Y, starts, seg, k), reps=20)
    tp_rescan_plain_ms = cuda_ms(lambda: tp.rescan_windows_plain(X, Y, starts, seg, k), reps=3)
    phase("kernel", f"time n={N} m={M} k={k} seg={seg}: emit {emit_ms:.3f} ms plain "
                    f"{emit_plain_ms:.3f} ms; rescan {tp_rescan_ms:.3f} ms plain "
                    f"{tp_rescan_plain_ms:.3f} ms")
    pairs, distinct = rescan_rows(starts, N, seg)
    phase("kernel", f"rescan windows n={N} m={M} P={P} seg={seg}: {pairs} (query, row) "
                    f"pairs over {distinct} distinct rows; effective L2 read rate (pairs x "
                    f"row bytes / kernel time) {pairs * 512 / tp_rescan_ms / 1e9:.3f} TB/s")
    # the rescan at the updates' emit-all shape: P = ADD_K + 2 windows, in
    # exact_knn_twophase's query blocks of (32 << 20) // (P * seg) queries
    p_all = ADD_K + 2
    m_all = (32 << 20) // (p_all * seg)
    q_all = Y[:m_all].contiguous()
    starts_all = window_starts(X, q_all, p_all, seg)
    errs["twophase_rescan_all"] = check_rescan(
        f"emit-all updates' shape n={N} m={m_all} P={p_all} seg={seg}", X, q_all, starts_all,
        seg, None)
    all_ms = cuda_ms(lambda: tp.rescan_windows(X, q_all, starts_all, seg, None), reps=10)
    all_plain_ms = cuda_ms(lambda: tp.rescan_windows_plain(X, q_all, starts_all, seg, None),
                           reps=1)
    pairs_all, distinct_all = rescan_rows(starts_all, N, seg)
    phase("kernel", f"time rescan emit-all n={N} m={m_all} P={p_all} seg={seg}: kernel "
                    f"{all_ms:.3f} ms plain {all_plain_ms:.3f} ms; {pairs_all} (query, row) "
                    f"pairs over {distinct_all} distinct rows, {pairs_all * 512 / 1e9:.3f} GB "
                    f"of row reads ({1e3 * pairs_all * 512 / PEAK_BYTES:.3f} ms at the HBM "
                    f"peak, where no row is read from L2) and {m_all * p_all * seg * 8 / 1e9:.3f} "
                    f"GB written; effective read rate {pairs_all * 512 / all_ms / 1e9:.3f} TB/s")
    # the row scorer's lane groups and the rescan's split count, against
    # the defaults (ops/exact.py:gather_geometry, ops/twophase.py:rescan_splits)
    gather_sweep(f"rescan f32 n={N} m={M} k={k}",
                 lambda geom, _: tp.rescan_windows(X, Y, starts, seg, k, geometry=geom), 128, 4)
    starts_b = window_starts(Xb, Y, P, seg)
    gather_sweep(f"rescan bf16 n={N} m={M} k={k}",
                 lambda geom, _: tp.rescan_windows(Xb, Y, starts_b, seg, k, geometry=geom),
                 128, 2)
    X8s, s8s = ex.quantize_corpus(X)
    starts_8 = window_starts(X8s, Y, P, seg, scale=float(s8s))
    q8 = kernel_queries(X8s, Y, float(s8s))
    gather_sweep(f"rescan int8 n={N} m={M} k={k}",
                 lambda geom, _: tp.rescan_windows(X8s, q8, starts_8, seg, k, geometry=geom),
                 128, 1)
    del X8s
    gather_sweep(f"rescan emit-all f32 n={N} m={m_all} P={p_all}",
                 lambda geom, _: tp.rescan_windows(X, q_all, starts_all, seg, None,
                                                   geometry=geom), 128, 4, reps=5)
    split_ms = {s: cuda_ms(lambda: tp.rescan_windows(X, q_all, starts_all, seg, None,
                                                     n_splits=s), reps=3)
                for s in (1, 2, 4, 8, 16, 24, 32)}
    per_sm = ex._library("twophase_knn").twophase_rescan_blocks_per_sm(
        0, ex.gather_geometry(128, 4)[0])
    rule = tp.rescan_splits(m_all, p_all, torch.cuda.get_device_properties(dev)
                            .multi_processor_count, per_sm)
    phase("kernel", f"rescan emit-all splits (rule: {rule}, {per_sm} resident blocks an SM): "
                    + ", ".join(f"{s_} {t:.3f} ms" for s_, t in split_ms.items()))
    bounds = {
        "exact_knn": bound(2.0 * M * N * 128, 4.0 * (N * 128 + M * 128) + 8.0 * M * k),
        "twophase_emit": bound(2.0 * M * N * 128,
                               4.0 * (N * 128 + M * 128) + 8.0 * M * n_seg),
        "twophase_rescan": bound(3.0 * pairs * 128,
                                 4.0 * (distinct * 128 + M * 128 + M * P) + 8.0 * M * k),
        "twophase_rescan_all": bound(3.0 * pairs_all * 128,
                                     4.0 * (distinct_all * 128 + m_all * 128 + m_all * p_all)
                                     + 8.0 * m_all * p_all * seg),
    }
    # the rescan merge and the stream also read pn (n,) and |q|^2 (m,)
    for name in ("exact_knn_rescan", "exact_knn_stream"):
        bounds[name] = bound(2.0 * M * N * 128,
                             4.0 * (N * 129 + M * 129) + 8.0 * M * k)
    # each kernel's f32 time against the library call, the bound and its
    # own arithmetic (three TF32 passes on the tensor cores); its bf16
    # stored time against the library call with a bf16 matmul and the bf16
    # bound; every time includes the call's |q|^2 (and pn but in the rank kernel)
    b3 = 1e3 * 3 * 2.0 * M * N * 128 / PEAK_TF32
    qbs = {"rank": ex.tile_geometry("exact_knn")[0],
           "rescan": ex.tile_geometry("rescan_merge_knn")[0],
           "stream": ex.stream_query_block(),
           "emit": ex.tile_geometry("twophase_knn")[0]}
    keys = {kern: VARIANTS[kern][2] for kern in VARIANTS}
    keys["emit"] = "twophase_emit"
    for kern, f32_ms, bf_ms, lib32, lib16 in (
            ("rank", kern_ms, kern_bf16_ms, lib_ms, lib_bf16_ms),
            ("rescan", rescan_ms, half_ms["rescan merge bf16 stored"], lib_ms, lib_bf16_ms),
            ("stream", stream_ms, half_ms["stream bf16 stored"], lib_ms, lib_bf16_ms),
            ("emit", emit_ms, emit_bf16_ms, lib_emit_ms, lib_emit_bf16_ms)):
        b32 = bounds[keys[kern]][0]
        pn_bytes = 4.0 * (N + M) if kern in ("rescan", "stream") else 0.0
        out_bytes = 8.0 * M * n_seg if kern == "emit" else 8.0 * M * 10
        b16 = 1e3 * max(2.0 * M * N * 128 / PEAK_BF16,
                        (2.0 * N * 128 + 4.0 * M * 128 + pn_bytes + out_bytes) / PEAK_BYTES)
        what = f"seg={seg}" if kern == "emit" else "k=10"
        lib_name = "library segment min" if kern == "emit" else "library topk"
        phase("kernel", f"{kern} n={N} m={M} {what}: f32 {f32_ms:.3f} ms = "
                        f"{f32_ms / lib32:.3f} x {lib_name} {lib32:.3f} ms = "
                        f"{f32_ms / b32:.2f} x bound {b32:.3f} ms (the function's fp32 "
                        f"operations at the CUDA cores' peak, where the kernel does not run "
                        f"them) = {f32_ms / b3:.2f} x 3xTF32 {b3:.3f} ms (its three TF32 passes "
                        f"at the tensor cores' dense TF32 peak); bf16 stored {bf_ms:.3f} ms = "
                        f"{bf_ms / lib16:.3f} x {lib_name} (bf16 matmul) "
                        f"{lib16:.3f} ms = {bf_ms / b16:.2f} x bound {b16:.3f} ms (bf16 "
                        f"tensor-core operations)")
        blocks = -(-M // qbs[kern])
        # the bf16 emit reads the corpus once per Hopper emit unit of queries
        blocks16 = (-(-M // tp.WG_QUERIES)
                    if kern == "emit" and tp.emit_design(torch.bfloat16, 128, seg) == "wgmma"
                    else blocks)
        phase("kernel", f"{kern} effective L2 read rate (query blocks x corpus bytes / kernel "
                        f"time): f32 {blocks} blocks {blocks * 4.0 * N * 128 / f32_ms / 1e9:.3f} "
                        f"TB/s, bf16 stored {blocks16} blocks "
                        f"{blocks16 * 2.0 * N * 128 / bf_ms / 1e9:.3f} TB/s")
    phase("kernel", f"point norms alone (in every rescan-merge and stream time): "
                    f"{norms_ms:.3f} ms")
    timing = {"exact_knn": (kern_ms, plain_ms, lib_ms),
              "twophase_emit": (emit_ms, emit_plain_ms, lib_emit_ms),
              "twophase_rescan": (tp_rescan_ms, tp_rescan_plain_ms, None),
              "twophase_rescan_all": (all_ms, all_plain_ms, None),
              "exact_knn_rescan": (rescan_ms, rescan_plain_ms, lib_ms),
              "exact_knn_stream": (stream_ms, stream_plain_ms, lib_ms)}
    for name, (b_ms, b_by) in bounds.items():
        phase("kernel", f"bound {name}: {b_ms:.3f} ms ({b_by}); measured "
                        f"{timing[name][0]:.3f} ms")
    # the precision tiers of the four tensor-core kernels
    tier_gate(smi)
    tiers = tier_kernels(X, Y, X64, Y64, true_s, seg, smi)
    tier_graph_chunk(X, smi)
    if args.kernel_only:
        phase("done", "kernel-only run: main path not driven, no result line")
        return

    # -- phase 3: main path ---------------------------------------------------------
    true_big = oracle64(X64, Y64[:100], 256)
    fence()

    # path 1: build (exact graph through the rank kernel) -> hash search
    tries = 10
    ex.reset_launch_counts()
    t0 = time.perf_counter()
    index, graph, gd = ann.build(X, k, tries=tries, seed=0)
    fence()
    build_s = time.perf_counter() - t0
    build_launches = ex.launches["exact_knn"]
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
    read_counts("build -> search", ("exact_knn",))
    tier_graphs(X, k, tries, graph, build_s, smi, read_counts)

    # the sharded layer on one NCCL rank, held to the single-card calls
    multihost.initialize()
    mesh = sh.make_mesh()
    sharded_exact(mesh, index, X, Y, X64, Y64, true_s, smi, read_counts)
    del index, graph, gd
    sharded_server_exact(mesh, X, Y, true_s, smi, read_counts)

    # path 2: the two-phase engine through its entry points
    ex.reset_launch_counts()
    for label, kk, qq, truth in (("exact_knn_twophase", 10, Y, true_s),
                                 ("exact_knn_twophase", 64, Y[:100], true_big),
                                 ("exact_search", 256, Y[:100], true_big)):
        fn = tp.exact_knn_twophase if label == "exact_knn_twophase" else ann.exact_search
        pids, pd = fn(X, qq.contiguous(), kk)
        fence()
        if pids.shape != (qq.shape[0], kk) or not torch.isfinite(pd).all():
            raise AssertionError(f"{label} k={kk} returned a bad result")
        tie = _tie_recall(X64, Y64[: qq.shape[0]], pids, truth[1], kk)
        if tie != 1.0:
            raise AssertionError(f"{label} k={kk}: recall up to ties {tie}, not 1.0")
        phase("path", f"{label} n={N} m={qq.shape[0]} k={kk}: recall@{kk} up to "
                      f"ties vs f64 oracle {tie:.4f}")
    results = {}

    def serve(label, srv, name="server", **kw):
        sids, sd = srv.search(Y, **kw)  # warm-up
        fence()
        reps = 20
        t0 = time.perf_counter()
        outs = [srv.search(Y, **kw) for _ in range(reps)]
        fence()
        qps = M * reps / (time.perf_counter() - t0)
        sids, sd = outs[-1]
        if sids.shape != (M, k) or not torch.isfinite(sd).all():
            raise AssertionError("Server.search returned a bad result")
        rec, tie_rec = recall_up_to_ties(X64, Y64, sids, true_s, k)
        results[label] = (qps, rec, tie_rec)
        phase(name, f"Server {label} n={N} m={M}: pipelined "
                    f"{qps:.1f} QPS, recall@10 {rec:.4f} (up to ties {tie_rec:.4f})")
        return sids

    # servers whose threshold puts this corpus on the two-phase engine
    servers = {}
    for label, sdt in (("f32", None), ("bf16", torch.bfloat16)):
        srv = ann.Server.build(X, k, storage_dtype=sdt, twophase_min_n=N)
        desc = srv.describe()
        if desc["mode"] != "exact" or desc["exact_engine"] != "cuda-twophase":
            raise AssertionError(f"Server did not resolve to the two-phase engine: {desc}")
        serve(f"exact {label} twophase_min_n={N} (cuda-twophase)", srv)
        servers[label] = srv
    if results[f"exact f32 twophase_min_n={N} (cuda-twophase)"][2] != 1.0:
        raise AssertionError("f32 two-phase recall up to ties is not 1.0")
    read_counts("two-phase engine", ("twophase_emit", "twophase_rescan", "twophase_rescan_all"))

    # Server auto: the engine TWOPHASE_MIN_N (from the crossover) gives at N
    ex.reset_launch_counts()
    auto = ann.Server.build(X, k)
    want = "twophase" if N >= tp.TWOPHASE_MIN_N else "rank"
    desc = auto.describe()
    if desc["mode"] != "exact" or desc["exact_engine"] != f"cuda-{want}":
        raise AssertionError(f"Server auto did not resolve to cuda-{want}: {desc}")
    serve(f"exact f32 auto TWOPHASE_MIN_N={tp.TWOPHASE_MIN_N} (cuda-{want})", auto)
    del auto
    read_counts("Server auto", ("twophase_emit", "twophase_rescan") if want == "twophase"
                else ("exact_knn",))

    # path 3: the same server escaping the route runs the rank kernel
    ex.reset_launch_counts()
    for label in ("f32", "bf16"):
        serve(f"exact {label} no_twophase (cuda-rank)", servers[label], no_twophase=True)
    if results["exact f32 no_twophase (cuda-rank)"][2] != 1.0:
        raise AssertionError("f32 rank recall up to ties is not 1.0")
    read_counts("Server no_twophase", ("exact_knn",))
    merge_paths(servers["f32"], serve, results, read_counts, X, Y)
    tier_server(X, k, servers["f32"], serve, results, read_counts, smi)

    # path 4: packed hash serving through the probe kernel, then updates
    srv_packed, Yc, packed_err, packed_timing, packed_bound = packed_serving(
        args.seed, dev, read_counts)
    errs["probe_topk"] = packed_err
    timing["probe_topk"] = packed_timing
    bounds["probe_topk"] = packed_bound
    sharded_packed(mesh, srv_packed, Yc, args.seed, smi, read_counts)
    sharded_server_packed(mesh, srv_packed, Yc, args.seed, smi, read_counts)
    sharded_tune(mesh, srv_packed.points, Yc, args.seed, smi, read_counts)
    dist.destroy_process_group()
    sharded_two_ranks(args.seed, smi, read_counts)
    tune_phase(srv_packed.points, Yc, args.seed, read_counts)
    updates(srv_packed, Yc, args.seed, dev, read_counts)

    # path 5: the harness CLIs on the card and the card-vs-CPU parity band
    harness_phase(args.seed, read_counts)
    parity_band(read_counts)

    # -- phase 6: crossover and profiles -----------------------------------------------
    ratios = crossover(X, Xb, Y, k, args.seed, dev)
    profile_serving("Server f32 two-phase", servers["f32"], Y)
    del servers
    profile_serving(f"Server packed bf16 w={PACKED_WINDOW} P={PACKED_PROBES}", srv_packed, Yc)

    # -- phase 7: the Deep-10M deployment and the int8 edge, the earlier
    # phases' tensors freed first -------------------------------------------------------
    del srv_packed, Yc, X, Xb, X64, Y64, true_s, true_big
    torch.cuda.empty_cache()
    before = dict(total)
    at_scale = deep10m(args.seed, dev, smi, read_counts, Y, ratios,
                       args.deep10m_graph_precision)
    deep_launches = {name: total[name] - before[name] for name in total}

    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": total[name], "max_abs_err": errs[name],
        "ms": timing[name][0], "plain_ms": timing[name][1],
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": timing[name][2],
        **{f"{field}_{tier}": tiers.get(name, {}).get(f"{field}_{tier}")
           for field in ("ms", "bound_ms", "library_ms", "max_abs_err") for tier in BF16_PASSES},
        **{f"launches_{tier}": total.get(f"{name}:{tier}") for tier in BF16_PASSES},
        "launches_deep10m": deep_launches[name], "at_scale": at_scale[name],
        "launches_bench": bench["launches"][name], "at_bench": bench["rows"].get(name)}
        for name, (src, rep) in KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def pipelined(fn, reps: int):
    """(queries a second over ``reps`` pipelined calls after a warm-up,
    the last call's result); ``fn`` returns (ids, dists) of M queries."""
    fn()
    fence()
    t0 = time.perf_counter()
    outs = [fn() for _ in range(reps)]
    fence()
    return outs[-1][0].shape[0] * reps / (time.perf_counter() - t0), outs[-1]


def sharded_exact(mesh, index, X, Y, X64, Y64, true_s, smi, read_counts) -> None:
    """Phase ``sharded`` (a), exact-1M: ``build_sharded`` (exact graph
    through the rank kernel) on one NCCL rank equals the single-card
    ``build`` at the same seed (bases, row means, tables, counts, graph);
    ``search_sharded`` equals ``search``; ``search_exact_sharded`` through
    the rank kernel and with ``twophase=True`` (emit and rescan) has
    recall@10 1.0 up to ties against the float64 oracle and the ids of
    ``exact_search`` outside near-ties.  Each sharded call's QPS beside the
    single-card call's: the layer's own cost on one card."""
    k = 10
    ex.reset_launch_counts()
    t0 = time.perf_counter()
    sidx = sh.build_sharded(X, k, mesh=mesh, tries=index.tries, seed=0)
    fence()
    build_s = time.perf_counter() - t0
    for name in ("bases", "row_means", "tables", "counts", "graph"):
        if not torch.equal(getattr(sidx, name), getattr(index, name)):
            raise AssertionError(f"build_sharded on one rank: {name} differ from build's")
    if (sidx.tmax, sidx.d_short, sidx.n_local) != (index.tmax, index.d_short, N):
        raise AssertionError("build_sharded on one rank: another layout than build's")
    phase("sharded", f"build_sharded n={N} d=128 k={k} tries={index.tries} on 1 rank "
                     f"({dist.get_backend()}, collectives "
                     f"{'through host memory' if mesh.host_staged else 'on the card'}): "
                     f"{build_s:.2f} s; bases, row means, tables, counts and graph equal "
                     f"to build's [{smi}]")
    read_counts("sharded build (1 rank)", ("exact_knn",))

    ex.reset_launch_counts()
    s_qps, (sids, sdd) = pipelined(lambda: sh.search_sharded(sidx, X, Y, mesh=mesh), 5)
    c_qps, (cids, cdd) = pipelined(lambda: ann.search(index, X, Y), 5)
    if not (torch.equal(sids, cids) and torch.equal(sdd, cdd)):
        raise AssertionError("search_sharded on one rank differs from search")
    phase("sharded", f"search_sharded n={N} m={M}: {s_qps:.1f} QPS, single-card search "
                     f"{c_qps:.1f} QPS; ids and distances equal [{smi}]")
    read_counts("sharded search (1 rank)", ())

    ref_ids, ref_d = ann.exact_search(X, Y, k)
    for label, kw, single, need in (
            ("rank kernel", {}, lambda: ann.exact_search(X, Y, k), ("exact_knn",)),
            ("twophase=True", {"twophase": True}, lambda: tp.exact_knn_twophase(X, Y, k),
             ("twophase_emit", "twophase_rescan"))):
        ex.reset_launch_counts()
        s_qps, (eids, edd) = pipelined(
            lambda: sh.search_exact_sharded(X, Y, k, mesh=mesh, **kw), 10)
        counts = read_counts(f"sharded exact {label} (1 rank)", need)
        c_qps, (c_ids, c_d) = pipelined(single, 10)
        tie = _tie_recall(X64, Y64, eids, true_s[1], k)
        agree, tied = ids_agree(eids, ref_ids, ref_d)
        if tie != 1.0 or not agree:
            raise AssertionError(f"search_exact_sharded {label}: recall up to ties {tie}, "
                                 f"ids equal to exact_search's outside near-ties: {agree}")
        same = torch.equal(eids, c_ids) and torch.equal(edd, c_d)
        phase("sharded", f"search_exact_sharded {label} n={N} m={M} k={k}: {s_qps:.1f} QPS, "
                         f"single-card {c_qps:.1f} QPS; recall@10 up to ties 1.0, ids equal "
                         f"to exact_search's outside near-ties ({tied} near-tie rows), equal "
                         f"to the single-card call's: {same}; launches "
                         f"{ {n: c for n, c in counts.items() if c} } [{smi}]")


def sharded_packed(mesh, srv, Yc, seed: int, smi, read_counts) -> None:
    """Phase ``sharded`` (a), packed-1M: ``build_sharded`` + ``packed_sharded``
    (bf16 rows, window 96) on one NCCL rank give the packed ``Server``'s
    view, and ``search_packed_fused_sharded`` (probe kernel, 18 probes)
    equals the single-card ``search_packed_fused`` on it."""
    Xc, pv, k = srv.points, srv.packed, 10
    ex.reset_launch_counts()
    t0 = time.perf_counter()
    sidx = sh.build_sharded(Xc, k, mesh=mesh, tries=10, capacity="auto", seed=seed)
    spk = sh.packed_sharded(sidx, Xc, mesh=mesh, window=PACKED_WINDOW, dtype=torch.bfloat16)
    fence()
    build_s = time.perf_counter() - t0
    if not (torch.equal(sidx.tables, srv.index.tables) and torch.equal(sidx.graph, srv.index.graph)
            and torch.equal(spk.point_rows, pv.point_rows) and torch.equal(spk.ids, pv.ids)
            and torch.equal(spk.starts, pv.starts)):
        raise AssertionError("build_sharded + packed_sharded on one rank differ from the "
                             "packed Server's index and view")
    read_counts("sharded packed build (1 rank)", ("exact_knn",))
    calls = {
        "single-card": lambda: ann.search_packed_fused(pv, queries=Yc, n_probes=PACKED_PROBES),
        "sharded": lambda: sh.search_packed_fused_sharded(sidx, spk, Xc, Yc, mesh=mesh,
                                                          n_probes=PACKED_PROBES),
    }
    ex.reset_launch_counts()
    fids, fdd = calls["sharded"]()
    counts = read_counts("sharded fused packed search (1 rank)", ("probe_topk",))
    c_ids, c_d = calls["single-card"]()
    if not (torch.equal(fids, c_ids) and torch.equal(fdd, c_d)):
        raise AssertionError("search_packed_fused_sharded on one rank differs from "
                             "search_packed_fused")
    # host-bound: timed in turns, so a drift of the host's speed shows
    turns = [(name, pipelined(calls[name], 20)[0])
             for name in ("single-card", "sharded", "sharded", "single-card")]
    phase("sharded", f"packed-1M build_sharded + packed_sharded bf16 w={PACKED_WINDOW} on 1 "
                     f"{dist.get_backend()} rank: {build_s:.2f} s, tables, graph and packed "
                     f"view equal to the Server's; search_packed_fused_sharded "
                     f"P={PACKED_PROBES} m={M} equal to search_packed_fused (ids and "
                     f"distances); QPS in turns: "
                     f"{', '.join(f'{n} {q:.1f}' for n, q in turns)}; probe_topk launches "
                     f"{counts['probe_topk']} [{smi}]")
    merge_cost(mesh, sidx, c_ids, c_d, Yc, smi)


def save_and_load(srv, mesh, queries, ids, dists, where: str) -> tuple[float, float]:
    """``srv.save`` into ``where``, ``ShardedServer.load`` onto the same
    mesh: (save s, load s); the loaded server's search must equal ``(ids,
    dists)`` bit for bit and its ``describe()`` the saved one's."""
    t0 = time.perf_counter()
    srv.save(where)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = sv.ShardedServer.load(where, mesh=mesh)
    fence()
    load_s = time.perf_counter() - t0
    b_ids, b_d = back.search(queries)
    if not (torch.equal(b_ids, ids) and torch.equal(b_d, dists)
            and back.describe() == srv.describe()):
        raise AssertionError(f"ShardedServer {srv.mode}: the loaded server serves other "
                             "results than the saved one")
    return save_s, load_s


def sharded_server_exact(mesh, X, Y, true_s, smi, read_counts) -> None:
    """Phase ``sharded_server`` (a), exact-1M on one NCCL rank: the JAX TPU
    gate ``sharded_server_1chip`` (``ShardedServer.build(mode="exact",
    twophase_min_n=10_000)``: engine "twophase", recall@10 1.0 on 200
    queries against the float64 oracle); then that server, ``ShardedServer``
    auto (rank kernel) and the int8 tier (the single-card scale) on all
    1000 queries, each with ids equal to its single-card ``Server``'s
    outside near-ties, QPS beside the single-card server's and the raw
    ``search_exact_sharded``'s; then (c) the int8 server saved and loaded."""
    k, sub = 10, slice(0, SERVER_GATE_QUERIES)
    ex.reset_launch_counts()
    gate = sv.ShardedServer.build(X, k, mesh=mesh, mode="exact",
                                  twophase_min_n=SERVER_TWOPHASE_MIN_N)
    g_ids, _ = gate.search(Y[sub])
    fence()
    engine = gate.describe()["exact_engine"]
    rec = recall_at_k(true_s[0][sub].cpu().numpy(), g_ids.cpu().numpy(), k)
    counts = read_counts("sharded_server_1chip gate (1 rank)",
                         ("twophase_emit", "twophase_rescan"))
    if engine != "twophase" or rec != 1.0:
        raise AssertionError(f"sharded_server_1chip: engine {engine}, recall@10 {rec}")
    phase("sharded_server", f"sharded_server_1chip: ShardedServer.build n={N} d=128 k={k} "
                            f"mode=exact twophase_min_n={SERVER_TWOPHASE_MIN_N} on 1 "
                            f"{dist.get_backend()} rank: engine {engine}, recall@10 {rec:.4f} "
                            f"on {SERVER_GATE_QUERIES} queries vs the f64 oracle; launches "
                            f"{ {n: c for n, c in counts.items() if c} } [{smi}]")
    int8 = sv.ShardedServer.build(X, k, mesh=mesh, storage_dtype=torch.int8)
    cases = (
        ("exact twophase_min_n=10000", gate,
         ann.Server.build(X, k, twophase_min_n=SERVER_TWOPHASE_MIN_N),
         lambda: sh.search_exact_sharded(X, Y, k, mesh=mesh, twophase=True),
         ("twophase_emit", "twophase_rescan")),
        ("auto (rank kernel)", sv.ShardedServer.build(X, k, mesh=mesh), ann.Server.build(X, k),
         lambda: sh.search_exact_sharded(X, Y, k, mesh=mesh), ("exact_knn",)),
        ("int8", int8, ann.Server.build(X, k, storage_dtype=torch.int8),
         lambda: sh.search_exact_sharded(int8.points, Y, k, mesh=mesh, scale=int8.scale),
         ("exact_knn",)),
    )
    for label, s_srv, c_srv, raw, need in cases:
        if label == "int8" and float(s_srv.scale) != c_srv.scale:
            raise AssertionError(f"ShardedServer int8 scale {float(s_srv.scale)} differs from "
                                 f"quantize_corpus's {c_srv.scale}")
        ex.reset_launch_counts()
        s_qps, (s_ids, s_d) = pipelined(lambda: s_srv.search(Y), 10)
        counts = read_counts(f"ShardedServer {label} (1 rank)", need)
        c_qps, (c_ids, c_d) = pipelined(lambda: c_srv.search(Y), 10)
        r_qps, _ = pipelined(raw, 10)
        agree, tied = ids_agree(s_ids, c_ids, c_d)
        if not agree:
            raise AssertionError(f"ShardedServer {label}: ids differ from the single-card "
                                 "Server's outside near-ties")
        phase("sharded_server", f"ShardedServer {label} n={N} m={M} k={k} on 1 rank "
                                f"({s_srv.describe()['exact_engine']}): {s_qps:.1f} QPS, "
                                f"single-card Server {c_qps:.1f} QPS, raw "
                                f"search_exact_sharded {r_qps:.1f} QPS; ids equal to the "
                                f"Server's outside near-ties ({tied} near-tie rows), equal "
                                f"throughout: {torch.equal(s_ids, c_ids)}; launches "
                                f"{ {n: c for n, c in counts.items() if c} } [{smi}]")
        if label == "int8":
            ex.reset_launch_counts()
            with tempfile.TemporaryDirectory(prefix="ann_ckpt_") as tmp:
                save_s, load_s = save_and_load(s_srv, mesh, Y, s_ids, s_d, f"{tmp}/int8")
            phase("sharded_server", f"save/load ShardedServer int8 n={N} (1 rank): save "
                                    f"{save_s:.2f} s, load {load_s:.2f} s; the loaded "
                                    f"server's search equal bit for bit [{smi}]")
            read_counts("ShardedServer int8 save/load (1 rank)", ("exact_knn",))


def sharded_server_packed(mesh, srv, Yc, seed: int, smi, read_counts) -> None:
    """Phase ``sharded_server`` (b), packed-1M on one NCCL rank:
    ``ShardedServer.build(mode="hash", layout="packed")`` at the packed
    ``Server``'s settings serves its ids and distances (probe kernel),
    QPS in turns beside it and the raw ``search_packed_fused_sharded``;
    then (c) saved and loaded."""
    k = 10
    ex.reset_launch_counts()
    t0 = time.perf_counter()
    hsrv = sv.ShardedServer.build(srv.points, k, mesh=mesh, mode="hash", layout="packed",
                                  window=PACKED_WINDOW, packed_dtype=torch.bfloat16,
                                  n_probes=PACKED_PROBES, tries=10, capacity="auto", seed=seed)
    fence()
    build_s = time.perf_counter() - t0
    read_counts("ShardedServer hash packed build (1 rank)", ("exact_knn",))
    ex.reset_launch_counts()
    s_ids, s_d = hsrv.search(Yc)
    counts = read_counts("ShardedServer hash packed search (1 rank)", ("probe_topk",))
    c_ids, c_d = srv.search(Yc)
    if not (torch.equal(s_ids, c_ids) and torch.equal(s_d, c_d)):
        raise AssertionError("ShardedServer hash packed differs from the packed Server")
    calls = {"Server": lambda: srv.search(Yc), "ShardedServer": lambda: hsrv.search(Yc),
             "raw search_packed_fused_sharded": lambda: sh.search_packed_fused_sharded(
                 hsrv.sidx, hsrv.spk, None, Yc, mesh=mesh, n_probes=PACKED_PROBES)}
    # host-bound: timed in turns, so a drift of the host's speed shows
    turns = [(name, pipelined(calls[name], 20)[0]) for name in (*calls, *reversed(calls))]
    desc = hsrv.describe()
    phase("sharded_server", f"ShardedServer hash packed bf16 w={PACKED_WINDOW} "
                            f"P={PACKED_PROBES} n={N} m={M} on 1 {dist.get_backend()} rank: "
                            f"build {build_s:.2f} s, layout {desc['layout']}, index_mb "
                            f"{desc['index_mb']}; ids and distances equal to the packed "
                            f"Server's; QPS in turns: "
                            f"{', '.join(f'{n} {q:.1f}' for n, q in turns)}; probe_topk "
                            f"launches {counts['probe_topk']} [{smi}]")
    ex.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="ann_ckpt_") as tmp:
        save_s, load_s = save_and_load(hsrv, mesh, Yc, s_ids, s_d, f"{tmp}/hash")
    read_counts("ShardedServer hash save/load (1 rank)", ("probe_topk",))
    phase("sharded_server", f"save/load ShardedServer hash packed n={N} (1 rank): save "
                            f"{save_s:.2f} s, load {load_s:.2f} s; the loaded server's search "
                            f"equal bit for bit [{smi}]")


def sharded_tune(mesh, Xc, Yc, seed: int, smi, read_counts) -> None:
    """Phase ``sharded_server`` (d): ``tune_sharded`` on packed-1M, one
    NCCL rank, every trial timed (batch 1000, bf16 packed rows, the
    ``SHARDED_TUNE_GRID``): every trial and the winner; the packed trials
    on the probe kernel ("fused"); ``report.server()`` serving the winner's
    recall within ``TUNE_SERVER_TOL``; card memory read at each exact tier's
    build and at the hash build, which must find the exact tiers freed."""
    cls, raw = sv.ShardedServer, sv.ShardedServer.__dict__["build"]
    mem = []

    def build(*a, **kw):
        mem.append((kw.get("mode"), kw.get("storage_dtype"), torch.cuda.memory_allocated()))
        return raw.__get__(None, cls)(*a, **kw)

    ex.reset_launch_counts()
    cls.build = build
    try:
        t0 = time.perf_counter()
        rep = sv.tune_sharded(Xc, 10, mesh=mesh, queries=Yc, batch=M, target_recall=TUNE_TARGET,
                              measure=True, measure_all=True, tries=10, capacity="auto",
                              seed=seed, packed_dtype=torch.bfloat16, **SHARDED_TUNE_GRID)
        fence()
        tune_s = time.perf_counter() - t0
    finally:
        cls.build = raw
    for t in rep.trials:
        phase("sharded_server", f"tune_sharded trial {json.dumps(t.as_dict())}")
    phase("sharded_server", f"tune_sharded winner {json.dumps(rep.best.as_dict())}; n={N} "
                            f"m={M} k=10 tries=10 target {TUNE_TARGET}, measured "
                            f"{rep.measured}, {len(rep.trials)} trials in {tune_s:.2f} s; card "
                            f"memory allocated at each build: "
                            f"{', '.join(f'{m} {dt} {b / 2**20:.1f} MiB' for m, dt, b in mem)} "
                            f"[{smi}]")
    exact_mem = [b for m, _, b in mem if m == "exact"]
    hash_mem = [b for m, _, b in mem if m == "hash"]
    if len(exact_mem) != 2 or hash_mem[0] > exact_mem[0] + (32 << 20):
        raise AssertionError("tune_sharded: an exact tier's corpus is still resident at the "
                             "hash build")
    packed = [t for t in rep.trials if t.engine == "packed"]
    if rep.best.qps is None or any(t.knobs["path"] != "fused" for t in packed):
        raise AssertionError("tune_sharded did not time its trials on the probe kernel")
    truth = ann.exact_search(Xc, Yc, 10)[0].cpu().numpy()
    srv = rep.server()
    ids, _ = srv.search(Yc)
    rec = recall_at_k(truth, ids.cpu().numpy(), 10)
    phase("sharded_server", f"tune_sharded report.server(): {srv.describe()}; recall@10 "
                            f"{rec:.4f} against the trial's {rep.best.recall:.4f}")
    if abs(rec - rep.best.recall) > TUNE_SERVER_TOL:
        raise AssertionError(f"report.server() serves recall {rec} against the winner's "
                             f"{rep.best.recall}")
    del srv, rep
    read_counts("tune_sharded (1 rank)", ("exact_knn", "probe_topk"))


def merge_cost(mesh, sidx, ids, dists, Yc, smi) -> None:
    """The all-gather merge alone at one fused call's shape (M queries,
    k = 10, one rank's top lists) beside a merge that gathers the ids and
    the distances apart (two all-gathers, as the JAX package does), and
    their parts: the one all-gather of both, the two, the final top-k.
    Host milliseconds a call over 200 pipelined calls, taken in 7 rounds
    that alternate them (the host's speed drifts), median and least; then
    the merge under ``torch.profiler``."""
    gids, gdd = sh._to_global(ids, dists, sidx.n_local, sidx.n, 0)
    both = torch.stack([gdd.view(torch.int32), gids], dim=-1)
    m, k = ids.shape[0], sidx.k

    def merge_apart():
        g, d = sh._to_global(ids, dists, sidx.n_local, sidx.n, 0)
        all_ids = sh._all_gather_stacked(mesh, g).transpose(0, 1).reshape(m, -1)
        all_dd = sh._all_gather_stacked(mesh, d).transpose(0, 1).reshape(m, -1)
        return topk_no_dedup(all_dd, all_ids, k)

    parts = {
        "merge (to_global, 1 all-gather, top-k)": lambda: sh._merge(
            mesh, ids, dists, sidx.n_local, sidx.n, k),
        "merge gathering apart (to_global, 2 all-gathers, top-k)": merge_apart,
        "the all-gather of both": lambda: sh._all_gather_stacked(mesh, both),
        "two all-gathers, ids then distances": lambda: (
            sh._all_gather_stacked(mesh, gids), sh._all_gather_stacked(mesh, gdd)),
        "the final top-k": lambda: topk_no_dedup(gdd, gids, k),
    }
    a, b = parts["merge (to_global, 1 all-gather, top-k)"](), merge_apart()
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        raise AssertionError("the merge differs from the merge gathering apart")
    times = {name: [] for name in parts}
    for _ in range(7):
        for name, fn in parts.items():
            fn()
            fence()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            fence()
            times[name].append(1e3 * (time.perf_counter() - t0) / 200)
    for name, ms in times.items():
        phase("sharded", f"{name}, m={m} k={k}, 1 {dist.get_backend()} rank: median "
                         f"{sorted(ms)[3]:.4f} ms of host time a call, least {min(ms):.4f} "
                         f"(7 rounds) [{smi}]")
    merge = parts["merge (to_global, 1 all-gather, top-k)"]
    profile_serving("sharded merge alone", types.SimpleNamespace(search=lambda _: merge()), Yc,
                    reps=50)


def sharded_two_ranks(seed: int, smi, read_counts) -> None:
    """Phase ``sharded`` (b): :func:`sharded_rank` in two gloo processes on
    the one card (NCCL refuses two ranks on one GPU), started by the
    package's launcher; their gates run in the ranks, their counts and
    numbers come back as each rank's last line."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ann_ckpt_") as ckpt:
        outs = dryrun.launch([sys.executable, os.path.abspath(__file__), "--seed", str(seed)],
                             SHARDED_RANKS, ["--ckpt", ckpt], timeout=SHARDED_TIMEOUT)
    wall_s = time.perf_counter() - t0
    res = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    launches = {name: sum(r["launches"][name] for r in res) for name in ex.launches}
    read_counts(f"sharded {SHARDED_RANKS} gloo ranks", (
        "exact_knn", "twophase_emit", "twophase_rescan", "probe_topk"), launches)
    launches = {name: sum(r["server_launches"][name] for r in res) for name in ex.launches}
    read_counts(f"ShardedServer {SHARDED_RANKS} gloo ranks", (
        "twophase_emit", "twophase_rescan", "probe_topk"), launches)
    r0 = res[0]
    phase("sharded", f"{SHARDED_RANKS} gloo ranks on one card (collectives "
                     f"{'through host memory' if r0['host_staged'] else 'on the card'}), "
                     f"n={SHARDED_N2} (n_local {r0['n_local']}, one pad row) d=128 k=10, "
                     f"whole run {wall_s:.1f} s: hash-graph build_sharded tries=10 "
                     f"{r0['build_s']:.2f} s, bf16 pack {r0['pack_s']:.2f} s; "
                     f"QPS with both ranks on the card: fused packed "
                     f"bf16 w={PACKED_WINDOW} P={PACKED_PROBES} {r0['qps_fused']:.1f}, "
                     f"exact rank kernel {r0['qps_exact']:.1f}, twophase=True "
                     f"{r0['qps_twophase']:.1f}, single-card exact_search "
                     f"{r0['qps_single']:.1f} [{smi}]")
    phase("sharded", f"{SHARDED_RANKS} ranks: exact and twophase ids equal to the global "
                     f"exact_search's outside near-ties ({r0['tied_exact']}, "
                     f"{r0['tied_twophase']} near-tie rows); no id >= n or pad row; card "
                     f"vs the same {SHARDED_RANKS}-rank search on the CPU on "
                     f"{CPU_CHECK_QUERIES} queries, the index carried by to_numpy/from_numpy: "
                     f"fused {r0['cpu_rows']} rows compared, ids equal outside near-ties "
                     f"({r0['cpu_tied']} near-tie rows), distances rtol 1e-5; exact ids equal "
                     f"outside near-ties ({r0['cpu_exact_tied']} near-tie rows)")
    phase("sharded_server", f"{SHARDED_RANKS} gloo ranks on one card, n={SHARDED_N2} k=10: "
                            f"ShardedServer exact twophase_min_n=1 (engine twophase on both "
                            f"ranks) {r0['qps_server_exact']:.1f} QPS, ids and distances "
                            f"equal to search_exact_sharded(twophase=True)'s; ShardedServer "
                            f"hash packed bf16 w={PACKED_WINDOW} P={PACKED_PROBES} (build "
                            f"and pack {r0['server_build_s']:.2f} s) "
                            f"{r0['qps_server_hash']:.1f} QPS, equal to "
                            f"search_packed_fused_sharded's on its state; save/load on "
                            f"{SHARDED_RANKS} "
                            f"ranks, searches equal bit for bit: exact save "
                            f"{r0['save_s']['exact']:.2f} s load {r0['load_s']['exact']:.2f} s, "
                            f"hash save {r0['save_s']['hash']:.2f} s load "
                            f"{r0['load_s']['hash']:.2f} s [{smi}]")


def sharded_rank(args) -> None:
    """One rank of the sharded phase's run (b): a gloo group over the
    launcher's file store, this rank's shard on the card.  The hash-graph
    build at n = 200,001 (a pad row on the last shard), the fused packed
    search, the exact search through the rank kernel and with
    ``twophase=True``; gates: the exact searches equal the global
    ``exact_search``, no id >= n, and the card equals the same two-rank
    search on the CPU on 50 queries, the index carried across by
    ``to_numpy`` / ``from_numpy``.  Prints one JSON line last."""
    dryrun.join(args, timeout=SHARDED_TIMEOUT)
    try:
        mesh = sh.make_mesh()
        torch.cuda.set_device(mesh.device)
        res = _two_rank_paths(mesh, args.seed, Path(args.ckpt))
    finally:
        dist.destroy_process_group()
    print(json.dumps(res))


def _two_rank_paths(mesh, seed: int, ckpt: Path) -> dict:
    n, k, sub = SHARDED_N2, 10, slice(0, CPU_CHECK_QUERIES)
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 128), dtype=np.float32)
    Y = rng.standard_normal((M, 128), dtype=np.float32)
    Xd, Yd = torch.from_numpy(X).to(mesh.device), torch.from_numpy(Y).to(mesh.device)
    ex.reset_launch_counts()
    t0 = time.perf_counter()
    sidx = sh.build_sharded(Xd, k, mesh=mesh, tries=10, capacity="auto", seed=seed,
                            graph_mode="hash", store_points=True)
    fence()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    spk = sh.packed_sharded(sidx, mesh=mesh, window=PACKED_WINDOW, dtype=torch.bfloat16)
    fence()
    pack_s = time.perf_counter() - t0
    q_fused, (fids, fdd) = pipelined(lambda: sh.search_packed_fused_sharded(
        sidx, spk, None, Yd, mesh=mesh, n_probes=PACKED_PROBES), 5)
    q_exact, (eids, edd) = pipelined(lambda: sh.search_exact_sharded(Xd, Yd, k, mesh=mesh), 5)
    q_two, (tids, tdd) = pipelined(lambda: sh.search_exact_sharded(
        Xd, Yd, k, mesh=mesh, twophase=True), 5)
    launches = dict(ex.launches)
    for name in ("exact_knn", "twophase_emit", "twophase_rescan", "probe_topk"):
        if launches[name] < 1:
            raise AssertionError(f"rank {mesh.rank}: kernel {name} was not launched")
    for label, ids in (("fused", fids), ("exact", eids), ("twophase", tids)):
        if ids.shape != (M, k) or int(ids.max()) >= n:
            raise AssertionError(f"rank {mesh.rank}: {label} returned an id >= n or pad row")
    q_single, (g_ids, g_d) = pipelined(lambda: ann.exact_search(Xd, Yd, k), 5)
    tied = {}
    for label, ids in (("exact", eids), ("twophase", tids)):
        agree, tied[label] = ids_agree(ids, g_ids, g_d)
        if not agree:
            raise AssertionError(f"rank {mesh.rank}: {label} differs from the global "
                                 "exact_search outside near-ties")
    # the same two-rank searches on the CPU, the card-built index carried across
    arrays = sidx.to_numpy(mesh)
    cpu = sh.make_mesh(device="cpu")
    csidx = sh.ShardedIndex.from_numpy(arrays, cpu)
    cspk = sh.packed_sharded(csidx, mesh=cpu, window=PACKED_WINDOW, dtype=torch.bfloat16)
    c_ids, c_d = sh.search_packed_fused_sharded(csidx, cspk, None, Y[sub], mesh=cpu,
                                                n_probes=PACKED_PROBES)
    cpu_rows, cpu_tied = compare_with_cpu("two-rank fused search", sidx, Yd[sub], fids[sub],
                                          fdd[sub], c_ids, c_d)
    ce_ids, ce_d = sh.search_exact_sharded(X, Y[sub], k, mesh=cpu)
    agree, cpu_exact_tied = ids_agree(eids[sub].cpu(), ce_ids, ce_d)
    if not agree:
        raise AssertionError(f"rank {mesh.rank}: exact ids differ card vs CPU")
    # ShardedServer over the same corpus: exact staged for two-phase on both
    # ranks, hash packed built as above; each equal to the raw call on its
    # own state, then saved and loaded on these ranks
    t0 = time.perf_counter()
    hsrv = sv.ShardedServer.build(Xd, k, mesh=mesh, mode="hash", layout="packed",
                                  window=PACKED_WINDOW, packed_dtype=torch.bfloat16,
                                  n_probes=PACKED_PROBES, tries=10, capacity="auto", seed=seed,
                                  graph_mode="hash")
    fence()
    server_build_s = time.perf_counter() - t0
    raw_hash = sh.search_packed_fused_sharded(hsrv.sidx, hsrv.spk, None, Yd, mesh=mesh,
                                              n_probes=PACKED_PROBES)
    ex.reset_launch_counts()
    exs = sv.ShardedServer.build(Xd, k, mesh=mesh, mode="exact", twophase_min_n=1)
    if exs.describe()["exact_engine"] != "twophase":
        raise AssertionError(f"rank {mesh.rank}: ShardedServer exact is not two-phase")
    q_srv_exact, (x_ids, x_d) = pipelined(lambda: exs.search(Yd), 5)
    q_srv_hash, (h_ids, h_d) = pipelined(lambda: hsrv.search(Yd), 5)
    for label, a, b in (("exact", (x_ids, x_d), (tids, tdd)), ("hash", (h_ids, h_d), raw_hash)):
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"rank {mesh.rank}: ShardedServer {label} differs from the "
                                 "raw sharded search")
    save_s, load_s = {}, {}
    for label, srv, ids, dd in (("exact", exs, x_ids, x_d), ("hash", hsrv, h_ids, h_d)):
        save_s[label], load_s[label] = save_and_load(srv, mesh, Yd, ids, dd, ckpt / label)
    server_launches = dict(ex.launches)
    return dict(rank=mesh.rank, launches=launches, host_staged=mesh.host_staged,
                n_local=sidx.n_local, build_s=build_s, pack_s=pack_s,
                server_build_s=server_build_s, qps_fused=q_fused, qps_exact=q_exact,
                qps_twophase=q_two, qps_single=q_single, tied_exact=tied["exact"],
                tied_twophase=tied["twophase"], cpu_rows=cpu_rows, cpu_tied=cpu_tied,
                cpu_exact_tied=cpu_exact_tied, server_launches=server_launches,
                qps_server_exact=q_srv_exact, qps_server_hash=q_srv_hash, save_s=save_s,
                load_s=load_s)


def crossover(X, Xb, Y, k: int, seed: int, dev) -> dict:
    """Rank kernel against the two-phase engine, f32 and bf16 stored, on
    the prefixes 250k, 500k and 1M of the main corpus and on 2M and 4M
    corpora drawn on the card from ``seed``; then the threshold
    :func:`twophase_rule` takes from the f32 ratios.  Returns the ratios,
    {(label, n): two-phase / rank}, which the ``deep10m`` phase extends."""
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    ratios = {}
    for n in (250_000, 500_000, N, 2 * N, 4 * N):
        Xf = X[:n] if n <= N else torch.randn(n, 128, generator=gen, device=dev)
        for label, Xs in (("f32", Xf), ("bf16", Xb[:n] if n <= N else Xf.to(torch.bfloat16))):
            ratios[label, n] = crossover_ratio(label, Xs, Y, k)
        del Xf, Xs
    twophase_rule(ratios)
    return ratios


def crossover_ratio(label: str, Xs, Y, k: int) -> float:
    """Two-phase / rank ms at one corpus (CUDA events, one line)."""
    n, d = Xs.shape
    rank_ms = cuda_ms(lambda: ex.exact_knn(Xs, Y, k), reps=5)
    two_ms = cuda_ms(lambda: tp.exact_knn_twophase(Xs, Y, k), reps=5)
    phase("crossover", f"{label} n={n} d={d} m={Y.shape[0]} k={k} seg={tp.auto_seg(n)}: rank "
                       f"{rank_ms:.3f} ms two-phase {two_ms:.3f} ms "
                       f"(two-phase/rank {two_ms / rank_ms:.3f})")
    return two_ms / rank_ms


def twophase_rule(ratios: dict) -> int:
    """The rule of ``ops/twophase.py:TWOPHASE_MIN_N`` on the f32 ratios:
    the smallest measured n from which two-phase / rank <= 1 at that n and
    at every larger one (8,000,000, the exact engine's limit, where none);
    printed beside the constant, which this smoke never changes."""
    sizes = sorted(n for label, n in ratios if label == "f32")
    found = next((n for i, n in enumerate(sizes)
                  if all(ratios["f32", m] <= 1.0 for m in sizes[i:])), None)
    rule = 8_000_000 if found is None else found
    phase("crossover", f"threshold by the rule (f32, n in {sizes}): {rule}"
                       + (" (no measured n qualifies: the exact engine's limit)"
                          if found is None else "") + f"; TWOPHASE_MIN_N {tp.TWOPHASE_MIN_N}")
    return rule


def gib(nbytes: float) -> str:
    return f"{nbytes / 2**30:.2f} GiB"


def reset_peak() -> None:
    fence()
    torch.cuda.reset_peak_memory_stats()


def read_peak() -> int:
    """The card's peak allocated bytes since :func:`reset_peak`."""
    fence()
    return torch.cuda.max_memory_allocated()


def tier_dot64(q, x, tier: str):
    """q . x (m, n) in float64 as a kernel's tier forms it: from the raw
    values at "highest"; at "split3" and "default" from their bf16 factors
    (:func:`ops.exact.split_bf16`), the factor products summed in float64
    (what :func:`near_tie_ok` judges in)."""
    if tier == "highest":
        return q.double() @ x.double().T
    (qh, ql), (xh, xl) = ex.split_bf16(q), ex.split_bf16(x)
    dot = qh.double() @ xh.double().T
    if tier == "split3":
        dot += qh.double() @ xl.double().T + ql.double() @ xh.double().T
    return dot


def oracle64_chunked(points, queries, k: int, *, tier: str = "highest", exclude=None,
                     rows: int = 1 << 20, qblock: int = 250):
    """(ids (m, k) int64, distances (m, k) float64): each query's k
    nearest rows of ``points`` by |x|^2 + |q|^2 - 2 q.x in float64, q.x at
    ``tier`` (:func:`tier_dot64`).  The corpus is upcast ``rows`` rows at a
    time and the queries go ``qblock`` at a time, so no float64 copy of
    the corpus and no (m, n) matrix is made; ``exclude`` (m,): one id
    never returned per query."""
    n = points.shape[0]
    out_i, out_d = [], []
    for a in range(0, queries.shape[0], qblock):
        q = queries[a: a + qblock].float()
        qn = (q.double() ** 2).sum(-1)
        best_d = best_i = None
        for lo in range(0, n, rows):
            x = points[lo: lo + rows].float()
            dd = (x.double() ** 2).sum(-1)[None, :] + qn[:, None] - 2.0 * tier_dot64(q, x, tier)
            if exclude is not None:
                e = exclude[a: a + qblock].long() - lo
                hit = torch.nonzero((e >= 0) & (e < x.shape[0])).squeeze(1)
                dd[hit, e[hit]] = float("inf")
            d, i = torch.topk(dd, min(k, dd.shape[1]), dim=1, largest=False)
            i = i + lo
            if best_d is not None:
                d, j = torch.topk(torch.cat([best_d, d], 1), k, dim=1, largest=False)
                i = torch.cat([best_i, i], 1).gather(1, j)
            best_d, best_i = d, i
        out_i.append(best_i)
        out_d.append(best_d)
    return torch.cat(out_i), torch.cat(out_d)


def pair_dist64(q, xs, tier: str):
    """Squared distances (r, k) float64 of each query row q (r, d) to its
    rows xs (r, k, d) in :func:`tier_dot64`'s score domain."""
    qn = (q.double() ** 2).sum(-1)[:, None]
    xn = (xs.double() ** 2).sum(-1)
    if tier == "highest":
        dot = torch.einsum("rd,rkd->rk", q.double(), xs.double())
    else:
        (qh, ql), (xh, xl) = ex.split_bf16(q), ex.split_bf16(xs)
        dot = torch.einsum("rd,rkd->rk", qh.double(), xh.double())
        if tier == "split3":
            dot += (torch.einsum("rd,rkd->rk", qh.double(), xl.double())
                    + torch.einsum("rd,rkd->rk", ql.double(), xh.double()))
    return qn + xn - 2.0 * dot


def graph_rows_ok(X, graph, rows, k: int, tier: str, rtol: float) -> float:
    """Share of the sampled rows' graph edges (self excluded) that lie
    within ``rtol`` of the k-th nearest distance of the oracle at
    ``tier`` (:func:`oracle64_chunked`), distances in its score domain."""
    q = X[rows]
    _, kd = oracle64_chunked(X, q, k, tier=tier, exclude=rows)
    g = graph[rows].long()
    real = (g < X.shape[0]) & (g != rows[:, None].long())
    dd = pair_dist64(q.float(), X[g.clamp(max=X.shape[0] - 1)].float(), tier)
    return float((real & (dd <= kd[:, k - 1: k] * (1 + rtol))).float().mean())


def qps_at(search, Y, batch: int, reps: int = 3) -> float:
    """Pipelined queries a second of ``search`` over all of ``Y`` in
    batches of ``batch`` rows, ``reps`` passes after a one-batch warm-up,
    one fence at the end."""
    search(Y[:batch])
    fence()
    t0 = time.perf_counter()
    for _ in range(reps):
        for lo in range(0, Y.shape[0], batch):
            search(Y[lo: lo + batch])
    fence()
    return reps * Y.shape[0] / (time.perf_counter() - t0)


def seg_min_scores(scores, seg: int):
    """Emit's function on a score matrix (m, n): the last segment padded
    with +inf, then each segment's (minimum, first argmin)."""
    m, n = scores.shape
    n_seg = -(-n // seg)
    pad = torch.nn.functional.pad(scores, (0, n_seg * seg - n), value=float("inf"))
    return pad.view(m, n_seg, seg).min(-1)


def at_scale_row(shape: str, ms, plain_ms, b, library_ms, err, **extra) -> dict:
    return {"shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
            "bound_by": b[1], "library_ms": library_ms, "max_abs_err": err, **extra}


def rank_designs(X, Y, chunk_excl, hopper_ms: float, hopper_chunk_ms: float, smi) -> None:
    """The rank kernel's two float32 designs at "highest" (n x 128, k = 10)
    side by side: the Hopper pipeline and the tile loop at m = 1 and 128
    (one query block, where ``rank_design`` keeps the tile loop), 256, the
    kernel table's m = 1000 and one 65,536-row graph chunk with ``exclude``
    = own id (the last two Hopper times measured by the caller through
    ``exact_knn``, which must have routed there).  The design the router
    picks must not be the slower one at any of them, and the two designs'
    ids agree outside near-ties."""
    before = ex.launches["exact_knn:wgmma"]
    ia, _ = ex.exact_knn(X, Y, 10)
    if ex.launches["exact_knn:wgmma"] != before + 1:
        raise AssertionError("the float32 rank kernel did not take the Hopper pipeline")
    ms = {}
    for m in (1, 128, 256):
        qm = Y[:m].contiguous()
        ms[m] = (cuda_ms(lambda: hopper_rank(X, qm, 10), reps=20),
                 cuda_ms(lambda: tile_loop_rank(X, qm, 10), reps=20))
    ms[M] = (hopper_ms, cuda_ms(lambda: tile_loop_rank(X, Y, 10), reps=10))
    ms[GRAPH_CHUNK] = (hopper_chunk_ms,
                       cuda_ms(lambda: tile_loop_rank(X, X[:GRAPH_CHUNK], 10, chunk_excl),
                               reps=1, warmup=0))
    ib, db = tile_loop_rank(X, Y, 11)
    fence()
    ok, _ = ids_agree(ia, ib[:, :10], db, rtol=1e-5)
    if not ok:
        raise AssertionError("the rank kernel's two designs disagree outside near-ties")
    phase("kernel", f"rank designs n={N} k=10 (Hopper / tile loop, ms, routed *): "
                    + ", ".join(f"m={m} {wg:.3f} / {tl:.3f}"
                                + (" *H" if ex.rank_design(torch.float32, "highest", 128, 10, m)
                                   == "wgmma" else " *T") for m, (wg, tl) in ms.items())
                    + f"; 3xTF32 bound at m={M} {1e3 * 3 * 2.0 * M * N * 128 / PEAK_TF32:.3f} ms"
                    + f"; card [{smi}]")
    for m, (wg, tl) in ms.items():
        hopper = ex.rank_design(torch.float32, "highest", 128, 10, m) == "wgmma"
        if (wg if hopper else tl) > (tl if hopper else wg):
            raise AssertionError(f"the rank kernel at m = {m} routes to the "
                                 f"{'Hopper' if hopper else 'tile-loop'} design, the slower one "
                                 f"({wg:.3f} ms Hopper, {tl:.3f} ms tile loop)")


def hopper_rank(points, queries, k: int):
    """The rank kernel on the Hopper pipeline (``ops/exact.py:_rank_wgmma``)
    for a float32 corpus at "highest" whatever ``rank_design`` routes: how
    ``rank_designs`` reads the side of the gate the router leaves to the
    tile loop."""
    q, qn, scale2 = ex._prepare(points, queries, None)
    sms = torch.cuda.get_device_properties(points.device).multi_processor_count
    return ex._rank_wgmma(ex._library("exact_knn"), points, q, qn, k, None, scale2, sms)


def tile_loop_rank(points, queries, k: int, exclude=None):
    """The rank kernel on the tile loop (``csrc/knn_tile.cuh``) for a float32
    corpus at "highest" whatever ``rank_design`` routes:
    ``exact_knn_launch`` at its grid, as ``_split_launch`` launched every
    rank call before the Hopper pipeline served float32 "highest".
    Returns (ids, distances)."""
    n, d = points.shape
    m = queries.shape[0]
    dev = points.device
    q, qn, scale2 = ex._prepare(points, queries, None)
    lib = ex._library("exact_knn")
    s = ex.splits(m, n, torch.cuda.get_device_properties(dev).multi_processor_count,
                  *ex.tile_geometry("exact_knn"))
    part_d = torch.empty((m, s, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((m, s, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, k), dtype=torch.int32, device=dev)
    err = lib.exact_knn_launch(ex.device_index(dev), points.data_ptr(),
                               ex._DTYPE_CODE[points.dtype], ex.TIER_CODE["highest"],
                               q.data_ptr(), None if exclude is None else exclude.data_ptr(),
                               qn.data_ptr(), n, d, m, k, s, part_d.data_ptr(),
                               part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), scale2,
                               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise ex.launch_error(lib, "exact_knn", err)
    return out_i, out_d


def tile_loop_emit(points, q, seg: int):
    """Emit on the tile loop (``csrc/knn_tile.cuh``) whatever the corpus
    type: ``twophase_emit_launch`` at the rank kernel's grid, as
    ``segment_minima`` launched it for 16-bit corpora before the Hopper
    pipeline served them.  The yardstick of the Hopper emit's small-m
    gate."""
    n, d = points.shape
    m = q.shape[0]
    n_seg = -(-n // seg)
    dev = points.device
    seg_d = torch.empty((m, n_seg), dtype=torch.float32, device=dev)
    seg_i = torch.empty((m, n_seg), dtype=torch.int32, device=dev)
    lib = ex._library("twophase_knn")
    s = ex.splits(m, n, torch.cuda.get_device_properties(dev).multi_processor_count,
                  *ex.tile_geometry("twophase_knn"))
    err = lib.twophase_emit_launch(ex.device_index(dev), points.data_ptr(),
                                   ex._DTYPE_CODE[points.dtype], 0, q.data_ptr(), None, n, d, m,
                                   seg, n_seg, s, seg_d.data_ptr(), seg_i.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise ex.launch_error(lib, "twophase_emit", err)
    return seg_d, seg_i


def hopper_emit(Xb, Y, seg: int, err, rows_out, smi) -> None:
    """The Hopper emit (``csrc/knn_wgmma.cuh``) on the 10M x 96 bf16 corpus:
    its time at m = 1,000 and at the Deep-10M cell's batch of 10,000 (Y
    repeated; emit's work does not depend on the values) beside the bf16
    bound, and at m = 1 and 26 (a single query, add_points' emit-all block)
    beside the tile loop on the same card, which must not be faster; the
    tile loop's minima equal the Hopper emit's outside near-ties."""
    y10k = torch.cat([Y] * 10)
    before = ex.launches["twophase_emit:wgmma"]
    wg_ms = {m: cuda_ms(lambda: tp.segment_minima(Xb, y10k[:m].contiguous(), seg),
                        reps=3 if m > 1000 else 10) for m in (1, 26, 1000, 10_000)}
    if ex.launches["twophase_emit:wgmma"] == before:
        raise AssertionError("deep10m: the bf16 emit did not take the Hopper pipeline")
    tile_ms = {m: cuda_ms(lambda: tile_loop_emit(Xb, y10k[:m].contiguous(), seg), reps=10)
               for m in (1, 26)}
    va, ia = tp.segment_minima(Xb, Y[:26].contiguous(), seg)
    vb, ib = tile_loop_emit(Xb, Y[:26].contiguous(), seg)
    fence()
    if not torch.allclose(va, vb, rtol=1e-5, atol=1e-4) or float((ia != ib).float().mean()) > 1e-3:
        raise AssertionError("deep10m: the Hopper emit and the tile loop disagree at m = 26")
    bounds = {m: 1e3 * 2.0 * m * DEEP_N * DEEP_D / PEAK_BF16 for m in wg_ms}
    phase("kernel", f"time Hopper emit 10M x {DEEP_D} bf16 seg={seg}: "
                    + ", ".join(f"m={m} {wg_ms[m]:.3f} ms (bound {bounds[m]:.3f} ms, "
                                f"{100 * bounds[m] / wg_ms[m]:.1f}%)" for m in wg_ms)
                    + "; tile loop " + ", ".join(f"m={m} {t:.3f} ms" for m, t in tile_ms.items())
                    + f"; card [{smi}]")
    for m in (1, 26):
        if wg_ms[m] > tile_ms[m]:
            raise AssertionError(f"deep10m: the Hopper emit at m = {m} ({wg_ms[m]:.3f} ms) is "
                                 f"slower than the tile loop ({tile_ms[m]:.3f} ms)")
    for m in (1000, 10_000):
        rows_out["twophase_emit"].append(at_scale_row(
            f"10M x {DEEP_D} bf16 m={m} seg={seg} Hopper emit", wg_ms[m], None,
            (bounds[m], "operations"), None, err))


def deep10m(seed: int, dev, smi, read_counts, Y128, ratios,
            graph_precision: str = DEEP_GRAPH_PRECISION) -> dict:
    """Phase ``deep10m``: the JAX package's largest one-chip deployment
    (Deep-10M: ``data/datasets.py:synthesize("deep-10m")``, 10M x 96
    clustered, 1000 queries, k = 10) through the engines the router picks
    past 8M rows, then the int8 route's edge at 32M x 96 and the
    rank/two-phase crossover at 8M and 10M.  Gates: every route as the
    router names it, f32 exact recall@10 1.0 up to ties on the two-phase
    engine and the rank kernel, each kernel equal to its plain version
    outside near-ties, packed recall@10 >= RECALL_GUARD at window 96 and 18
    probes, card = CPU on 50 queries, the exact graph equal to its tier's
    float64 oracle on sampled rows.  Returns {kernel: [at-scale rows]} for
    the kernels line."""
    k, seg = DEEP_K, tp.auto_seg(DEEP_N)
    P = k + 2
    rows_out = {name: [] for name in KERNELS}

    # 1. data and oracle
    t0 = time.perf_counter()
    ds = synthesize("deep-10m", DEEP_N, DEEP_D, DEEP_NQ)
    synth_s = time.perf_counter() - t0
    X = torch.from_numpy(ds.base).to(dev)
    Y = torch.from_numpy(ds.queries).to(dev)
    Y64 = Y.double()
    reset_peak()
    t0 = time.perf_counter()
    true_s = oracle64_chunked(X, Y, k)
    fence()
    oracle_s = time.perf_counter() - t0
    truth = true_s[0].cpu().numpy()
    t0 = time.perf_counter()
    gt = ensure_groundtruth(ds, k)
    gt_s = time.perf_counter() - t0
    gt_rec, gt_tie = recall_up_to_ties(X, Y64, torch.from_numpy(gt).to(dev), true_s, k)
    del ds
    phase("deep10m", f"data: synthesize('deep-10m', {DEEP_N}, {DEEP_D}, {DEEP_NQ}) "
                     f"{synth_s:.2f} s on the host; float64 oracle on the card in chunks "
                     f"{oracle_s:.2f} s; ensure_groundtruth (float32, on the card) {gt_s:.2f} s, "
                     f"its ids vs the float64 oracle recall@{k} {gt_rec:.4f} (up to ties "
                     f"{gt_tie:.4f}); peak {gib(read_peak())}; card [{smi}]")

    # 2. the exact routes at 10M
    exact_keys = ("exact_knn", "exact_knn_rescan", "exact_knn_stream", "twophase_emit",
                  "twophase_rescan", "twophase_rescan_all")
    routes = (("exact_search f32", None, "twophase", {}),
              ("exact_search f32 no_twophase", None, "rank", {"no_twophase": True}),
              ("Server auto bf16", torch.bfloat16, "twophase", None),
              ("Server auto int8", torch.int8, "twophase", None))
    for label, sdt, want, kw in routes:
        ex.reset_launch_counts()
        reset_peak()
        if kw is not None:
            engine = tp.route(DEEP_N, k, {}, kw.get("no_twophase", False))
            search = (lambda q, kw=kw: ann.exact_search(X, q, k, **kw))
            named = f"route {engine}"
        else:
            srv = ann.Server.build(X, k, storage_dtype=sdt)
            desc = srv.describe()
            engine = desc["exact_engine"].removeprefix("cuda-") if desc["mode"] == "exact" \
                else desc["mode"]
            search = srv.search
            named = f"describe() mode {desc['mode']} exact_engine {desc['exact_engine']}"
        if engine != want:
            raise AssertionError(f"deep10m {label}: resolved to {engine}, not {want}")
        qps = {b: qps_at(search, Y, b) for b in DEEP_BATCHES}
        ids, _ = search(Y)
        rec, tie = recall_up_to_ties(X, Y64, ids, true_s, k)
        need = ("twophase_emit", "twophase_rescan") if want == "twophase" else ("exact_knn",)
        counts = read_counts(f"deep10m {label}", need)
        stray = [c for c in exact_keys if counts[c] and c not in need]
        if stray:
            raise AssertionError(f"deep10m {label} also launched {stray}")
        phase("deep10m", f"{label} n={DEEP_N} d={DEEP_D} k={k}: {named}; recall@{k} "
                         f"{rec:.4f} (up to ties {tie:.4f}); pipelined QPS "
                         + ", ".join(f"batch {b} {q:.1f}" for b, q in qps.items())
                         + f"; peak {gib(read_peak())}; card [{smi}]")
        if sdt is None and tie != 1.0:
            raise AssertionError(f"deep10m {label}: f32 recall up to ties {tie}, not 1.0")
        if kw is None:
            del srv
        del search
    torch.cuda.empty_cache()

    # each kernel against its plain version on 100 queries, at seg = 512
    y100 = Y[:DEEP_CHECK_QUERIES].contiguous()
    Xb = X.to(torch.bfloat16)
    X8, s8 = ex.quantize_corpus(X)
    types = (("f32", X, None), ("bf16", Xb, None), ("int8", X8, float(s8)))
    errs = {}
    for label, pts, sc in types:
        errs["emit", label] = check_emit(f"10M x {DEEP_D} {label} m={DEEP_CHECK_QUERIES} "
                                         f"seg={seg}", pts, y100, seg, scale=sc)
        errs["rescan", label] = check_rescan(
            f"10M x {DEEP_D} {label} m={DEEP_CHECK_QUERIES} P={P} seg={seg} k={k}", pts,
            kernel_queries(pts, y100, sc), window_starts(pts, y100, P, seg, scale=sc), seg, k)
    errs["rank"] = check_case(f"10M x {DEEP_D} m={DEEP_CHECK_QUERIES} k={k}", X, y100, k)
    own = torch.arange(DEEP_CHECK_QUERIES, dtype=torch.int32, device=dev)
    errs["graph"] = check_case(f"10M x {DEEP_D} graph rows m={DEEP_CHECK_QUERIES} exclude=self "
                               f"{graph_precision}", X, X[:DEEP_CHECK_QUERIES].contiguous(), k,
                               exclude=own, matmul_precision=graph_precision)

    # their times at m = 1000 beside their bounds; library calls at m = 100
    n_seg = -(-DEEP_N // seg)
    peak_ops = {"f32": PEAK_FP32, "bf16": PEAK_BF16, "int8": PEAK_INT8}
    item = {"f32": 4, "bf16": 2, "int8": 1}
    ten_m = {}
    for label, pts, sc in types:
        q_lib = kernel_queries(pts, y100, sc)
        xf = pts.float()  # the library's float corpus, made once as a server would keep it
        pn = (xf * xf).sum(-1)
        lib_ms = cuda_ms(lambda: seg_min_scores(pn - 2.0 * (q_lib @ xf.T), seg), reps=3)
        del xf, pn
        emit_ms = cuda_ms(lambda: tp.segment_minima(pts, Y, seg, scale=sc), reps=5)
        emit100_ms = cuda_ms(lambda: tp.segment_minima(pts, y100, seg, scale=sc), reps=5)
        emit_plain_ms = cuda_ms(lambda: tp.segment_minima_plain(pts, Y, seg, scale=sc),
                                reps=1, warmup=0)
        e_b = bound(0.0, item[label] * DEEP_N * DEEP_D + 4.0 * M * DEEP_D + 8.0 * M * n_seg)
        e_b = max(e_b, (1e3 * 2.0 * M * DEEP_N * DEEP_D / peak_ops[label], "operations"))
        starts = window_starts(pts, Y, P, seg, scale=sc)
        qk = kernel_queries(pts, Y, sc)
        res_ms = cuda_ms(lambda: tp.rescan_windows(pts, qk, starts, seg, k), reps=10)
        res_plain_ms = cuda_ms(lambda: tp.rescan_windows_plain(pts, qk, starts, seg, k), reps=1)
        pairs, distinct = rescan_rows(starts, DEEP_N, seg)
        r_b = bound(3.0 * pairs * DEEP_D, item[label] * distinct * DEEP_D
                    + 4.0 * (M * DEEP_D + M * P) + 8.0 * M * k)
        two_ms = cuda_ms(lambda: tp.exact_knn_twophase(pts, Y, k, scale=sc), reps=5)
        rank_ms = cuda_ms(lambda: ex.exact_knn(pts, Y, k, scale=sc), reps=5)
        ten_m[label] = two_ms / rank_ms
        phase("kernel", f"time emit 10M x {DEEP_D} {label} m={M} seg={seg}: {emit_ms:.3f} ms "
                        f"(m=100 {emit100_ms:.3f} ms), plain {emit_plain_ms:.3f} ms, bound "
                        f"{e_b[0]:.3f} ms ({e_b[1]}), library segment min at m=100 "
                        f"{lib_ms:.3f} ms; rescan P={P} k={k} {res_ms:.3f} ms, plain "
                        f"{res_plain_ms:.3f} ms, bound {r_b[0]:.3f} ms ({r_b[1]}; {pairs} pairs "
                        f"over {distinct} distinct rows); exact_knn_twophase {two_ms:.3f} ms, "
                        f"rank kernel {rank_ms:.3f} ms; card [{smi}]")
        rows_out["twophase_emit"].append(at_scale_row(
            f"10M x {DEEP_D} {label} m={M} seg={seg} (library at m=100)", emit_ms,
            emit_plain_ms, e_b, lib_ms, errs["emit", label], ms_m100=emit100_ms))
        rows_out["twophase_rescan"].append(at_scale_row(
            f"10M x {DEEP_D} {label} m={M} P={P} seg={seg} k={k}", res_ms, res_plain_ms, r_b,
            None, errs["rescan", label]))
    rank_ms = cuda_ms(lambda: ex.exact_knn(X, Y, k), reps=5)
    rank100_ms = cuda_ms(lambda: ex.exact_knn(X, y100, k), reps=5)
    rank100_plain_ms = cuda_ms(lambda: ex.exact_knn_plain(X, y100, k), reps=1, warmup=0)
    rank100_lib_ms = cuda_ms(lambda: torch.topk((X * X).sum(-1) - 2.0 * (y100 @ X.T), k,
                                                largest=False), reps=3)
    rank_b = bound(2.0 * M * DEEP_N * DEEP_D, 4.0 * (DEEP_N * DEEP_D + M * DEEP_D) + 8.0 * M * k)
    phase("kernel", f"time rank 10M x {DEEP_D} f32 m={M} k={k}: {rank_ms:.3f} ms, bound "
                    f"{rank_b[0]:.3f} ms ({rank_b[1]}); at m=100 {rank100_ms:.3f} ms, plain "
                    f"{rank100_plain_ms:.3f} ms, library topk {rank100_lib_ms:.3f} ms")
    rows_out["exact_knn"].append(at_scale_row(
        f"10M x {DEEP_D} f32 m={M} k={k} (plain and library at m=100)", rank_ms,
        rank100_plain_ms, rank_b, rank100_lib_ms, errs["rank"], ms_m100=rank100_ms))
    hopper_emit(Xb, Y, seg, errs["emit", "bf16"], rows_out, smi)
    del Xb, X8, starts, qk
    torch.cuda.empty_cache()

    # 3. the hash route: one graph chunk alone at each tier, then the build
    excl = torch.arange(GRAPH_CHUNK, dtype=torch.int32, device=dev)
    n_chunks = -(-DEEP_N // GRAPH_CHUNK)
    chunk = {tier: cuda_ms(lambda: ex.exact_knn(X, X[:GRAPH_CHUNK], k, exclude=excl,
                                                matmul_precision=tier), reps=1, warmup=0)
             for tier in TIER_FLOORS}
    flop = 2.0 * GRAPH_CHUNK * DEEP_N * DEEP_D
    chunk_b = bound(flop, 4.0 * (DEEP_N * DEEP_D + GRAPH_CHUNK * (DEEP_D + 1))
                    + 8.0 * GRAPH_CHUNK * k)
    if graph_precision != "highest":
        chunk_b = (1e3 * BF16_PASSES[graph_precision] * flop / PEAK_BF16, "operations")
    phase("deep10m", f"graph chunk n={DEEP_N} d={DEEP_D} m={GRAPH_CHUNK} k={k} exclude=self: "
                     + ", ".join(f"{t} {ms:.1f} ms (x {n_chunks} chunks = {ms * n_chunks / 1e3:.1f}"
                                 " s)" for t, ms in chunk.items())
                     + f"; bound at {graph_precision} {chunk_b[0]:.3f} ms; card [{smi}]")
    rows_out["exact_knn"].append(at_scale_row(
        f"graph chunk 10M x {DEEP_D} m={GRAPH_CHUNK} k={k} {graph_precision}",
        chunk[graph_precision], None, chunk_b, None, errs["graph"]))
    ex.reset_launch_counts()
    stages = StageTimes(memory=True)
    t0 = time.perf_counter()
    srv = ann.Server.build(X, k, layout="packed", packed_dtype=torch.int8, window=96,
                           tries=DEEP_TRIES, capacity=DEEP_CAPACITY, seed=seed,
                           graph_precision=graph_precision, stage_times=stages)
    fence()
    build_s = time.perf_counter() - t0
    desc = srv.describe()
    pv = srv.packed
    if desc["mode"] != "hash" or desc["layout"] != "packed" or pv.tries != DEEP_TRIES:
        raise AssertionError(f"deep10m Server auto f32: {desc}, not hash packed")
    counts = read_counts(f"deep10m hash build graph_precision={graph_precision}", ("exact_knn",))
    tier_key = f"exact_knn:{graph_precision}"
    if graph_precision != "highest" and counts[tier_key] != counts["exact_knn"]:
        raise AssertionError("deep10m build: a graph chunk ran another tier")
    phase("deep10m", f"Server.build auto f32 n={DEEP_N} d={DEEP_D} k={k} tries={DEEP_TRIES} "
                     f"capacity={DEEP_CAPACITY} packed int8 w=96 super_width {pv.super_width} "
                     f"graph_precision={graph_precision}: mode {desc['mode']}, layout "
                     f"{desc['layout']}, d_short {pv.d_short}, tmax {srv.index.tmax}, n_pad "
                     f"{pv.n_pad}, index_mb {desc['index_mb']}; {build_s:.2f} s; stages "
                     + ", ".join(f"{name} {stages.totals[name]:.2f} s (peak "
                                 f"{gib(stages.peaks[name])})" for name in stages.totals)
                     + f"; card [{smi}]")
    g_rows = torch.randperm(DEEP_N, generator=torch.Generator().manual_seed(seed + 8))[
        :DEEP_GRAPH_ROWS].to(dev)
    reset_peak()
    tier_ok = graph_rows_ok(X, srv.index.graph, g_rows, k, graph_precision,
                            1e-6 if graph_precision == "highest" else 1e-5)
    raw_ok = (tier_ok if graph_precision == "highest"
              else graph_rows_ok(X, srv.index.graph, g_rows, k, "highest", 1e-6))
    phase("deep10m", f"exact graph on {DEEP_GRAPH_ROWS} sampled rows: edges within the "
                     f"{graph_precision} tier's float64 oracle up to ties {tier_ok:.6f}, within "
                     f"the raw float64 oracle (rtol 1e-6) {raw_ok:.6f}; peak "
                     f"{gib(read_peak())}")
    if tier_ok != 1.0:
        raise AssertionError(f"deep10m exact graph disagrees with its oracle: {tier_ok}")

    # every packed serving point of the configuration from this view
    ex.reset_launch_counts()
    recs = {}
    for w, n_probes, rr in DEEP_POINTS:
        kw = dict(window=w, n_probes=n_probes, rerank_width=rr)
        reset_peak()
        before = ex.launches["probe_topk"]
        search = (lambda q, kw=kw: srv.search(q, **kw))
        qps = {b: qps_at(search, Y, b) for b in DEEP_BATCHES}
        ids, _ = search(Y)
        rec = recall_at_k(truth, ids.cpu().numpy(), k)
        recs[w, n_probes, rr] = rec
        launched = ex.launches["probe_topk"] - before
        phase("deep10m", f"Server packed int8 w={w} P={n_probes} rerank={rr}: recall@{k} "
                         f"{rec:.4f}; pipelined QPS "
                         + ", ".join(f"batch {b} {q:.1f}" for b, q in qps.items())
                         + f"; probe_topk launches {launched}; peak {gib(read_peak())}; "
                         f"card [{smi}]")
        if not launched:
            raise AssertionError(f"deep10m packed w={w} P={n_probes}: the probe did not run")
    read_counts("deep10m packed serving", ("probe_topk",))
    if recs[96, 18, None] < RECALL_GUARD:
        raise AssertionError(f"deep10m packed recall@10 {recs[96, 18, None]:.4f} at window 96 "
                             f"is below the {RECALL_GUARD} guard")
    qs = Y / pv.scale  # the fused path's int8 queries
    kw = dict(n=pv.live_bound, n_pad=pv.n_pad, window=96)
    for n_probes in (18, 48):
        starts = probe_starts(pv, Y, n_probes, 96)
        err = check_probe(f"10M int8 tries={DEEP_TRIES} m={M} P={n_probes} w=96 k={k}",
                          pv.point_rows, qs, starts, k=k, **kw)
        ms = cuda_ms(lambda: pr.probe_topk(pv.point_rows, qs, starts, k=k, **kw), reps=10)
        q_, st_, w_ = pr.prepare(pv.point_rows, qs, starts, n_pad=pv.n_pad, window=96)
        plain_ms = cuda_ms(lambda: pr.probe_topk_plain(pv.point_rows, q_, st_, k=k,
                                                       n=pv.live_bound, n_pad=pv.n_pad,
                                                       window=w_), reps=1)
        triples, distinct = probe_work(st_, w_)
        b = bound(3.0 * DEEP_D * triples, 1.0 * DEEP_D * distinct
                  + 4.0 * (M * DEEP_D + st_.numel()) + 8.0 * M * DEEP_TRIES * k)
        phase("kernel", f"time probe 10M int8 tries={DEEP_TRIES} m={M} P={n_probes} w={w_} "
                        f"k={k}: kernel {ms:.3f} ms plain {plain_ms:.3f} ms; {triples} distinct "
                        f"(query, table, slot) triples over {distinct} distinct rows; bound "
                        f"{b[0]:.3f} ms ({b[1]}); card [{smi}]")
        rows_out["probe_topk"].append(at_scale_row(
            f"10M x {DEEP_D} int8 tries={DEEP_TRIES} m={M} P={n_probes} w={w_} k={k}", ms,
            plain_ms, b, None, err))
    # the card against the same search on the CPU, the view carried by
    # to_numpy_dict / from_numpy
    sub = slice(0, CPU_CHECK_QUERIES)
    ids, dd = ann.search_packed_fused(pv, queries=Y[sub], n_probes=18)
    t0 = time.perf_counter()
    cpu_view = ann.PackedIndex.from_numpy(pv.to_numpy_dict(), device="cpu")
    carry_s = time.perf_counter() - t0
    c_ids, c_d = ann.search_packed_fused(cpu_view, queries=Y[sub].cpu(), n_probes=18)
    del cpu_view
    n_cmp, n_tied = compare_with_cpu("deep10m packed search", pv, Y[sub], ids, dd, c_ids, c_d)
    phase("deep10m", f"card vs CPU search_packed_fused int8 w=96 P=18 on {CPU_CHECK_QUERIES} "
                     f"queries (view carried in {carry_s:.2f} s): {n_cmp} rows compared, ids "
                     f"equal outside near-ties ({n_tied} near-tie rows), distances rtol 1e-5")
    del srv, pv, X, Y, Y64, qs, starts, q_, st_
    torch.cuda.empty_cache()

    # 4. the int8 route's edge: 32M x 96 drawn on the card, exact two-phase
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    X = torch.empty((EDGE_N, DEEP_D), device=dev)
    for lo in range(0, EDGE_N, 1 << 22):
        X[lo: lo + (1 << 22)] = torch.randn(min(1 << 22, EDGE_N - lo), DEEP_D, generator=gen,
                                            device=dev)
    Y = torch.randn(M, DEEP_D, generator=gen, device=dev)
    yr = Y[:EDGE_RECALL_QUERIES].contiguous()
    true_e = oracle64_chunked(X, yr, k)
    ex.reset_launch_counts()
    reset_peak()
    srv = ann.Server.build(X, k, storage_dtype=torch.int8)
    desc = srv.describe()
    if desc["mode"] != "exact" or desc["exact_engine"] != "cuda-twophase":
        raise AssertionError(f"deep10m Server int8 n={EDGE_N}: {desc}")
    ids, _ = srv.search(yr)
    rec, tie = recall_up_to_ties(X, yr.double(), ids, true_e, k)
    build_peak = read_peak()
    del X
    torch.cuda.empty_cache()
    reset_peak()
    qps = qps_at(srv.search, Y, M)
    read_counts(f"deep10m Server int8 n={EDGE_N}", ("twophase_emit", "twophase_rescan"))
    phase("deep10m", f"Server.build storage_dtype=int8 n={EDGE_N} d={DEEP_D} k={k}: describe() "
                     f"mode {desc['mode']} exact_engine {desc['exact_engine']}; recall@{k} on "
                     f"{EDGE_RECALL_QUERIES} queries vs the float64 oracle {rec:.4f} (up to ties "
                     f"{tie:.4f}); pipelined QPS batch {M} {qps:.1f}; peak with the float32 "
                     f"corpus {gib(build_peak)}, serving after it was freed "
                     f"{gib(read_peak())}; card [{smi}]")
    X8, sc = srv.points, srv.scale
    y16 = Y[:EDGE_CHECK_QUERIES].contiguous()
    seg32 = tp.auto_seg(EDGE_N)
    e_err = check_emit(f"{EDGE_N} x {DEEP_D} int8 ({X8.numel()} bytes) m={EDGE_CHECK_QUERIES} "
                       f"seg={seg32}", X8, y16, seg32, scale=sc)
    r_err = check_rescan(f"{EDGE_N} x {DEEP_D} int8 m={EDGE_CHECK_QUERIES} P={P} seg={seg32} "
                         f"k={k}", X8, kernel_queries(X8, y16, sc),
                         window_starts(X8, y16, P, seg32, scale=sc), seg32, k)
    n_seg = -(-EDGE_N // seg32)
    emit_ms = cuda_ms(lambda: tp.segment_minima(X8, Y, seg32, scale=sc), reps=3)
    emit16_ms = cuda_ms(lambda: tp.segment_minima(X8, y16, seg32, scale=sc), reps=3)
    emit16_plain_ms = cuda_ms(lambda: tp.segment_minima_plain(X8, y16, seg32, scale=sc),
                              reps=1, warmup=0)
    e_b = max(bound(0.0, 1.0 * EDGE_N * DEEP_D + 4.0 * M * DEEP_D + 8.0 * M * n_seg),
              (1e3 * 2.0 * M * EDGE_N * DEEP_D / PEAK_INT8, "operations"))
    starts = window_starts(X8, Y, P, seg32, scale=sc)
    qk = kernel_queries(X8, Y, sc)
    res_ms = cuda_ms(lambda: tp.rescan_windows(X8, qk, starts, seg32, k), reps=10)
    res_plain_ms = cuda_ms(lambda: tp.rescan_windows_plain(X8, qk, starts, seg32, k), reps=1)
    pairs, distinct = rescan_rows(starts, EDGE_N, seg32)
    r_b = bound(3.0 * pairs * DEEP_D, 1.0 * distinct * DEEP_D + 4.0 * (M * DEEP_D + M * P)
                + 8.0 * M * k)
    phase("kernel", f"time emit {EDGE_N} x {DEEP_D} int8 m={M} seg={seg32}: {emit_ms:.3f} ms "
                    f"(m={EDGE_CHECK_QUERIES} {emit16_ms:.3f} ms, plain {emit16_plain_ms:.3f} "
                    f"ms), bound {e_b[0]:.3f} ms ({e_b[1]}); rescan P={P} k={k} {res_ms:.3f} ms, "
                    f"plain {res_plain_ms:.3f} ms, bound {r_b[0]:.3f} ms ({r_b[1]}); card [{smi}]")
    rows_out["twophase_emit"].append(at_scale_row(
        f"{EDGE_N} x {DEEP_D} int8 m={M} seg={seg32} (plain at m={EDGE_CHECK_QUERIES})",
        emit_ms, emit16_plain_ms, e_b, None, e_err, ms_m16=emit16_ms))
    rows_out["twophase_rescan"].append(at_scale_row(
        f"{EDGE_N} x {DEEP_D} int8 m={M} P={P} seg={seg32} k={k}", res_ms, res_plain_ms, r_b,
        None, r_err))
    del srv, X8, Y, yr, y16, starts, qk
    torch.cuda.empty_cache()

    # 5. rank against two-phase at 8M x 128 (drawn on the card) and 10M x 96
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    Xf = torch.randn(8 * N, 128, generator=gen, device=dev)
    ratios = dict(ratios or {})
    for label, Xs in (("f32", Xf), ("bf16", Xf.to(torch.bfloat16))):
        ratios[label, 8 * N] = crossover_ratio(label, Xs, Y128, k)
    del Xf, Xs
    for label in ("f32", "bf16"):
        ratios[label, DEEP_N] = ten_m[label]
        phase("crossover", f"{label} n={DEEP_N} d={DEEP_D} m={M} k={k} seg={seg}: two-phase/rank "
                           f"{ten_m[label]:.3f} (the deep10m kernel lines)")
    twophase_rule(ratios)
    torch.cuda.empty_cache()
    return rows_out


def merge_paths(srv, serve, results, read_counts, X, Y) -> None:
    """Path 3b (phase ``merge``): the f32 exact server with the rank
    kernel, the rescan merge and the stream pinned, in f32 and with bf16
    compute; each with the launch counts set to 0 just before it."""
    exact_keys = ("exact_knn", "exact_knn_rescan", "exact_knn_stream", "twophase_emit",
                  "twophase_rescan", "twophase_rescan_all")
    rank_ids = None
    for cdt in (None, torch.bfloat16):
        for label, kw, kernel in (("no_twophase", {"no_twophase": True}, "rank"),
                                  ("merge=rescan", {"merge": "rescan"}, "rescan"),
                                  ("stream", {"stream": True}, "stream")):
            if cdt is not None:
                kw = dict(kw, compute_dtype=cdt)
                label += " compute_dtype=bf16"
            key = VARIANTS[kernel][2]
            desc = srv.describe(**kw)
            if desc["exact_engine"] != f"cuda-{kernel}":
                raise AssertionError(f"describe({kw}) names {desc['exact_engine']}")
            ex.reset_launch_counts()
            tag = f"f32 {label} (cuda-{kernel}, streams {desc['compute_dtype']})"
            ids = serve(tag, srv, name="merge", **kw)
            counts = read_counts(f"Server {label}", (key,))
            stray = [name for name in exact_keys if name != key and counts[name]]
            if stray:
                raise AssertionError(f"Server {label} also launched {stray}")
            if cdt is not None:
                continue
            if results[tag][2] != 1.0:
                raise AssertionError(f"{tag}: recall up to ties {results[tag][2]}, not 1.0")
            if kernel == "rank":
                rank_ids = ids
                continue
            bad = torch.nonzero(ids != rank_ids)
            if bad.numel():
                pairs = torch.stack([bad[:, 0], ids[bad[:, 0], bad[:, 1]]], 1)
                if not near_tie_ok(X, Y, pairs, rank_ids[bad[:, 0], bad[:, 1]]):
                    raise AssertionError(f"{tag}: ids differ from the rank kernel's "
                                         "outside near-ties")
            phase("merge", f"{tag}: ids equal to the rank kernel's outside near-ties "
                           f"({bad.shape[0]} near-tie positions)")


def packed_serving(seed: int, dev, read_counts):
    """Path 4: the SIFT-1M stand-in served through ``Server(mode="hash",
    layout="packed")``.  Returns (the bf16 server, its queries, the probe
    kernel's max error, (kernel, plain, library) ms, (bound ms, bound_by))
    at the main shape."""
    rng = np.random.default_rng(seed)
    Xc_np = clustered_gaussian(rng, N, 128, n_clusters=N_CLUSTERS)
    # queries as the JAX package's stand-ins draw them (data/datasets.py)
    Yc_np = Xc_np[rng.integers(0, N, M)] + 0.1 * gaussian(rng, M, 128)
    Xc = torch.from_numpy(Xc_np).to(dev)
    Yc = torch.from_numpy(Yc_np.astype(np.float32)).to(dev)
    del Xc_np
    truth = oracle64(Xc.double(), Yc.double(), 10)[0].cpu().numpy()
    k = 10

    ex.reset_launch_counts()
    t0 = time.perf_counter()
    srv = ann.Server.build(Xc, k, mode="hash", layout="packed", window=PACKED_WINDOW,
                           packed_dtype=torch.bfloat16, n_probes=PACKED_PROBES,
                           tries=10, capacity="auto", seed=seed)
    fence()
    build_s = time.perf_counter() - t0
    pv = srv.packed
    phase("packed", f"build n={N} d=128 clusters={N_CLUSTERS} k={k} tries=10 "
                    f"d_short={pv.d_short} tmax={srv.index.tmax}: {build_s:.2f} s "
                    f"(exact graph + bf16 pack); n_pad {pv.n_pad}, "
                    f"index_mb {srv.describe()['index_mb']}")

    def serve(label, s, **kw):
        s.search(Yc, **kw)  # warm-up
        fence()
        before = ex.launches["probe_topk"]
        reps = 20
        t0 = time.perf_counter()
        outs = [s.search(Yc, **kw) for _ in range(reps)]
        fence()
        qps = M * reps / (time.perf_counter() - t0)
        ids, dd = outs[-1]
        real = ids < s.packed.n
        if ids.shape != (M, k) or not torch.isfinite(dd[real]).all() or not real.all():
            raise AssertionError(f"packed {label}: bad result")
        rec = recall_at_k(truth, ids.cpu().numpy(), k)
        phase("packed", f"Server packed {label} n={N} m={M}: layout "
                        f"{s.describe()['layout']}, pipelined {qps:.1f} QPS, recall@10 "
                        f"{rec:.4f}, probe_topk launches {ex.launches['probe_topk'] - before}")
        if ex.launches["probe_topk"] == before:
            raise AssertionError(f"packed {label}: the probe kernel did not run")
        return ids, dd, rec

    ids, dd, rec = serve(f"bf16 w={PACKED_WINDOW} P={PACKED_PROBES}", srv)
    if rec < RECALL_GUARD:
        raise AssertionError(f"recall@10 {rec:.4f} at window {PACKED_WINDOW} is below "
                             f"the {RECALL_GUARD} guard")
    serve(f"bf16 w=192 P={PACKED_PROBES} rerank={RERANK}", srv, window=192,
          rerank_width=RERANK)
    for label, dt in (("f32", torch.float32), ("int8", torch.int8)):
        view = dataclasses.replace(srv, packed=srv.index.packed(window=PACKED_WINDOW,
                                                                dtype=dt))
        serve(f"{label} w={PACKED_WINDOW} P={PACKED_PROBES}", view)
        del view
    read_counts("packed serving", ("exact_knn", "probe_topk"))

    # the kernel against its plain version at the main shape (launches here
    # are not counted on the path)
    starts = probe_starts(pv, Yc, PACKED_PROBES, PACKED_WINDOW)
    kw = dict(n=pv.live_bound, n_pad=pv.n_pad, window=PACKED_WINDOW)
    err = check_probe(f"main shape n={N} m={M} tries=10 P={PACKED_PROBES} "
                      f"w={PACKED_WINDOW} k=10 bf16", pv.point_rows, Yc, starts, k=10, **kw)
    check_probe(f"main shape k={RERANK}", pv.point_rows, Yc, starts, k=RERANK, **kw)
    kern_ms = cuda_ms(lambda: pr.probe_topk(pv.point_rows, Yc, starts, k=10, **kw), reps=20)
    gather_sweep(f"probe bf16 n={N} m={M} tries=10 P={PACKED_PROBES} k=10 pair design "
                 "(warps a pair, G)",
                 lambda geom, wpp: pairs_probe(pv.point_rows, Yc, starts, k=10, geometry=geom,
                                               warps_per_pair=wpp, **kw),
                 128, 2, extra=(1, 2, 4, 8))
    probe_designs(pv, Xc, rng)
    q, st, w = pr.prepare(pv.point_rows, Yc, starts, n_pad=pv.n_pad, window=PACKED_WINDOW)
    plain_ms = cuda_ms(lambda: pr.probe_topk_plain(pv.point_rows, q, st, k=10, n=pv.live_bound,
                                                   n_pad=pv.n_pad, window=w), reps=3)
    triples, rows = probe_work(st, w)
    b = bound(3.0 * 128 * triples,
              2.0 * 128 * rows + 4.0 * (M * 128 + st.numel()) + 8.0 * M * pv.tries * 10)
    phase("kernel", f"time probe n={N} m={M} tries=10 P={PACKED_PROBES} w={w} k=10 bf16: "
                    f"kernel {kern_ms:.3f} ms plain {plain_ms:.3f} ms; {triples} distinct "
                    f"(query, table, slot) triples over {rows} distinct rows; bound "
                    f"{b[0]:.3f} ms ({b[1]}); effective L2 read rate (triples x row bytes / "
                    f"kernel time) {triples * 256 / kern_ms / 1e9:.3f} TB/s")

    # the card against the same search on the CPU (plain probe), the view
    # moved through PackedIndex.from_numpy
    sub = slice(0, CPU_CHECK_QUERIES)
    cpu_view = ann.PackedIndex.from_numpy(pv.to_numpy_dict(), device="cpu")
    c_ids, c_d = ann.search_packed_fused(cpu_view, queries=Yc[sub].cpu(),
                                         n_probes=PACKED_PROBES)
    del cpu_view
    n_cmp, n_tied = compare_with_cpu("packed search", pv, Yc[sub], ids[sub], dd[sub],
                                     c_ids, c_d)
    phase("packed", f"card vs CPU search_packed_fused on {CPU_CHECK_QUERIES} queries: "
                    f"{n_cmp} rows compared, ids equal outside near-ties ({n_tied} "
                    f"near-tie rows), distances rtol 1e-5")
    return srv, Yc, err, (kern_ms, plain_ms, None), b


def probe_designs(pv, Xc, rng) -> None:
    """The probe kernel's two designs at the main shape (bf16 rows, tries =
    10, 18 probes, window 96, k = 10) side by side at m = 1000 (the kernel
    table's), the hash cell's 10,000 and on each side of
    ``TILES_MIN_M``, on queries drawn as the phase draws them, each time
    the least of three rounds.  The design ``probe_design`` routes to must
    not be the slower one at any of them, and the two designs' ids agree
    outside near-ties at 10,000."""
    sizes = sorted({pr.TILES_MIN_M // 2, pr.TILES_MIN_M, M, PROBE_DESIGN_M})
    pick = torch.from_numpy(rng.integers(0, N, sizes[-1])).to(Xc.device)
    noise = gaussian(rng, sizes[-1], 128).astype(np.float32)
    Y = Xc[pick] + 0.1 * torch.from_numpy(noise).to(Xc.device)
    starts = probe_starts(pv, Y, PACKED_PROBES, PACKED_WINDOW)
    kw = dict(n=pv.live_bound, n_pad=pv.n_pad, window=PACKED_WINDOW)
    rows = pv.point_rows
    ia, _ = tiles_probe(rows, Y, starts, k=10, **kw)
    ib, db = pairs_probe(rows, Y, starts, k=11, **kw)
    fence()
    ok, tied = ids_agree(ia.reshape(-1, 10).cpu(), ib[..., :10].reshape(-1, 10).cpu(),
                         db.reshape(-1, 11).cpu(), rtol=1e-5)
    if not ok:
        raise AssertionError("the probe kernel's two designs disagree outside near-ties")
    # the least of three rounds, the sizes and designs in turn: one round
    # can meet the card's clocks still rising after the host's work
    ms = {m: [float("inf")] * 2 for m in sizes}
    for _ in range(3):
        for m in sizes:
            ym, sm = Y[:m].contiguous(), starts[:m].contiguous()
            reps = 20 if m <= M else 10
            for j, launch in enumerate((pairs_probe, tiles_probe)):
                t = cuda_ms(lambda: launch(rows, ym, sm, k=10, **kw), reps=reps)
                ms[m][j] = min(ms[m][j], t)
    routed = {m: pr.probe_design(rows.dtype, m, pv.tries, PACKED_PROBES, 128, 10)
              for m in sizes}
    phase("kernel", f"probe designs n={N} bf16 tries=10 P={PACKED_PROBES} w={PACKED_WINDOW} "
                    f"k=10 (pairs / tiles, ms, routed *): "
                    + ", ".join(f"m={m} {a:.3f} / {b:.3f} *{routed[m][0].upper()}"
                                for m, (a, b) in ms.items())
                    + f"; ids agree at m={sizes[-1]} ({tied} near-tie rows)")
    for m, times in ms.items():
        mine = times[("pairs", "tiles").index(routed[m])]
        if mine > min(times):
            raise AssertionError(f"the probe kernel at m = {m} routes to the {routed[m]} "
                                 f"design, the slower one ({times[0]:.3f} ms pairs, "
                                 f"{times[1]:.3f} ms tiles)")


def pairs_probe(rows, queries, starts, *, k: int, n: int, n_pad: int, window: int,
                **launch):
    """The probe kernel's pair design (``ops/probe.py:_probe_pairs``)
    whatever ``probe_design`` routes, ``launch`` its geometry: how
    ``probe_designs`` and the geometry sweep read it.  Returns (slots,
    distances)."""
    q, st, w = pr.prepare(rows, queries, starts, n_pad=n_pad, window=window)
    return pr._probe_pairs(rows, q, st, k=k, n=n, n_pad=n_pad, window=w, **launch)


def tiles_probe(rows, queries, starts, *, k: int, n: int, n_pad: int, window: int):
    """The probe kernel's tile design (``ops/probe.py:_probe_tiles``)
    whatever ``probe_design`` routes: how ``probe_designs`` reads the side
    of the gate the rule leaves to the pair design."""
    q, st, w = pr.prepare(rows, queries, starts, n_pad=n_pad, window=window)
    return pr._probe_tiles(rows, q, st, k=k, n=n, n_pad=n_pad, window=w)


def tune_phase(Xc, Yc, seed: int, read_counts) -> None:
    """``ann.tune`` on the packed phase's corpus and queries (k = 10, tries
    = 10, target recall 0.9, measured, batch 1000, bf16 packed rows, the
    ``TUNE_GRID``; ``measure_all`` times every trial, so each line has its
    QPS): every trial's ``as_dict()`` and the winner.  Every
    packed trial must take the probe kernel ("fused"), the tune must launch
    the rank kernel (oracle, graph, exact trials) and the probe kernel, and
    ``report.server()`` must serve the winner at its recall within
    ``TUNE_SERVER_TOL``."""
    ex.reset_launch_counts()
    t0 = time.perf_counter()
    rep = ann.tune(Xc, 10, queries=Yc, batch=M, target_recall=TUNE_TARGET, measure=True,
                   measure_all=True, tries=10, capacity="auto", seed=seed,
                   packed_dtype=torch.bfloat16, **TUNE_GRID)
    fence()
    tune_s = time.perf_counter() - t0
    for t in rep.trials:
        phase("tune", f"trial {json.dumps(t.as_dict())}")
    phase("tune", f"winner {json.dumps(rep.best.as_dict())}; n={N} m={M} k=10 tries=10 "
                  f"target {TUNE_TARGET}, measured {rep.measured}, batch {rep.batch}, "
                  f"{len(rep.trials)} trials in {tune_s:.2f} s (build and pack included)")
    packed = [t for t in rep.trials if t.engine == "packed"]
    if not rep.measured or rep.best.qps is None:
        raise AssertionError("tune on the card did not time its trials")
    if not packed or any(t.knobs["path"] != "fused" for t in packed):
        raise AssertionError("a packed trial did not take the probe kernel: "
                             f"{[t.knobs['path'] for t in packed]}")
    truth = ann.exact_search(Xc, Yc, 10)[0].cpu().numpy()
    srv = rep.server()
    ids, dd = srv.search(Yc)
    fence()
    rec = recall_at_k(truth, ids.cpu().numpy(), 10)
    phase("tune", f"report.server(): {srv.describe()}; recall@10 {rec:.4f} against the "
                  f"trial's {rep.best.recall:.4f}")
    if ids.shape != (M, 10) or abs(rec - rep.best.recall) > TUNE_SERVER_TOL:
        raise AssertionError(f"report.server() serves recall {rec} against the winner's "
                             f"{rep.best.recall}")
    del srv, rep
    read_counts("tune", ("exact_knn", "probe_topk"))


def run_cli(name: str, label: str, main, argv) -> str:
    """Run a harness CLI's ``main(argv)``, print its output under
    ``[name]``, fail on a non-zero exit; return the output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    for line in out.strip().splitlines():
        phase(name, f"{label}: {line}")
    if rc != 0:
        raise AssertionError(f"{label} {' '.join(argv)} exited {rc}")
    return out


def harness_phase(seed: int, read_counts) -> None:
    """The reference-shaped CLIs on the card: ``test_correctness`` in index
    and query mode ("Prob correct" >= 0.8), ``time_results``, and
    ``ann_bench`` on the synthetic gaussian-100k stand-in served through the
    probe kernel (one JSON line; recall@10 held to ``RECALL_GUARD``)."""
    ex.reset_launch_counts()
    sd = ["--seed", str(seed)]
    for label, extra in (("index", []), ("query -y 20", ["-y", "20"])):
        out = run_cli("harness", f"test_correctness {label}", test_correctness.main,
                      ["-n", "2000", "-d", "32", "-k", "10", "-t", "6", "-o", "3", *sd, *extra])
        prob = float(out.split("Prob correct: ")[1].split(".\n")[0])
        if prob < 0.8:
            raise AssertionError(f"test_correctness {label}: Prob correct {prob} < 0.8")
    run_cli("harness", "time_results", time_results.main,
            ["-n", "2000", "-d", "32", "-o", "3", *sd])
    # no dataset files are staged: the synthetic stand-in, nothing written
    os.environ.setdefault("ANN_TPU_DATA", os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "datasets"))
    out = run_cli("harness", "ann_bench", ann_bench.main,
                  ["--dataset", "gaussian-100k", "--k", "10", "--tries", "10", "--packed",
                   "--fused", "--packed-dtype", "bf16", "--n-probes", str(PACKED_PROBES),
                   "--window", str(PACKED_WINDOW), "--max-queries", str(M)])
    rec = json.loads(out.strip().splitlines()[-1])
    if (rec["layout"] != "packed-fused" or rec["device"] != torch.cuda.get_device_name(0)
            or not rec["qps"] > 0 or rec["recall_at_k"] < RECALL_GUARD):
        raise AssertionError(f"ann_bench: bad record {rec}")
    read_counts("harness", ("exact_knn", "probe_topk"))


def parity_band(read_counts) -> None:
    """``compare_results`` card against CPU at the JAX package's TPU gate
    (n = 2000, d = 64, k = 10, tries 4, one sample, seed 11): one
    ``--arbitrate`` run for the diff ids' attribution (tie_f64, tie_f32,
    real), then the gate with ``--max-diff-frac 0.0005``, which must exit
    0."""
    ex.reset_launch_counts()
    run_cli("parity_band", "compare_results --arbitrate", compare_results.main,
            PARITY_ARGS + ["--arbitrate"])
    run_cli("parity_band", f"compare_results --max-diff-frac {PARITY_BAND}",
            compare_results.main, PARITY_ARGS + ["--max-diff-frac", PARITY_BAND])
    phase("parity_band", f"graph diffs card vs CPU within the band {PARITY_BAND}: ok")
    read_counts("parity_band", ("exact_knn",))


def updates(srv, Yc, seed: int, dev, read_counts) -> None:
    """Updates on the packed server: remove 1% of the ids (none may come
    back), add 10,000 points drawn from the mixture's centre distribution
    (each must find itself at distance 0); the re-packed view must still
    run the probe kernel.  The path must launch every kernel it runs: the
    probe, and the kernels of the exact rows' search (``add_points`` asks
    ``exact_search`` for k + 1 + the tombstones); then the same
    ``add_points`` replayed on a copy of the server taken before it, under
    ``torch.profiler``, split by stage and by kernel."""
    ex.reset_launch_counts()
    n0 = srv.packed.n
    g = torch.Generator(device="cpu").manual_seed(seed + 2)
    ids, _ = srv.search(Yc)
    top = torch.unique(ids[:, 0].cpu().long())
    perm = torch.randperm(n0, generator=g)
    victims = torch.cat([top, perm[~torch.isin(perm, top)][: N_REMOVE - top.numel()]])
    t0 = time.perf_counter()
    srv.remove_points(victims.to(dev))
    fence()
    rm_s = time.perf_counter() - t0
    vic = victims.to(dev)
    ids, _ = srv.search(Yc)
    if torch.isin(ids.long(), vic).any():
        raise AssertionError("a removed id came back")
    new = torch.from_numpy(4.0 * gaussian(np.random.default_rng(seed + 3), N_ADD, 128)).to(dev)
    # the exact rows' request and the engine exact_search routes it to
    kk = min(srv.index.k + 1 + int(srv.index.dead.sum()), n0 + N_ADD)
    engine = tp.route(n0 + N_ADD, kk, ())
    before = dataclasses.replace(srv)  # add_points replaces the server's fields
    t0 = time.perf_counter()
    srv.add_points(new)
    fence()
    add_s = time.perf_counter() - t0
    found = 0
    for lo in range(0, N_ADD, M):
        ids, dd = srv.search(new[lo: lo + M])
        own = n0 + lo + torch.arange(ids.shape[0], device=dev)
        found += int(((ids[:, 0] == own) & (dd[:, 0] == 0)).sum())
        if torch.isin(ids.long(), vic).any():
            raise AssertionError("a removed id came back after add_points")
    desc = srv.describe()
    phase("updates", f"remove {N_REMOVE} ids: {rm_s:.2f} s (re-pack included), none "
                     f"returned; add {N_ADD} points: {add_s:.2f} s (exact rows, reverse-edge "
                     f"repair, re-pack); {found}/{N_ADD} find themselves at distance 0; "
                     f"layout {desc['layout']}, n {desc['n']}, live {srv.packed.n_live}")
    if found != N_ADD or desc["layout"] != "packed" or desc["n"] != n0 + N_ADD:
        raise AssertionError("updates: new points not found or view not re-packed")
    exact_rows = {"twophase": ("twophase_emit", "twophase_rescan_all" if kk > ex.KMAX
                               else "twophase_rescan"),
                  "rank": ("exact_knn",)}.get(engine, ())
    read_counts(f"updates (exact rows k={kk} on the {engine} engine)",
                ("probe_topk",) + exact_rows)
    profile_add(before, new)
    del before


def kernel_rows(prof) -> list:
    """(device us, launches, name) of each kernel, copy and set in a
    profile: the card's own rows, as torch's table sums them.  Not a host
    op's row, which carries its kernels' time again, and not a range's
    device-side row (a user annotation: a span's, an ``add_points:``
    range's), which marks the card's span of the kernels under it."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if (ev.device_type != DeviceType.CUDA or ev.is_user_annotation
                or ev.key in NOT_KERNELS):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    return rows


def range_times(prof, prefix: str) -> dict:
    """``{name: (host s, device s)}`` of the host ranges whose name starts
    with ``prefix``.  A range's device time is the card's span of its
    kernels, from the first one's start to the last one's end: the tracer
    gives each kernel to the innermost range open at its launch and marks
    that range's span on the card, so the spans opened inside a range
    (``exact.rank`` or ``exact.twophase`` in the exact rows) count toward
    it."""
    from torch.autograd import DeviceType

    events = prof.events()
    owner, host = {}, {}
    for ev in events:
        if ev.device_type == DeviceType.CPU and ev.name.startswith(prefix):
            host[ev.name] = host.get(ev.name, 0.0) + ev.cpu_time_total / 1e6
            owner[ev.name] = ev.name
            todo = list(ev.cpu_children)
            while todo:
                child = todo.pop()
                if child.is_user_annotation:
                    owner.setdefault(child.name, ev.name)
                todo.extend(child.cpu_children)
    ends: dict = {}
    for ev in events:
        if ev.device_type != DeviceType.CPU and ev.is_user_annotation and ev.name in owner:
            name = owner[ev.name]
            lo, hi = ends.get(name, (ev.time_range.start, ev.time_range.end))
            ends[name] = (min(lo, ev.time_range.start), max(hi, ev.time_range.end))
    return {name: (h, (ends[name][1] - ends[name][0]) / 1e6 if name in ends else 0.0)
            for name, h in host.items()}


def profile_add(srv, new) -> None:
    """``srv.add_points(new)`` under torch.profiler: device time of the
    stages (the ``add_points:`` ranges: bucket append, exact rows,
    reverse-edge repair, re-pack; :func:`range_times`), then of the
    kernels (:func:`kernel_rows`), grouped as the exact rows' emit,
    rescan and split merge, the rank kernel, the selection's
    ``torch.topk`` and sort kernels, and the rest."""
    from torch.profiler import ProfilerActivity, profile

    fence()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.add_points(new)
        fence()
        wall_s = time.perf_counter() - t0
    stages = range_times(prof, "add_points:")
    kernels = [(us / 1e6, count, key) for us, count, key in kernel_rows(prof)]
    busy = sum(r[0] for r in kernels)
    phase("updates", f"profile add {N_ADD} points: wall {wall_s:.3f} s under the profiler, "
                     f"device {busy:.3f} s, idle share {1 - busy / wall_s:.3f}; stages "
                     "(host s, device s): " + ", ".join(
                         f"{key[12:]} {h:.3f}, {t:.3f}" for key, (h, t) in stages.items()))
    groups = {"emit": ("EmitSelect",), "rescan": ("rescan_kernel",),
              "split merge": ("split_merge",), "rank": ("RankSelect",),
              "topk and sort": ("topk", "TopK", "radix", "Radix", "sort", "Sort")}
    sums = dict.fromkeys(list(groups) + ["rest"], 0.0)
    counts = dict.fromkeys(sums, 0)
    for t, count, key in kernels:
        g = next((name for name, pats in groups.items() if any(p in key for p in pats)),
                 "rest")
        sums[g] += t
        counts[g] += count
    phase("updates", "profile add by kernel group: " + ", ".join(
        f"{g} {sums[g]:.3f} s ({counts[g]} launches)" for g in sums))
    kernels.sort(reverse=True)
    for t, count, key in kernels[:8]:
        phase("updates", f"  {t:.3f} s ({100 * t / busy:.1f}%), {count} launches: {key[:90]}")


def compare_with_cpu(label, view, queries, ids, dists, c_ids, c_d) -> tuple[int, int]:
    """Card result (ids, dists) against the CPU result (c_ids, c_d) on the
    rows whose bucket codes agree on both: ids equal outside near-ties (the
    k-th may differ only at an equal distance: its successor is not
    returned), distances within rtol 1e-5.  Returns (rows compared,
    near-tie rows)."""
    codes_card, _ = query_codes(view.row_means, view.bases, queries)
    codes_cpu, _ = query_codes(view.row_means.cpu(), view.bases.cpu(), queries.cpu())
    same = (codes_card.cpu() == codes_cpu).all(1)
    if int(same.sum()) < same.numel() - 1:
        raise AssertionError(f"{label}: bucket codes differ card vs CPU in "
                             f"{int((~same).sum())} of {same.numel()} rows")
    a_i, a_d = ids.cpu()[same], dists.cpu()[same]
    b_i, b_d = c_ids[same], c_d[same]
    k = b_i.shape[1]
    ok, tied = ids_agree(a_i[:, : k - 1], b_i[:, : k - 1], b_d)
    if not ok:
        raise AssertionError(f"{label}: ids differ card vs CPU outside near-ties")
    if not torch.allclose(a_d, b_d, rtol=1e-5, atol=1e-4):
        err = (a_d - b_d).abs().max().item()
        raise AssertionError(f"{label}: distances differ card vs CPU, max abs {err}")
    return int(same.sum()), tied


def profile_serving(label, srv, Y, reps: int = 5) -> None:
    """torch.profiler over ``reps`` pipelined searches: device time by
    kernel and the card's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    srv.search(Y)
    fence()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            srv.search(Y)
        fence()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = sorted(((us / 1e3, count, key) for us, count, key in kernel_rows(prof)),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    phase("profile", f"{label}, {reps} calls: wall {wall_ms / reps:.3f} ms "
                     f"per call, device {busy / reps:.3f} ms per call, idle share "
                     f"{1 - busy / wall_ms:.3f}")
    for ms, count, key in rows[:8]:
        phase("profile", f"  {ms / reps:.3f} ms/call ({100 * ms / busy:.1f}%), "
                         f"{count // reps} launches/call: {key[:90]}")


if __name__ == "__main__":
    main()
