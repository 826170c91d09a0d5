"""Dataset benchmark runner: recall@k vs throughput over the config ladder
(port of ``approximatenn_tpu/harness/ann_bench.py``).

Runs one named dataset (SIFT-1M / GloVe-1.2M / Deep / synthetic points):
build the index, compute or load exact ground truth, sweep one or more
operating points (tries), and report recall@k, build time, QPS
(pipelined) and per-batch latency as JSON lines.  Runs on the CUDA card,
or on the CPU with ``-c``; every timed region ends in :func:`fence`.

Run:  python -m approximatenn_tpu_torch.harness.ann_bench --dataset sift-1m \\
          [--max-n 100000] [--k 10] [--tries 10 6 4] [--batch 1000]

Datasets resolve from $ANN_TPU_DATA (see ``data.datasets``); absent files
fall back to deterministic synthetic stand-ins at the same operating point
(reported with "synthetic": true so numbers are never confused).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..utils.profiling import fence
from .common import resolve_backend

_PACKED_DTYPES = {None: None, "f32": torch.float32, "bf16": torch.bfloat16,
                  "int8": torch.int8}


def run_config(ann, ds, k, tries, batch, reps, seed, capacity="auto",
               n_probes=None, packed=False, window=None, super_width=2,
               packed_dtype=None, supercharge_rounds=1, rerank_width=None,
               fused=False, device=None):
    """One operating point on ``ds``: build, ground truth, recall and
    throughput; returns the JSON record."""
    dev = torch.device(device) if device is not None else resolve_backend(False)
    Xd = torch.from_numpy(np.ascontiguousarray(ds.base)).to(dev)
    fence(dev)
    t0 = time.perf_counter()
    # capacity defaults to "auto": linear-memory tables (exact-max capacity
    # explodes on clustered corpora: one hot bucket holds a whole cluster)
    index, graph, _ = ann.build(
        Xd, k, tries=tries, seed=seed, metric=ds.metric, capacity=capacity
    )
    fence(dev)
    build_s = time.perf_counter() - t0

    from ..data.datasets import ensure_groundtruth

    gt = ensure_groundtruth(ds, k, device=dev)

    nq = min(batch, ds.queries.shape[0])
    Yd = torch.from_numpy(np.ascontiguousarray(ds.queries[:nq])).to(dev)
    pts = None if index.points is not None else Xd
    skw = dict(n_probes=n_probes)
    if supercharge_rounds != 1:
        skw["supercharge_rounds"] = supercharge_rounds
    if rerank_width is not None:
        skw["rerank_width"] = rerank_width
    if packed:
        pview = index.packed(
            Xd if index.points is None else None,
            window=window, super_width=super_width,
            dtype=_PACKED_DTYPES.get(packed_dtype, packed_dtype),
        )
        if fused:
            do_search = lambda: ann.search_packed_fused(  # noqa: E731
                pview, pts, Yd, window=window, **skw
            )
        else:
            do_search = lambda: ann.search_packed(pview, pts, Yd, **skw)  # noqa: E731
        index_mb = pview.memory_bytes() / 2**20
    else:
        do_search = lambda: ann.search(index, pts, Yd, **skw)  # noqa: E731
        index_mb = index.memory_bytes() / 2**20
    ids, _ = do_search()
    fence(dev)

    # throughput: pipelined calls, one fence per round; the rep count is
    # raised until a round queues ~1 s of work (`reps` is the floor)
    t0 = time.perf_counter()
    for _ in range(3):
        do_search()
    fence(dev)
    dt = (time.perf_counter() - t0) / 3
    reps = max(reps, min(200, int(round(1.0 / dt))))
    best = dt
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(reps):
            do_search()
        fence(dev)
        best = min(best, (time.perf_counter() - t0) / reps)
    qps = nq / best
    lat = []
    for _ in range(min(reps, 5)):
        t0 = time.perf_counter()
        do_search()
        fence(dev)
        lat.append(time.perf_counter() - t0)

    got = ids.cpu().numpy()
    want = gt[:nq, :k]
    hits = sum(
        len(set(got[i].tolist()) & set(want[i].tolist())) for i in range(nq)
    )
    recall = hits / (nq * k)
    return {
        "dataset": ds.name,
        "synthetic": ds.synthetic,
        "metric": ds.metric,
        "n": ds.n,
        "d": ds.d,
        "k": k,
        "tries": tries,
        "batch": nq,
        "recall_at_k": round(recall, 4),
        "build_s": round(build_s, 3),
        "capacity": index.tmax,
        "n_probes": n_probes if n_probes is not None else index.d_short + 1,
        "probe_mode": "blind-h1" if n_probes is None else "directed",
        "qps": round(qps, 1),
        "latency_s": round(float(np.median(lat)), 6),
        "index_mb": round(index_mb, 1),
        "layout": ("packed-fused" if fused else "packed") if packed else "table",
        "supercharge_rounds": supercharge_rounds,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        **({"rerank_width": rerank_width}
           if rerank_width is not None else {}),
        **(
            {"window": pview.window, "super_width": pview.super_width,
             "packed_dtype": {None: "float32", "f32": "float32",
                              "bf16": "bfloat16", "int8": "int8"}[packed_dtype]}
            if packed else {}
        ),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser("ann_bench", description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="gaussian-10k",
                   help="named dataset (see data.datasets.SPECS) or dir name")
    p.add_argument("--max-n", type=int, default=None, help="truncate base set")
    p.add_argument("--max-queries", type=int, default=None)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--tries", type=int, nargs="+", default=[10])
    p.add_argument("--batch", type=int, default=1000)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--capacity", default="auto",
                   help="bucket capacity: int, 'auto' (default), or 'exact' "
                        "(the reference's exact-max policy; can explode on "
                        "clustered data)")
    p.add_argument("--n-probes", type=int, default=None,
                   help="query-directed multiprobe count (default: the "
                        "reference's blind Hamming-1 set, d_short+1 probes)")
    p.add_argument("--packed", action="store_true",
                   help="serve through the packed bucket-CSR view")
    p.add_argument("--fused", action="store_true",
                   help="with --packed: serve through search_packed_fused (the "
                        "probe-window kernel; needs the card)")
    p.add_argument("--window", type=int, default=None,
                   help="packed per-probe read depth in points (default tmax)")
    p.add_argument("--super-width", type=int, default=2,
                   help="packed super-row width in points (2 = the library "
                        "default)")
    p.add_argument("--packed-dtype", default=None,
                   choices=[None, "f32", "bf16", "int8"],
                   help="packed vector storage dtype (int8 = quantized "
                        "tier, scale kept on the view)")
    p.add_argument("--supercharge-rounds", type=int, default=1,
                   help="graph-expansion rounds at query time (reference: 1)")
    p.add_argument("--rerank-width", type=int, default=None,
                   help="keep this many candidates (>= k) through merge + "
                        "supercharge, reduce to k at the end (recall knob)")
    p.add_argument("--tune", action="store_true",
                   help="auto-tune the operating point instead of running "
                        "the config ladder: walk the exact/packed knob grid "
                        "on the dataset's queries, print the TuneReport as "
                        "one JSON line (see engine.tuning)")
    p.add_argument("--target-recall", type=float, default=0.9,
                   help="with --tune: the recall@k the winner must meet")
    p.add_argument("-c", dest="use_cpu", action="store_true",
                   help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    if args.fused and not args.packed:
        p.error("--fused requires --packed (it serves the packed view)")
    if args.fused and args.use_cpu:
        p.error("--fused serves the probe kernel, which needs the card")
    cap = {"auto": "auto", "exact": None}.get(args.capacity, args.capacity)
    if isinstance(cap, str) and cap not in ("auto",):
        cap = int(cap)

    import approximatenn_tpu_torch as ann

    from ..data import datasets

    dev = resolve_backend(args.use_cpu)
    ds = datasets.load(args.dataset, max_n=args.max_n, max_queries=args.max_queries)
    if args.tune:
        nq = min(args.batch, ds.queries.shape[0])
        rep = ann.tune(
            torch.from_numpy(np.ascontiguousarray(ds.base)).to(dev), args.k,
            queries=ds.queries[:nq], batch=args.batch,
            target_recall=args.target_recall, metric=ds.metric,
            tries=args.tries[0], capacity=cap,
            packed_dtype=_PACKED_DTYPES[args.packed_dtype],
        )
        print(json.dumps({"dataset": ds.name, "synthetic": ds.synthetic,
                          "n": ds.n, "d": ds.d, **rep.as_dict()}),
              flush=True)
        return 0
    for tries in args.tries:
        rec = run_config(ann, ds, args.k, tries, args.batch, args.reps,
                         args.seed, capacity=cap, n_probes=args.n_probes,
                         packed=args.packed, window=args.window,
                         super_width=args.super_width,
                         packed_dtype=args.packed_dtype,
                         supercharge_rounds=args.supercharge_rounds,
                         rerank_width=args.rerank_width, fused=args.fused,
                         device=dev)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
