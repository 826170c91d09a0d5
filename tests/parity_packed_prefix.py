"""Recall of packed serving on a prefix of chip_smoke.py's clustered corpus,
the JAX package against the port, on the CPU and one JAX-built index.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/parity_packed_prefix.py [--n 100000]

The corpus is the first ``--n`` rows of ``clustered_gaussian(
default_rng(0), 1_000_000, 128, n_clusters=10_000)`` (the smoke's packed
corpus; the generator's draws are sequential, so the prefix equals the
first rows of the full array), queries are corpus rows plus 0.1 Gaussian
noise.  The index is built once by the JAX package (k=10, tries=10,
capacity "auto", exact graph) and carried to the port through its npz.
Both packages then serve bf16 packed views with 18 directed probes at
window 96, and at window 192 with rerank_width 50: the JAX package's
``search_packed`` against the port's ``search_packed`` and
``search_packed_fused`` (the probe kernel's plain version here).  Prints
one JSON line with the recalls@10 against the exact neighbours and the
bucket occupancy of the index.  Not collected by pytest: it takes minutes.
"""

import argparse
import json
import tempfile
import time

import jax.numpy as jnp
import numpy as np
import torch

import approximatenn_tpu as jann
import approximatenn_tpu_torch as tann
from approximatenn_tpu_torch.harness.scoring import recall_at_k
from approximatenn_tpu_torch.index import ANNIndex


def prefix_corpus(n: int, d: int = 128, n_clusters: int = 10_000,
                  full: int = 1_000_000) -> np.ndarray:
    """The first n rows of clustered_gaussian(default_rng(0), full, d,
    n_clusters=n_clusters), without drawing the other rows."""
    rng = np.random.default_rng(0)
    centers = 4.0 * rng.standard_normal((n_clusters, d)).astype(np.float32)
    w = 1.0 / np.arange(1, n_clusters + 1) ** 1.2
    w /= w.sum()
    assign = rng.choice(n_clusters, size=full, p=w)
    return centers[assign[:n]] + rng.standard_normal((n, d)).astype(np.float32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    X = prefix_corpus(args.n)
    q_rng = np.random.default_rng(1)
    Y = (X[q_rng.integers(0, args.n, args.queries)]
         + 0.1 * q_rng.standard_normal((args.queries, X.shape[1]))).astype(np.float32)
    t0 = time.perf_counter()
    jidx, _, _ = jann.build(jnp.asarray(X), 10, tries=10, seed=0, capacity="auto",
                            store_points=True)
    build_s = time.perf_counter() - t0
    truth = np.asarray(jann.brute_force_knn(jnp.asarray(X), jnp.asarray(Y), 10)[0])
    with tempfile.TemporaryDirectory() as tmp:
        jidx.save(f"{tmp}/idx.npz")
        tidx = ANNIndex.load(f"{tmp}/idx.npz")
    counts = np.asarray(jidx.counts)
    out = {"n": args.n, "queries": args.queries, "d_short": jidx.d_short,
           "tmax": jidx.tmax, "jax_build_s": round(build_s, 1),
           "largest_bucket": int(counts.max()),
           "share_of_points_in_buckets_over_96": float(counts[counts > 96].sum()
                                                       / counts.sum())}
    yq = torch.from_numpy(Y)
    for window, rerank in ((96, None), (192, 50)):
        jpv = jidx.packed(dtype=jnp.bfloat16, window=window)
        tpv = tidx.packed(dtype=torch.bfloat16, window=window)
        kw = dict(n_probes=18, rerank_width=rerank)
        ji, _ = jann.search_packed(jpv, queries=jnp.asarray(Y), **kw)
        ti, _ = tann.search_packed(tpv, queries=yq, **kw)
        tf, _ = tann.search_packed_fused(tpv, queries=yq, **kw)
        out[f"w{window}_rerank{rerank}"] = {
            "jax_search_packed": recall_at_k(truth, np.asarray(ji), 10),
            "port_search_packed": recall_at_k(truth, ti.numpy(), 10),
            "port_search_packed_fused": recall_at_k(truth, tf.numpy(), 10)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
