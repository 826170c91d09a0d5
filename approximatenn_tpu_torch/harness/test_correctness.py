"""Statistical-correctness harness (port of
``approximatenn_tpu/harness/test_correctness.py``, the role of the
reference's ``test_correctness.c``).

Index mode (default): per repetition, generate Gaussian points, build the
kNN graph, score against the exact oracle.  Query mode (``-y``/``-z``): one
build, then per repetition generate queries and score the search.  Prints
the reference's three metrics.  Runs on the CUDA card, or on the CPU with
``-c``.

Run: ``python -m approximatenn_tpu_torch.harness.test_correctness [-n ...]``
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .common import (gen_gaussian, make_parser, np_dtype, resolve_backend,
                     seeded_generator)
from .scoring import score_guesses


def main(argv=None) -> int:
    p = make_parser("test_correctness", __doc__.splitlines()[0])
    args = p.parse_args(argv)
    if args.z and args.ycnt is None:
        args.ycnt = 50
    use_y = args.ycnt is not None

    import approximatenn_tpu_torch as ann

    dev = resolve_backend(args.use_cpu)
    rng = np.random.default_rng(args.seed if args.seed is not None else time.time_ns())
    dt = np_dtype(args.dtype)
    kw = dict(
        tries=args.tries, rots_before=args.rots_before,
        rot_len_before=args.rot_len_before, rots_after=args.rots_after,
        rot_len_after=args.rot_len_after,
    )
    prev = ann.ftype()
    ann.set_ftype(args.dtype)
    try:
        score = scb = scc = 0.0
        if use_y:
            points = gen_gaussian(rng, args.n, args.d, dt)
            pd = torch.from_numpy(points).to(dev)
            idx, _, _ = ann.build(pd, args.k, generator=seeded_generator(rng), **kw)
            if args.verbose:
                print("Precomputation finished.")
            for i in range(args.average_over):
                y = gen_gaussian(rng, args.ycnt, args.d, dt)
                ids, _ = ann.search(idx, pd, torch.from_numpy(y).to(dev))
                s = score_guesses(points, y, ids.cpu().numpy(), args.k)
                score += s.mean_excess_rank
                scb += 1 - s.prob_correct
                scc += s.max_rank_over_k
                if args.verbose:
                    print(i + 1, end=" ", flush=True)
        else:
            for i in range(args.average_over):
                points = gen_gaussian(rng, args.n, args.d, dt)
                pd = torch.from_numpy(points).to(dev)
                graph, _ = ann.build_graph_only(pd, args.k,
                                                generator=seeded_generator(rng), **kw)
                s = score_guesses(points, None, graph.cpu().numpy(), args.k)
                score += s.mean_excess_rank
                scb += 1 - s.prob_correct
                scc += s.max_rank_over_k
                if args.verbose:
                    print(i + 1, end=" ", flush=True)
    finally:
        ann.set_ftype(prev)
    if args.verbose:
        print()
    o = args.average_over
    print(
        f"Average index score for {'query' if use_y else 'comp'} "
        f"(on {'CPU' if dev.type == 'cpu' else 'GPU'}): {score / o:g}.\n"
        f"Prob correct: {1 - scb / o:g}.\n"
        f"Max index score: {scc / o:g}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
