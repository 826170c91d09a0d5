"""Wall-clock benchmark harness (port of
``approximatenn_tpu/harness/time_results.py``, the role of the reference's
``time_results.c``).

Times ``build`` (with or without save, ``-z``) or batched ``search``
(``-y N``), averaged over ``-o`` repetitions, and prints mean seconds as
the reference does.  Each timed region ends in :func:`fence`
(``torch.cuda.synchronize``), so the numbers are device work, not the
enqueue; the first repetition is reported separately (it includes the
kernels' build and load where they are not loaded yet).  Runs on the CUDA card, or on the CPU with
``-c``.

Run: ``python -m approximatenn_tpu_torch.harness.time_results [-n ...]``
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..utils.profiling import fence
from .common import (gen_gaussian, make_parser, np_dtype, resolve_backend,
                     seeded_generator)


def main(argv=None) -> int:
    p = make_parser("time_results", __doc__.splitlines()[0])
    p.add_argument("--save", action="store_true",
                   help="alias of -z: build with save structure")
    args = p.parse_args(argv)
    save_test = args.z or args.save
    ycnt = args.ycnt or 0

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
    time_used = 0.0
    first = None
    try:
        if ycnt:
            pd = torch.from_numpy(gen_gaussian(rng, args.n, args.d, dt)).to(dev)
            idx, _, _ = ann.build(pd, args.k, generator=seeded_generator(rng), **kw)
            if args.verbose:
                print("Precomputation finished.")
            for i in range(args.average_over + 1):
                y = torch.from_numpy(gen_gaussian(rng, ycnt, args.d, dt)).to(dev)
                fence(dev)
                t0 = time.perf_counter()
                ann.search(idx, pd, y)
                fence(dev)
                dt_s = time.perf_counter() - t0
                if i == 0:
                    first = dt_s  # the kernels' first load included
                else:
                    time_used += dt_s
                if args.verbose:
                    print(i + 1, end=" ", flush=True)
            mode = "query"
        else:
            # the capacity of the first build, with headroom, for every later
            # one: the reference's steady state (a fixed table shape)
            cap = None
            for i in range(args.average_over + 1):
                points = torch.from_numpy(gen_gaussian(rng, args.n, args.d, dt)).to(dev)
                gen = seeded_generator(rng)
                fence(dev)
                t0 = time.perf_counter()
                idx, _, _ = ann.build(points, args.k, generator=gen, capacity=cap, **kw)
                fence(dev)
                dt_s = time.perf_counter() - t0
                if i == 0:
                    first = dt_s
                    cap = idx.tmax + 4  # headroom so later draws rarely overflow
                else:
                    time_used += dt_s
                if args.verbose:
                    print(i + 1, end=" ", flush=True)
            mode = "comp (with save)" if save_test else "comp (no save)"
    finally:
        ann.set_ftype(prev)
    if args.verbose:
        print()
    print(
        f"Average time for {mode} (on {'CPU' if dev.type == 'cpu' else 'GPU'}): "
        f"{time_used / args.average_over:g}s  "
        f"(first run: {first:g}s)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
