"""Backend-parity harness: the card against the CPU (port of
``approximatenn_tpu/harness/compare_results.py``, the role of the
reference's ``compare_results.c``).

The reference gates its GPU backend against the single-threaded C backend
by re-seeding libc ``random()`` identically before each run and counting
output differences (graph ids exact; floats in 1024-ULP units).  Here one
seeded CPU ``torch.Generator`` per sample drives both builds, so the card
and the CPU hash with the same bases; ``-c`` compares the CPU with itself.

On the card the exact graph comes from the rank kernel (3xTF32 on the
tensor cores) and on the CPU from the float32 oracle; both backends' hash
codes come from float32 matmuls that may round a near-zero projection
differently.  ``--arbitrate`` attributes the graph diffs that result.

Precomp mode: per repetition, draw a fresh seed, build on both backends,
report mean graph-id mismatches and float-field ULP diffs.
Query mode (``-z``): one index built on the card, carried to the CPU, then
per repetition query both backends and count id mismatches.

Run: ``python -m approximatenn_tpu_torch.harness.compare_results [-n ...]``
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .common import gen_gaussian, make_parser, np_dtype, resolve_backend, seeded_generator


def ulp_units(a: np.ndarray, b: np.ndarray, unit: int = 1024) -> float:
    """Float difference in `unit` ULPs (reference: '1024 ulp = 1 diff'),
    via the monotonic int mapping."""
    def key(x):
        bits = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        mag = bits & 0x7FFFFFFF
        return np.where(bits < 0, -mag, mag)  # monotonic in float order

    return float(np.sum(np.abs(key(a) - key(b)) // unit))


def diffcount(a: np.ndarray, b: np.ndarray) -> int:
    """Exact mismatch count of id arrays."""
    return int(np.sum(np.asarray(a) != np.asarray(b)))


def f64_oracle(points: np.ndarray, k: int):
    """Blocked all-pairs float64 distances + the k-th oracle distance per
    row: the reusable half of :func:`arbitrate_f64` (main() arbitrates two
    graph modes over the same points, so the O(n^2 d) oracle is computed
    once per sample)."""
    P = np.asarray(points, np.float64)
    n = P.shape[0]
    if n > 32768:
        raise ValueError(
            f"arbitrate_f64 holds an (n, n) float64 distance matrix "
            f"({n * n * 8 / 2**30:.1f} GiB at n={n}); the gate runs at "
            "harness sizes (n <= 32768) — subsample for larger corpora"
        )
    d2 = np.empty((n, n), np.float64)
    sq = (P * P).sum(1)
    for lo in range(0, n, 1024):
        hi = min(lo + 1024, n)
        d2[lo:hi] = sq[lo:hi, None] + sq[None, :] - 2.0 * (P[lo:hi] @ P.T)
    np.fill_diagonal(d2, np.inf)
    okth = np.partition(d2, k - 1, axis=1)[:, k - 1]
    return d2, okth


def arbitrate_f64(points: np.ndarray, ga, gc, k: int, oracle=None) -> dict:
    """Attribute backend graph-id diffs with a float64 oracle.

    Computes the exact f64 all-pairs top-k (self-excluded), then:

    - ``recall_acc`` / ``recall_cpu``: each backend's graph ids scored
      against the oracle's tie-closed neighbor set (any id whose f64
      distance <= the k-th oracle distance counts).  Equal recalls mean the
      diffs carry no quality signal.
    - per disagreeing row, the two id sets' f64 distance spectra are
      compared: ``diff_tie_f64`` ids differ but have identical f64
      distances (tie order only: both answers exactly right),
      ``diff_tie_f32`` differ by less than f32 resolution (either answer is
      correct at working precision), and ``diff_real`` is the remainder (a
      genuine quality gap; the band in ``--max-diff-frac`` gates on these).
    """
    n = np.asarray(points).shape[0]
    d2, okth = f64_oracle(points, k) if oracle is None else oracle

    ga, gc = np.asarray(ga), np.asarray(gc)

    def set_recall(g):
        hits = 0
        for i in range(n):
            ids = g[i][g[i] < n]
            hits += int(np.sum(d2[i, ids] <= okth[i] * (1 + 1e-12)))
        return hits / (n * k)

    def row_dists(g, i):
        dd = np.full(g.shape[1], np.inf)
        m = g[i] < n
        dd[m] = d2[i, g[i][m]]
        return np.sort(dd)

    ga_s, gc_s = np.sort(ga, 1), np.sort(gc, 1)
    out = {
        "recall_acc": set_recall(ga),
        "recall_cpu": set_recall(gc),
        "diff_tie_f64": 0,
        "diff_tie_f32": 0,
        "diff_real": 0,
    }
    for i in np.nonzero((ga_s != gc_s).any(1))[0]:
        cnt = int((ga_s[i] != gc_s[i]).sum())
        da, dc = row_dists(ga, i), row_dists(gc, i)
        fin = np.isfinite(da) & np.isfinite(dc)
        if (fin == (np.isfinite(da) | np.isfinite(dc))).all() and np.allclose(
            da[fin], dc[fin], rtol=1e-12, atol=0.0
        ):
            out["diff_tie_f64"] += cnt
        elif (fin == (np.isfinite(da) | np.isfinite(dc))).all() and np.allclose(
            da[fin], dc[fin], rtol=2e-6, atol=0.0
        ):
            out["diff_tie_f32"] += cnt
        else:
            out["diff_real"] += cnt
    return out


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


def main(argv=None) -> int:
    p = make_parser("compare_results", __doc__.splitlines()[0])
    p.add_argument("--arbitrate", action="store_true",
                   help="attribute precomp-mode graph diffs with a float64 "
                        "oracle: per-backend oracle recall + tie-vs-real "
                        "classification (see arbitrate_f64)")
    p.add_argument("--max-diff-frac", type=float, default=None,
                   help="acceptance band: fail (exit 2) when the mean id "
                        "diff fraction exceeds this (with --arbitrate, "
                        "only diff_real ids count against the band — tie-"
                        "equivalent diffs are correct answers)")
    args = p.parse_args(argv)
    if args.arbitrate and args.n > 32768:
        # fail at parse time, not mid-run after the builds (f64_oracle's
        # (n, n) float64 bound)
        p.error(f"--arbitrate holds an (n, n) float64 distance matrix; "
                f"-n {args.n} exceeds the supported bound 32768")
    if args.z and args.ycnt is None:
        args.ycnt = 50

    import approximatenn_tpu_torch as ann

    cpu = torch.device("cpu")
    acc = resolve_backend(args.use_cpu)
    if acc == cpu:
        print("note: -c given; comparing CPU vs CPU")

    rng = np.random.default_rng(args.seed if args.seed is not None else time.time_ns())
    dt = np_dtype(args.dtype)
    kw = dict(
        tries=args.tries, rots_before=args.rots_before,
        rot_len_before=args.rot_len_before, rots_after=args.rots_after,
        rot_len_after=args.rot_len_after,
    )

    if args.ycnt:
        points = gen_gaussian(rng, args.n, args.d, dt)
        pa, pc = torch.from_numpy(points).to(acc), torch.from_numpy(points)
        idx_a, _, _ = ann.build(pa, args.k, generator=seeded_generator(rng), **kw)
        idx_c = ann.ANNIndex.from_numpy(idx_a.to_numpy_dict(), device=cpu)
        total = 0
        for i in range(args.average_over):
            y = gen_gaussian(rng, args.ycnt, args.d, dt)
            ia, _ = ann.search(idx_a, pa, torch.from_numpy(y).to(acc))
            ic, _ = ann.search(idx_c, pc, torch.from_numpy(y))
            # compare as id-sets per row: the order of equal distances may
            # legitimately differ between backends
            total += diffcount(np.sort(_np(ia), 1), np.sort(_np(ic), 1))
            if args.verbose:
                print(i + 1, end=" ", flush=True)
        if args.verbose:
            print()
        print(f"Average query diff count: {total / args.average_over:g} "
              f"(of {args.ycnt * args.k} ids)")
        if args.max_diff_frac is not None:
            frac = total / args.average_over / (args.ycnt * args.k)
            if frac > args.max_diff_frac:
                print(f"FAIL: query diff fraction {frac:.4f} > band "
                      f"{args.max_diff_frac}")
                return 2
    else:
        # gate both graph modes: the hash pipeline is the divergence-prone
        # path ("auto" resolves to "exact" at harness sizes)
        totals = {"hash": [0, 0.0], "exact": [0, 0.0]}
        arb_keys = ("recall_acc", "recall_cpu", "diff_tie_f64",
                    "diff_tie_f32", "diff_real")
        arb = {m: dict.fromkeys(arb_keys, 0.0) for m in totals}
        for i in range(args.average_over):
            points = gen_gaussian(rng, args.n, args.d, dt)
            seed = int(rng.integers(2**63))
            # one O(n^2 d) f64 oracle per sample, shared by both modes
            oracle = f64_oracle(points, args.k) if args.arbitrate else None
            for mode, (gt_, ft_) in totals.items():
                ia, ga, da = ann.build(torch.from_numpy(points).to(acc), args.k,
                                       generator=torch.Generator().manual_seed(seed),
                                       graph_mode=mode, **kw)
                ic, gc, dc = ann.build(torch.from_numpy(points), args.k,
                                       generator=torch.Generator().manual_seed(seed),
                                       graph_mode=mode, **kw)
                ga, gc = _np(ga), _np(gc)
                gt_ += diffcount(np.sort(ga, 1), np.sort(gc, 1))
                ft_ += ulp_units(_np(ia.row_means), _np(ic.row_means))
                ft_ += ulp_units(_np(ia.bases), _np(ic.bases))
                # sort before masking so the finite mask is aligned with
                # the elements it selects (mismatched inf counts show up as
                # graph id diffs, not float diffs)
                da_ = np.sort(_np(da), 1)
                dc_ = np.sort(_np(dc), 1)
                fin = np.isfinite(da_) & np.isfinite(dc_)
                ft_ += ulp_units(da_[fin], dc_[fin])
                totals[mode] = [gt_, ft_]
                if args.arbitrate:
                    a = arbitrate_f64(points, ga, gc, args.k, oracle=oracle)
                    for kk_ in arb_keys:
                        arb[mode][kk_] += a[kk_]
            if args.verbose:
                print(i + 1, end=" ", flush=True)
        if args.verbose:
            print()
        fail = False
        for mode, (gt_, ft_) in totals.items():
            print(
                f"[graph_mode={mode}] Average graph diff count: "
                f"{gt_ / args.average_over:g} (of {args.n * args.k} ids); "
                f"float diff (1024-ULP units): {ft_ / args.average_over:g}"
            )
            band_count = gt_
            if args.arbitrate:
                a = arb[mode]
                o = args.average_over
                print(
                    f"[graph_mode={mode}] arbitration (f64 oracle): "
                    f"oracle-recall acc={a['recall_acc'] / o:.4f} "
                    f"cpu={a['recall_cpu'] / o:.4f}; diff ids "
                    f"tie_f64={a['diff_tie_f64'] / o:g} "
                    f"tie_f32={a['diff_tie_f32'] / o:g} "
                    f"real={a['diff_real'] / o:g}"
                )
                band_count = a["diff_real"]
            if args.max_diff_frac is not None:
                frac = band_count / args.average_over / (args.n * args.k)
                if frac > args.max_diff_frac:
                    label = "real " if args.arbitrate else ""
                    print(f"FAIL: [graph_mode={mode}] {label}diff fraction "
                          f"{frac:.5f} > band {args.max_diff_frac}")
                    fail = True
        if fail:
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
