"""Operating-point auto-tuner: pick the serving config for a recall target
(port of ``approximatenn_tpu/engine/tuning.py``).

The landscape has real choices: the exact engine (recall 1.0; the rank
kernel on the card), the packed hash path (n_probes x window x
rerank_width frontier; the probe kernel on the card) and the table path.
``tune()`` walks it on a held-out query sample against the exact oracle
and returns the cheapest configuration meeting the recall target.

- One index build + one pack serve every hash trial: ``window`` is a
  query-time knob (one pack at the largest window), ``n_probes`` and
  ``rerank_width`` are call arguments.  The tuner never rebuilds per trial.
- Two passes: a recall pass (one batch per config, which also builds and
  loads the kernels), then a throughput pass over only the configs that met
  the target, fenced with ``torch.cuda.synchronize`` (:func:`fence`).
  Losers never get timed.
- On the CPU (``measure=None`` with a CPU corpus, or ``measure=False``)
  the survivors are ranked by a deterministic cost proxy (candidate rows
  scanned) instead of wall time, so the tuner's logic is testable there.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..harness.scoring import recall_at_k
from ..utils.profiling import fence
from .build import build

# the JAX package's grids: every published high-recall packed operating
# point uses window 96-256 and rerank 50.  Window is a query-time knob
# (one pack at max(window) serves every trial)
DEFAULT_PROBE_GRID = (None, 12, 18, 24)  # None = blind Hamming-1 set
DEFAULT_WINDOW_GRID = (8, 32, 96, 192)
DEFAULT_RERANK_GRID = (None, 30, 50)
DEFAULT_SUPER_GRID = (1,)  # supercharge rounds; pass (1, 2) to widen
DEFAULT_EXACT_TIERS = (None,)  # exact storage tiers; e.g. (None, "bf16", "int8")
_TIER_DTYPES = {None: None, "bf16": torch.bfloat16, "int8": torch.int8}


@dataclass
class Trial:
    """One evaluated operating point."""

    engine: str  # "exact" | "packed" | "table"
    knobs: dict
    recall: float
    cost: float  # candidate rows scanned per query (proxy; 0 order = cheap)
    qps: float | None = None  # fenced, measured only for target-meeting configs

    def as_dict(self) -> dict:
        return {
            "engine": self.engine,
            **self.knobs,
            "recall": round(self.recall, 4),
            "cost_rows": self.cost,
            "qps": None if self.qps is None else round(self.qps, 1),
        }


@dataclass
class TuneReport:
    """Everything ``tune()`` learned, plus the pieces to serve with."""

    best: Trial
    trials: list[Trial]
    k: int
    metric: str
    target_recall: float
    measured: bool
    batch: int = 0  # serving batch the trials dispatched at
    # batch > sample size: the QPS pass ran on tiled duplicate query rows
    # (duplicated queries probe identical windows, so measured QPS can read
    # slightly optimistic against batches of all-distinct queries)
    batch_tiled: bool = False
    _points: Any = field(repr=False, default=None)
    _index: Any = field(repr=False, default=None)
    _packed: Any = field(repr=False, default=None)

    def server(self):
        """A ready :class:`~.serving.Server` pinned to the winning operating
        point (reuses the tuner's build and pack; exact servers are built
        anew at the winning storage tier)."""
        from .serving import Server

        if self.best.engine == "exact":
            dt = _TIER_DTYPES[self.best.knobs.get("storage_dtype")]
            return Server.build(self._points, self.k, mode="exact",
                                metric=self.metric, storage_dtype=dt)
        srv = Server(points=self._points, k=self.k, mode="hash",
                     metric=self.metric, index=self._index,
                     n_probes=self.best.knobs.get("n_probes"))
        rw = self.best.knobs.get("rerank_width")
        if rw is not None:
            srv._search_kw["rerank_width"] = rw
        sr = self.best.knobs.get("supercharge_rounds")
        if sr is not None and sr != 1:
            srv._search_kw["supercharge_rounds"] = sr
        if self.best.engine == "packed":
            srv.packed = self._packed.with_window(self.best.knobs["window"])
        return srv

    def as_dict(self) -> dict:
        return {
            "best": self.best.as_dict(),
            "k": self.k,
            "metric": self.metric,
            "target_recall": self.target_recall,
            "measured": self.measured,
            "batch": self.batch,
            "batch_tiled": self.batch_tiled,
            "trials": [t.as_dict() for t in self.trials],
        }


def _sample_queries(points: torch.Tensor, n_queries: int, seed: int) -> torch.Tensor:
    """Held-out-ish sample: corpus rows + 5%-of-std jitter (deterministic,
    the JAX package's numpy draw).  Rows are drawn from the whole corpus
    (a leading-block sample is biased on corpora with ordered cluster
    layout); only the sampled rows are pulled to the host.  Real query
    logs are better: pass them as ``queries=``."""
    n = points.shape[0]
    rng = np.random.default_rng(seed ^ 0x5EED)
    rows = np.sort(rng.choice(n, size=min(n_queries, n), replace=False))
    q = points[torch.from_numpy(rows).to(points.device)].cpu().numpy().astype(np.float32)
    q = q + 0.05 * q.std(axis=0) * rng.standard_normal(q.shape)
    return torch.from_numpy(q.astype(np.float32)).to(points.device)


def _measure_qps(fn, m: int, device, target_s: float = 0.3) -> float:
    """Fence-timed throughput of an already-warm call."""
    t0 = time.perf_counter()
    fn()
    fence(device)
    dt = max(time.perf_counter() - t0, 1e-5)
    reps = max(1, min(50, int(target_s / dt)))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    fence(device)
    return m * reps / (time.perf_counter() - t0)


def tune(
    points,
    k: int,
    *,
    queries=None,
    n_queries: int = 256,
    batch: int | None = None,
    target_recall: float = 0.9,
    metric: str = "l2",
    include_exact: bool = True,
    include_table: bool = False,
    probe_grid=DEFAULT_PROBE_GRID,
    window_grid=DEFAULT_WINDOW_GRID,
    rerank_grid=DEFAULT_RERANK_GRID,
    super_grid=DEFAULT_SUPER_GRID,
    exact_tiers=DEFAULT_EXACT_TIERS,
    packed_dtype=None,
    measure: bool | None = None,
    measure_all: bool = False,
    sequential_tiers: bool = False,
    seed: int = 0,
    verbose: bool = False,
    **build_kw,
) -> TuneReport:
    """Search the serving-knob space for the cheapest config meeting
    ``target_recall`` (recall@k vs the exact oracle on a query sample).

    Returns a :class:`TuneReport`; ``report.server()`` is a Server pinned
    to the winner.  ``queries``: a sample of real queries (recommended);
    synthesized from the corpus when absent.  ``measure=None`` times on a
    CUDA corpus and ranks by the candidate-rows cost proxy on the CPU.
    ``**build_kw`` reaches the one hash build (tries, capacity, ...).
    A tensor corpus is tuned on its own device, anything else on the CUDA
    card (see :func:`config.default_device`).

    ``batch`` is the production serving batch size: every trial dispatches
    through ``Server.search`` with exactly that many query rows (the
    sample is tiled or sliced as needed), so the engine routing the tuner
    measures (the probe kernel on a CUDA view, the plain packed path on the
    CPU) is the routing production will hit.  Default: the query-sample
    size.  Tune at the batch you serve at: the winner can differ across
    batch sizes.

    The winner is the max-QPS (measured) or min-cost (proxy) trial with
    recall >= target; if none qualifies, the max-recall trial.

    Memory note: by default every ``exact_tiers`` entry holds its own
    corpus copy for the whole tune, next to the hash index and the packed
    view.  ``sequential_tiers=True`` trials the tiers one at a time (build,
    score, measure at once, free) before the hash view exists, so only one
    tier's corpus is resident at a time; sequential exact tiers are
    measured even when they miss the target (their QPS cannot be measured
    later).  The winner's exact server is rebuilt by ``server()`` either
    way.
    """
    from ..config import default_device
    from ..ops.exact import exact_search
    from .serving import Server, packed_route

    points = torch.as_tensor(points, device=default_device(points))
    if points.dtype != torch.float32:
        points = points.float()
    dev = points.device
    n = points.shape[0]
    if queries is None:
        queries = _sample_queries(points, n_queries, seed)
    else:
        queries = torch.as_tensor(queries, device=dev).float()
    m = queries.shape[0]
    if measure is None:
        measure = points.is_cuda

    # metric preprocessing once, shared by oracle and every trial
    if metric != "l2":
        from ..data.preprocess import prepare_points

        pts_m = prepare_points(points, metric)
        q_m = prepare_points(queries, metric)
    else:
        pts_m, q_m = points, queries

    true_ids, _ = exact_search(pts_m, q_m, k)
    true_ids = true_ids.cpu().numpy()

    # trials dispatch at the production batch size: batch > m tiles the
    # sample up (recall scored on the m distinct rows); batch < m slices
    # it into batch-shaped calls and scores recall over all m rows (one
    # small batch would make the recall gate statistically noisy)
    batch = m if batch is None else max(1, int(batch))
    if batch > m:
        tile = -(-batch // m)
        q_run = torch.cat([queries] * tile)[:batch]
        q_m_run = torch.cat([q_m] * tile)[:batch]
        q_slices = q_m_slices = None
    elif batch < m:
        def _slices(qarr):
            out = []
            for s in range(0, m, batch):
                e = s + batch
                out.append(qarr[s:e] if e <= m
                           else torch.cat([qarr[s:m], qarr[: e - m]]))
            return out

        q_slices, q_m_slices = _slices(queries), _slices(q_m)
        q_run, q_m_run = q_slices[0], q_m_slices[0]
    else:
        q_run, q_m_run = queries, q_m
        q_slices = q_m_slices = None

    trials: list[Trial] = []

    def note(t: Trial):
        trials.append(t)
        if verbose:
            print(f"  {t.engine:6s} {t.knobs} recall={t.recall:.3f} "
                  f"cost={t.cost:.0f}")

    runners: list[tuple[Trial, Any]] = []  # (trial, replayable thunk)

    def score_full(run_on, slices, q_default) -> float:
        """Recall over the full m-row sample: one batch-shaped call per
        slice when batch < m (the first call also warms the QPS pass);
        otherwise one call scored on the m distinct leading rows."""
        if slices is None:
            ids, _ = run_on(q_default)
            return recall_at_k(true_ids[:m], ids.cpu().numpy()[:m], k)
        parts = []
        for i, qs in enumerate(slices):
            ids, _ = run_on(qs)
            take = min(batch, m - i * batch)
            parts.append(ids.cpu().numpy()[:take])
        return recall_at_k(true_ids, np.concatenate(parts), k)

    def run_exact_trials():
        # one trial per exact storage tier, through Server.search so the
        # measured path is the production path (the engine routing
        # included).  Recall is against the f32 oracle (None = 1.0 by
        # construction; bf16 and int8 measured, not assumed)
        for tier in exact_tiers:
            if tier not in _TIER_DTYPES:
                raise ValueError(f"unknown exact tier {tier!r}")
            srv_e = Server.build(pts_m, k, mode="exact", metric="l2",
                                 storage_dtype=_TIER_DTYPES[tier])

            def run_exact_on(qa, srv_e=srv_e):
                return srv_e.search(qa)

            def run_exact(run_on=run_exact_on):
                return run_on(q_m_run)

            knobs = {} if tier is None else {"storage_dtype": tier}
            # the route a plain search takes, under the JAX package's label
            if srv_e.describe().get("exact_engine") == "cuda-twophase":
                knobs["exact_engine"] = "twophase"
            t = Trial("exact", knobs,
                      score_full(run_exact_on, q_m_slices, q_m_run),
                      cost=float(n) / (1 if tier is None
                                       else (2 if tier == "bf16" else 4)))
            note(t)
            if sequential_tiers:
                # measure now (warm from the recall pass), then free this
                # tier's corpus before the next one builds
                if measure:
                    t.qps = _measure_qps(run_exact, batch, dev)
                    if verbose:
                        print(f"  measured {t.engine} {t.knobs}: "
                              f"{t.qps:.0f} QPS")
                runners.append((t, None))
                del srv_e, run_exact, run_exact_on
            else:
                runners.append((t, run_exact))

    if include_exact and k <= 128 and sequential_tiers:
        # sequential tiers run before the hash view exists: peak memory is
        # max(one tier + corpus, hash view + corpus)
        run_exact_trials()

    index, _, _ = build(points, k, metric=metric, seed=seed,
                        store_points=True, **build_kw)
    # packed_dtype: storage type of the packed rows (bf16 halves, int8
    # quarters them)
    packed = index.packed(window=max(window_grid), dtype=packed_dtype)
    sw = packed.super_width
    srv_packed = Server(points=points, k=k, mode="hash", metric=metric,
                        index=index, packed=packed)
    srv_table = Server(points=points, k=k, mode="hash", metric=metric,
                       index=index)

    # the route the packed trials take at this batch, from the predicate
    # Server.search itself uses, on the tensor it inspects
    packed_path = packed_route(n, batch, srv_packed.packed.point_rows.is_cuda)

    if include_exact and k <= 128 and not sequential_tiers:
        run_exact_trials()

    for P in probe_grid:
        p_eff = P if P is not None else index.d_short + 1
        for w in window_grid:
            for rw in rerank_grid:
                for sr in super_grid:
                    def run_packed_on(qa, P=P, w=w, rw=rw, sr=sr):
                        return srv_packed.search(
                            qa, n_probes=P, window=w, rerank_width=rw,
                            supercharge_rounds=sr,
                        )

                    def run_packed(run_on=run_packed_on):
                        return run_on(q_run)

                    cost = index.tries * p_eff * w * sw
                    cost *= 1.0 + (0.0 if rw is None else rw / (2.0 * k))
                    cost *= 1.0 + 0.25 * (sr - 1)
                    knobs = {"n_probes": P, "window": w, "rerank_width": rw,
                             "path": packed_path}
                    if len(super_grid) > 1 or sr != 1:
                        knobs["supercharge_rounds"] = sr
                    t = Trial("packed", knobs,
                              score_full(run_packed_on, q_slices, q_run),
                              cost)
                    note(t)
                    runners.append((t, run_packed))

    if include_table:
        for P in probe_grid:
            p_eff = P if P is not None else index.d_short + 1
            for rw in rerank_grid:
                def run_table_on(qa, P=P, rw=rw):
                    return srv_table.search(qa, n_probes=P,
                                            rerank_width=rw)

                def run_table(run_on=run_table_on):
                    return run_on(q_run)

                cost = index.tries * p_eff * index.tmax
                cost *= 1.0 + (0.0 if rw is None else rw / (2.0 * k))
                t = Trial("table", {"n_probes": P, "rerank_width": rw},
                          score_full(run_table_on, q_slices, q_run), cost)
                note(t)
                runners.append((t, run_table))

    qualified = [(t, r) for t, r in runners if t.recall >= target_recall]
    if not qualified:
        best = max(trials, key=lambda t: t.recall)
        cands = [(t, r) for t, r in runners if t is best]
    else:
        cands = qualified

    if measure:
        # measure_all: time every trial, not just the qualifying ones (the
        # report then answers any target offline)
        for t, run in (runners if measure_all else cands):
            if run is None or t.qps is not None:
                continue  # sequential tiers were measured (then freed)
            t.qps = _measure_qps(run, batch, dev)
            if verbose:
                print(f"  measured {t.engine} {t.knobs}: {t.qps:.0f} QPS")
        best = max((t for t, _ in cands), key=lambda t: t.qps)
    else:
        best = min((t for t, _ in cands), key=lambda t: t.cost)

    return TuneReport(best=best, trials=trials, k=k, metric=metric,
                      target_recall=target_recall, measured=measure,
                      batch=batch, batch_tiled=batch > m,
                      _points=points, _index=index, _packed=packed)
