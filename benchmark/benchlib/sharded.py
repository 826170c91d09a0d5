"""A run of a cell whose system spans several cards: one process (rank) a
card, the program's ``ShardedServer`` across them, rank 0 the client.

The launcher (:func:`launch_ranks`, called by ``kinds/sharded.py:Run.run``
in the process of ``run.py`` or ``calibrate.py``) starts one rank a card
through the program's own launcher (``parallel/dryrun.py:launch``, which
kills every rank when one fails, and all of them at its time limit) and
returns rank 0's result line.  Each rank (:func:`main`) joins one NCCL
group (gloo on the CPU) whose collectives give up after
``GROUP_TIMEOUT_S``, draws its shard and the query pool from the seed
(:func:`draw_shard`, :func:`draw_queries`), builds the server over its own
rows and serves every batch that rank 0 calls for (:class:`RankRun`): rank
0 runs the closed loop, the traced slice and the check, the other ranks
follow its signal, one broadcast a batch, since every search is a
collective of all of them.

The check (:meth:`RankRun.check`): rank 0's sample of the window's answers
goes to every rank; each rank draws its shard again, ranks it for the
sampled queries in float64 (``reference.knn``, the plain reference) and
scores the returned ids it holds; rank 0 merges the shards' k + 8 best by
(distance, global id) with :func:`merge_shards` and computes ``dist_err``
and ``rank_gap`` as the exact kind does on one card (``check.py``), with
the median ``|x|^2`` of each shard's rows, their median over the shards,
as the scale.

Beside ``system.py`` and ``spans.py`` this file imports the program: its
launcher, process group, mesh and ``ShardedServer``, when a run starts,
never when it is imported.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from . import check, data, faults, reference, system
from .harness import load_cell
from .serve import SearchRun

BENCH = Path(__file__).resolve().parents[1]
# a collective that waits longer than this fails its rank (and the launcher
# then kills the others)
GROUP_TIMEOUT_S = 180.0
# the launcher's limit: set-up, the check and the window, with room
LAUNCH_S = 900.0
# corpus rows a block of the reference's float64 scores
REF_BLOCK = 1 << 18
# the rank's entry: the benchmark's library from the checkout that launched it
_WORKER = ("import sys; sys.path[:0] = [{root!r}, {bench!r}]; "
           "from benchlib.sharded import main; main()")


# -- the data ---------------------------------------------------------------

def shard_rows(n: int, world: int, rank: int) -> tuple[int, int]:
    """(rows each shard holds, rows of them that are real): n rows split in
    rank order into ``world`` shards of ceil(n / world) rows, zero pad rows
    at the end of the last."""
    per = -(-n // world)
    return per, max(0, min(per, n - rank * per))


def shard_seed(seed: int, rank: int) -> int:
    """The seed of shard ``rank``'s rows under the run's ``seed``."""
    return (int(seed) * 1_000_003 + 7_919 * (rank + 1)) % (1 << 63)


def mixture(config: dict, seed: int, device):
    """(generator, centres, cumulative weights) of the configuration's
    mixture (``data.py``), drawn from ``seed`` alike on every rank."""
    spec = config["data"]
    if spec["kind"] != "clustered_gaussian":
        raise ValueError(f"unknown data kind {spec['kind']!r}")
    gen = data.generator(seed, device)
    nc = int(spec["n_clusters"])
    centers = float(spec["spread"]) * torch.randn((nc, config["d"]), generator=gen,
                                                  device=device)
    w = 1.0 / torch.arange(1, nc + 1, dtype=torch.float64, device=device) ** float(spec["zipf"])
    return gen, centers, torch.cumsum(w / w.sum(), 0)


def draw_queries(config: dict, seed: int, device, n_queries: int | None = None):
    """The query pool (n_queries, d) float32: draws of the mixture after its
    centres, the same on every rank."""
    gen, centers, cdf = mixture(config, seed, device)
    nq = config["n_queries"] if n_queries is None else n_queries
    return data._draw(gen, centers, cdf, nq)


def draw_shard(config: dict, seed: int, rank: int, world: int, device,
               n: int | None = None, dtype=torch.float32) -> torch.Tensor:
    """Shard ``rank``'s rows (:func:`shard_rows`) in ``dtype``: its real rows
    drawn from the mixture with the generator of :func:`shard_seed`, a block
    of rows at a time in float32 and rounded to ``dtype`` there (the same
    numbers as ``data._draw`` of that generator, rounded), so that no
    float32 copy of the shard is made; zero pad rows after them."""
    n = config["n"] if n is None else n
    per, real = shard_rows(n, world, rank)
    _, centers, cdf = mixture(config, seed, device)
    gen = data.generator(shard_seed(seed, rank), device)
    out = torch.zeros((per, config["d"]), dtype=dtype, device=device)
    for lo in range(0, real, data._BLOCK_ROWS):
        hi = min(lo + data._BLOCK_ROWS, real)
        u = torch.rand(hi - lo, generator=gen, device=device, dtype=torch.float64)
        assign = torch.searchsorted(cdf, u).clamp_(max=centers.shape[0] - 1)
        x = torch.randn((hi - lo, config["d"]), generator=gen, device=device)
        x += centers[assign]
        out[lo:hi] = x
    return out


# -- the check --------------------------------------------------------------

def merge_shards(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """The k best of every shard's lists ((S, m, w) distances and global
    ids) by (distance, global id): (ids (m, k), distances (m, k))."""
    m = dists.shape[1]
    d = dists.permute(1, 0, 2).reshape(m, -1)
    i = ids.permute(1, 0, 2).reshape(m, -1)
    o = torch.argsort(i, dim=1)
    i, d = torch.gather(i, 1, o), torch.gather(d, 1, o)
    o = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return torch.gather(i, 1, o), torch.gather(d, 1, o)


def gap_numbers(ids, dists, queries, true, ref_d, med: float, n: int) -> dict:
    """``dist_err`` and ``rank_gap`` (``check.exact_numbers``) of answers
    (ids, dists) to ``queries`` as searched, given the float64 distances
    ``true`` of the returned ids and the reference's k best ``ref_d``."""
    ok = check.valid_ids(ids, n)
    s = check._scale(queries, med)[:, None]
    derr = (dists.to(reference.F64) - true).abs() / s
    gap = (torch.sort(true, 1).values - ref_d).abs() / s
    return {"dist_err": check._widest(derr, ok), "rank_gap": check._widest(gap, ok)}


# -- one rank ---------------------------------------------------------------

class RankRun(SearchRun):
    """One rank's part of a run.  Rank 0 runs the closed loop of
    ``serve.py`` and, before each batch, sends the others the signal to
    search with it (one broadcast); at the window's end the signal to stop.
    The other ranks answer each signal with the same batch.  The sync count
    is not taken (it would take a search of every rank).  ``n`` is the
    corpus's real row count, ``n_local`` a shard's rows."""

    def __init__(self, cell, seed, seconds, trace, *, mesh, fault=None, **kw):
        super().__init__(cell, seed, seconds, trace and mesh.rank == 0, device=mesh.device,
                         wrap=faults.wrap(fault) if fault else None, **kw)
        self.mesh = mesh
        self.lead = mesh.rank == 0

    # the data: this rank's rows, the queries every rank draws alike
    def draw(self):
        from approximatenn_tpu_torch.parallel.sharded import LocalRows

        cfg = self.cell.config
        self.n_true = self.sizes.get("n") or cfg["n"]
        shard = draw_shard(cfg, self.seed, self.mesh.rank, self.mesh.size, self.device,
                           self.n_true, self.storage)
        self.n_local = shard.shape[0]
        pool = draw_queries(cfg, self.seed, self.device, self.sizes.get("n_queries"))
        return LocalRows(shard, (self.n_local * self.mesh.size, cfg["d"])), pool

    @property
    def storage(self):
        """The corpus's stored type as the configuration states it."""
        return system.DTYPES[self.cell.spec.get("storage_dtype", "float32")]

    def make_engine(self, corpus, k: int):
        from approximatenn_tpu_torch.parallel.serving import ShardedServer

        kw = system.server_kwargs({**self.cell.spec, **self.control_spec().get("server", {})})
        if self.n_true != corpus.shape[0]:
            kw["n_true"] = self.n_true
        # the server is the engine: its search is a collective of every rank
        return ShardedServer.build(corpus, k, mesh=self.mesh, **kw)

    def setup(self):
        super().setup()
        self.n = self.n_true

    # rank 0's signal, one broadcast
    def _signal(self, go: bool = False) -> bool:
        t = torch.tensor([int(go)], dtype=torch.int32, device=self.device)
        dist.broadcast(t, 0, group=self.mesh.group)
        return bool(t.item())

    def _batch(self, i: int):
        if self.lead:
            self._signal(True)
        elif not self._signal():
            raise RuntimeError("rank 0 stopped before the warm-up ended")
        return super()._batch(i)

    def window(self):
        if self.lead:
            super().window()
            self._signal(False)
            return
        i, start = self.first_batch, time.perf_counter()
        while self._signal():
            SearchRun._batch(self, i)
            i += 1
        self.window_s = time.perf_counter() - start
        self.answers, self.host_s, self.latency_s, self.untraced_latency_s = [], [], [], []

    def _max_over_ranks(self, value: int) -> int:
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.group)
        return int(t.item())

    def after_window(self):
        self.syncs = None
        mine = torch.cuda.max_memory_allocated(self.device) if self.on_card else 0
        self.peak_bytes = self._max_over_ranks(mine)

    def quantities(self) -> dict:
        nq = len(self.answers) * self.cell.traffic["batch"]
        return {"exact_qps": nq / self.window_s}

    def context(self):
        ctx = super().context()
        ctx.n_local, ctx.world = self.n_local, self.mesh.size
        return ctx

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        out = t.new_empty(self.mesh.size * t.numel())
        dist.all_gather_into_tensor(out, t.contiguous().view(-1), group=self.mesh.group)
        return out.view((self.mesh.size,) + tuple(t.shape))

    def check(self) -> dict:
        """The numbers of :func:`gap_numbers` on rank 0 ({} on the others),
        every rank taking part (see the module's docstring)."""
        k, d, dev = self.cell.config["k"], self.cell.config["d"], self.device
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        if self.lead:
            ids, dd, q = self.sampled(dev)
            count[0] = ids.shape[0]
        dist.broadcast(count, 0, group=self.mesh.group)
        if not self.lead:
            m = int(count.item())
            ids = torch.empty((m, k), dtype=torch.int32, device=dev)
            dd = torch.empty((m, k), dtype=torch.float32, device=dev)
            q = torch.empty((m, d), dtype=torch.float32, device=dev)
        for t in (ids, dd, q):
            dist.broadcast(t, 0, group=self.mesh.group)
        per, real = shard_rows(self.n, self.mesh.size, self.mesh.rank)
        lo = self.mesh.rank * per
        stored = draw_shard(self.cell.config, self.seed, self.mesh.rank, self.mesh.size, dev,
                            self.n, self.storage)[:real]
        qs = check.as_searched(q, self.storage)
        med = torch.tensor([check.median_sq_norm(stored) if real else float("nan")],
                           dtype=reference.F64, device=dev)
        w = k + 8
        ref_d = torch.full((q.shape[0], w), float("inf"), dtype=reference.F64, device=dev)
        ref_i = torch.full((q.shape[0], w), self.n, dtype=torch.int64, device=dev)
        if real:
            ri, rd = reference.knn(stored, qs, w, corpus_block=REF_BLOCK)
            ref_i[:, : ri.shape[1]], ref_d[:, : rd.shape[1]] = ri + lo, rd
        # each returned id's distance, on the shard that holds its row
        g = ids.long()
        mine = (g >= lo) & (g < lo + real)
        rows = stored[(g - lo).clamp(0, max(real - 1, 0))] if real else None
        true = (torch.where(mine, reference.sqdist(qs, rows), 0.0) if real
                else torch.zeros(g.shape, dtype=reference.F64, device=dev))
        dist.all_reduce(true, group=self.mesh.group)
        meds, all_d, all_i = self._gather(med), self._gather(ref_d), self._gather(ref_i)
        if not self.lead:
            return {}
        _, merged_d = merge_shards(all_d, all_i, k)
        scale = statistics.median(v for v in meds.flatten().tolist() if v == v)
        return gap_numbers(ids, dd, qs, true, merged_d, scale, self.n)

    def run(self) -> dict:
        result = super().run()
        result["device"].update(count=self.mesh.size, memory_peak_bytes=self.peak_bytes)
        return result


def main(argv=None) -> None:
    """One rank: join the group, run, and (rank 0) print the result line."""
    from approximatenn_tpu_torch.parallel import dryrun, multihost
    from approximatenn_tpu_torch.parallel.sharded import make_mesh

    ap = dryrun.rank_parser(description="one rank of a sharded benchmark run")
    ap.add_argument("--spec", required=True, help="the run, as launch_ranks writes it")
    args = ap.parse_args(argv)
    spec = json.loads(args.spec)
    cpu = spec["device"] == "cpu"
    torch.set_num_threads(1 if cpu else 4)
    multihost.initialize(f"file://{args.store}", args.world, args.rank,
                         backend="gloo" if cpu else "nccl", timeout=GROUP_TIMEOUT_S)
    try:
        if not cpu:
            torch.cuda.set_device(args.rank)
        mesh = make_mesh(device="cpu" if cpu else None)
        cell = load_cell(spec["workload"], bench_dir=Path(spec["bench_dir"]))
        cell.config, cell.traffic, cell.limits = spec["config"], spec["traffic"], spec["limits"]
        run = RankRun(cell, spec["seed"], spec["seconds"], spec["trace"], mesh=mesh,
                      control=spec["control"], t0=spec["t0"], fault=spec["fault"],
                      sizes=spec["sizes"])
        result = run.run()
    finally:
        dist.destroy_process_group()
    if mesh.rank == 0:
        print(json.dumps({"result": result, "describe": run.describe_line}), flush=True)


def fault_name(wrap) -> str | None:
    """The fault that a ``faults.wrap(name)`` wrapper plants, by name: the
    ranks are other processes, and a function does not cross to them."""
    if wrap is None:
        return None
    names = [c.cell_contents for c in (getattr(wrap, "__closure__", None) or ())
             if isinstance(c.cell_contents, str)]
    if len(names) != 1:
        raise ValueError("a sharded run plants a fault of benchlib/faults.py:wrap only")
    return names[0]


def launch_ranks(cell, *, seed: int, seconds: float, trace: bool, control: bool, wrap,
                 t0: float, sizes: dict, device: str, world: int) -> dict:
    """Run ``cell`` on ``world`` ranks (one a card, or gloo ranks on the
    CPU when ``device`` is "cpu"); rank 0's {"result", "describe"}.  ``t0``
    is the launching process's start on ``time.perf_counter``'s clock (one
    clock for every process of the machine), from which ``setup_s`` runs."""
    from approximatenn_tpu_torch.parallel import dryrun

    spec = {"workload": cell.name, "bench_dir": str(cell.bench_dir), "config": cell.config,
            "traffic": cell.traffic, "limits": cell.limits, "seed": int(seed),
            "seconds": seconds, "trace": bool(trace), "control": bool(control),
            "fault": fault_name(wrap), "t0": t0, "sizes": sizes, "device": device}
    code = _WORKER.format(root=str(BENCH.parent), bench=str(BENCH))
    outs = dryrun.launch([sys.executable, "-c", code], world, ["--spec", json.dumps(spec)],
                         timeout=LAUNCH_S + 3 * seconds)
    return json.loads(outs[0].strip().splitlines()[-1])
