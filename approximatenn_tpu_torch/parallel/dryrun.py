"""The sharded layer end to end in a few processes on one machine (the
port's counterpart of ``__graft_entry__.py:dryrun_multichip``), and the
launcher that joins such processes.

    python -c "from approximatenn_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(2)"            # on the card
    ... dryrun_multichip(2, device="cpu")                  # on the CPU

:func:`launch` starts ``n`` processes of one command, each with ``--rank
r --world n --store <file>`` appended, joined by one file store; every
rank calls :func:`join` on those arguments.  Ranks use gloo, so several
can share one card (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

_ROOT = Path(__file__).resolve().parents[2]


def launch(argv, n: int, extra=(), *, timeout: float = 600.0) -> list[str]:
    """Run ``argv + [--rank r --world n --store <file>] + extra`` as ``n``
    processes joined by one file store; return each rank's standard output.
    The package's root leads the children's PYTHONPATH.  Raises
    ``RuntimeError`` with the end of a failed rank's standard error, or
    after ``timeout`` seconds; no process outlives the call (when one rank
    fails, the others, which may wait in a collective, are killed)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(_ROOT), env.get("PYTHONPATH")) if p)
    deadline = time.monotonic() + timeout
    timed_out = False
    with tempfile.TemporaryDirectory(prefix="ann_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        logs = [(open(os.path.join(tmp, f"out{r}"), "w+"),
                 open(os.path.join(tmp, f"err{r}"), "w+")) for r in range(n)]
        procs = []
        try:
            for r, (out, err) in enumerate(logs):
                procs.append(subprocess.Popen(
                    [*argv, "--rank", str(r), "--world", str(n), "--store", store, *extra],
                    stdout=out, stderr=err, env=env))
            while True:
                codes = [p.poll() for p in procs]
                if None not in codes or any(c not in (None, 0) for c in codes):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            texts = []
            for out, err in logs:
                out.seek(0)
                err.seek(0)
                texts.append((out.read(), err.read()))
                out.close()
                err.close()
    if timed_out:
        raise RuntimeError(f"{n} ranks of {argv} did not finish in {timeout} s; rank 0's "
                           f"standard error:\n{texts[0][1][-3000:]}")
    # the rank that failed first, not one killed after it
    bad = ([r for r, p in enumerate(procs) if p.returncode not in (0, -9)]
           or [r for r, p in enumerate(procs) if p.returncode != 0])
    if bad:
        r = bad[0]
        raise RuntimeError(f"rank {r} of {n} failed (exit code {procs[r].returncode}):\n"
                           f"{texts[r][1][-3000:]}")
    return [out for out, _ in texts]


def rank_parser(**kw) -> argparse.ArgumentParser:
    """A parser for the arguments :func:`launch` appends."""
    ap = argparse.ArgumentParser(**kw)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    return ap


def join(args, *, timeout: float = 300.0) -> None:
    """This rank's gloo process group on :func:`launch`'s file store, one
    torch thread (the ranks share the machine's cores)."""
    from .multihost import initialize

    torch.set_num_threads(1)
    initialize(f"file://{args.store}", args.world, args.rank, backend="gloo",
               timeout=timeout)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


DRYRUN_STEPS = ("hash-graph build and search", "exact-graph build and search",
                "packed search", "exact search", "fused packed search",
                "ShardedServer exact two-phase", "ShardedServer hash packed")


def dryrun_steps(mesh) -> None:
    """One distributed step of each kind (``DRYRUN_STEPS``) on tiny shapes,
    with the JAX dry run's checks: the hash-graph build with a pad row and
    chunks of 24 rows, its search with rerank 8 and 2 supercharge rounds;
    the exact-graph build and its search; the packed view and its search;
    the exact search; the fused packed search at window 8; a
    ``ShardedServer`` exact with ``twophase_min_n=1`` (staged for the
    two-phase engine, which a card mesh runs) serving ids < n, and one in
    hash mode serving through the packed layout."""
    from .serving import ShardedServer
    from .sharded import (build_sharded, packed_sharded, search_exact_sharded,
                          search_packed_fused_sharded, search_packed_sharded, search_sharded)

    s = mesh.size
    rng = np.random.default_rng(0)
    n = 64 * s + s // 2  # not a multiple of the shard count: a pad row
    points = rng.standard_normal((n, 16)).astype(np.float32)
    queries = rng.standard_normal((8, 16)).astype(np.float32)

    def ok_ids(ids, hi):
        _check(tuple(ids.shape) == (8, 4), f"ids of shape {tuple(ids.shape)}")
        _check(int(ids.min()) >= 0 and int(ids.max()) <= hi, f"ids outside [0, {hi}]")

    sidx = build_sharded(points, 4, mesh=mesh, tries=2, capacity=16, seed=0,
                         graph_mode="hash", chunked=True, chunk_rows=24)
    ids, _ = search_sharded(sidx, points, queries, mesh=mesh, rerank_width=8,
                            supercharge_rounds=2)
    ok_ids(ids, n)
    sidx_x = build_sharded(points, 4, mesh=mesh, tries=2, capacity=16, seed=0,
                           graph_mode="exact", chunk_rows=24)
    ok_ids(search_sharded(sidx_x, points, queries, mesh=mesh, chunked=True)[0], n)
    spk = packed_sharded(sidx, points, mesh=mesh)
    ok_ids(search_packed_sharded(sidx, spk, points, queries, mesh=mesh)[0], n)
    ok_ids(search_exact_sharded(points, queries, 4, mesh=mesh)[0], n - 1)
    ok_ids(search_packed_fused_sharded(sidx, spk, points, queries, mesh=mesh,
                                       window=8)[0], n)
    ssrv = ShardedServer.build(points, 4, mesh=mesh, mode="exact", twophase_min_n=1)
    _check(ssrv._twophase, "ShardedServer with twophase_min_n=1 is not staged for two-phase")
    ok_ids(ssrv.search(queries)[0], n - 1)
    hsrv = ShardedServer.build(points, 4, mesh=mesh, mode="hash", tries=2, capacity=16, seed=0)
    ok_ids(hsrv.search(queries)[0], n)
    _check(hsrv.describe()["layout"] == "packed", "ShardedServer hash is not packed")


def dryrun_multichip(n_devices: int, device: str | None = None,
                     timeout: float = 600.0) -> list[str]:
    """Start ``n_devices`` gloo ranks on one file store and run
    :func:`dryrun_steps` on their mesh: every rank on the card ``rank %
    device_count`` by default, on the CPU when ``device="cpu"``.  Without a
    card and without that request this raises, as ``make_mesh`` does;
    it raises too if a rank fails.  Returns each rank's standard output,
    whose last line names the steps it ran."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' to run the dry run on the CPU")
    return launch([sys.executable, "-m", "approximatenn_tpu_torch.parallel.dryrun"], n_devices,
                  [] if device is None else ["--device", device], timeout=timeout)


def main(argv=None) -> None:
    import torch.distributed as dist

    from .sharded import make_mesh

    ap = rank_parser(description="one rank of dryrun_multichip")
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    join(args)
    try:
        dryrun_steps(make_mesh(device=None if args.device == "cuda" else args.device))
    finally:
        dist.destroy_process_group()
    print(f"rank {args.rank}: ok ({', '.join(DRYRUN_STEPS)})")


if __name__ == "__main__":
    main()
