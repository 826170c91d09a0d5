"""The sharded layer across cards: one NCCL rank a card, every card of the
machine (needs two or more; marked ``cuda``, it skips without them).

Each rank runs :func:`rank_paths` at n = 200,003 x 64 (a pad row on the
last shard), 256 queries, k = 10: the exact search against the
single-card ``exact_search`` over the whole corpus (ids equal outside
near-ties, ``ids_agree``), then a ``ShardedServer`` exact int8 and one hash
packed (bf16 rows) saved and loaded on the same ranks, their searches
equal bit for bit.  A save gathers to rank 0 alone: the card memory a
save allocates is held to one shard's largest array on rank 0 and to
nothing on the other ranks (1 MiB of allocator slack each).  Then a
``ShardedServer`` exact bf16 built from each rank's own bf16 rows
(``LocalRows``, the pad row given by ``n_true``): it serves those rows
as they are, its build allocates at most one bf16 shard more (no float32
copy of the shard; 1 MiB of slack), and its answers equal the single-card
search over the same bf16 rows outside near-ties.

    python -m pytest --noconftest tests/test_torch_sharded_nccl.py -m cuda -q

The same ranks on the CPU (gloo, no memory bound), a quick check of the
script itself:

    python tests/test_torch_sharded_nccl.py --cpu-ranks 4 --n 20003
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from approximatenn_tpu_torch.parallel import dryrun

N, D, M, K = 200_003, 64, 256, 10
SLACK = 2**20  # bytes the caching allocator may round a save's small buffers to


def rank_paths(mesh, n: int, root: Path) -> dict:
    """This rank's searches, saves and loads (see the module docstring)."""
    from approximatenn_tpu_torch.harness.scoring import ids_agree
    from approximatenn_tpu_torch.ops.exact import exact_search
    from approximatenn_tpu_torch.parallel import serving as sv
    from approximatenn_tpu_torch.parallel import sharded as sh

    on_card = mesh.device.type == "cuda"
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, D), dtype=np.float32)
    Y = torch.from_numpy(rng.standard_normal((M, D), dtype=np.float32)).to(mesh.device)
    ids, _ = sh.search_exact_sharded(X, Y, K, mesh=mesh)
    g_ids, g_d = exact_search(torch.from_numpy(X).to(mesh.device), Y, K)
    out = {"rank": mesh.rank, "exact_agrees": ids_agree(ids.cpu(), g_ids.cpu(), g_d.cpu())[0],
           "max_id": int(ids.max())}
    for name, kw in (("int8", dict(mode="exact", storage_dtype=torch.int8)),
                     ("hash", dict(mode="hash", tries=4, capacity="auto", seed=0, window=32,
                                   packed_dtype=torch.bfloat16))):
        srv = sv.ShardedServer.build(X, K, mesh=mesh, **kw)
        a_ids, a_d = srv.search(Y)
        arrays = ([srv.points] if srv.mode == "exact" else
                  [getattr(srv.sidx, f) for f in ("tables", "counts", "graph", "points")]
                  + [getattr(srv.spk, f) for f in ("point_rows", "ids", "starts")])
        out[f"{name}_largest"] = max(t.numel() * t.element_size() for t in arrays)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        srv.save(root / name)
        if on_card:
            out[f"{name}_save_extra"] = torch.cuda.max_memory_allocated() - before
        back = sv.ShardedServer.load(root / name, mesh=mesh)
        b_ids, b_d = back.search(Y)
        out[f"{name}_same"] = (torch.equal(a_ids, b_ids) and torch.equal(a_d, b_d)
                               and back.describe() == srv.describe())
    # this rank's rows in bf16, the pad row last on the last rank
    per = -(-n // mesh.size)
    lo = mesh.rank * per
    rows = torch.zeros((per, D), dtype=torch.bfloat16)
    real = max(0, min(per, n - lo))
    rows[:real] = torch.from_numpy(X[lo: lo + real]).to(torch.bfloat16)
    rows = rows.to(mesh.device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    srv = sv.ShardedServer.build(sh.LocalRows(rows, (per * mesh.size, D)), K, mesh=mesh,
                                 mode="exact", storage_dtype=torch.bfloat16, n_true=n)
    if on_card:
        out["bf16_build_extra"] = torch.cuda.max_memory_allocated() - before
    out["bf16_shard"] = rows.numel() * rows.element_size()
    out["bf16_served_as_is"] = srv.points.data_ptr() == rows.data_ptr()
    b_ids, b_d = srv.search(Y)
    # the single-card search over the same bf16 rows, k + 1 to see the boundary
    o_ids, o_d = exact_search(torch.from_numpy(X).to(torch.bfloat16).to(mesh.device), Y, K + 1)
    out["bf16_agrees"] = ids_agree(b_ids.cpu(), o_ids[:, :K].cpu(), o_d.cpu())[0]
    out["bf16_max_id"] = int(b_ids.max())
    return out


def _rank_main(argv=None) -> None:
    import torch.distributed as dist

    from approximatenn_tpu_torch.parallel import multihost
    from approximatenn_tpu_torch.parallel.sharded import make_mesh

    ap = dryrun.rank_parser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    cpu = args.device == "cpu"
    if cpu:
        torch.set_num_threads(1)
    multihost.initialize(f"file://{args.store}", args.world, args.rank,
                         backend="gloo" if cpu else "nccl", timeout=300)
    try:
        mesh = make_mesh(device=args.device)
        if not cpu:
            torch.cuda.set_device(mesh.device)
        res = rank_paths(mesh, args.n, Path(args.out))
    finally:
        dist.destroy_process_group()
    print(json.dumps(res))


def run_ranks(world: int, out: Path, device: str | None = None, n: int = N) -> list[dict]:
    """``world`` ranks of :func:`rank_paths`; each rank's results."""
    extra = ["--out", str(out), "--n", str(n)] + ([] if device is None else ["--device", device])
    outs = dryrun.launch([sys.executable, str(Path(__file__).resolve()), "--rank-main"], world,
                         extra, timeout=600)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def check(res: list[dict], on_card: bool, n: int) -> None:
    for r in res:
        assert r["exact_agrees"] and r["max_id"] < n, r
        for name in ("int8", "hash"):
            assert r[f"{name}_same"], (r["rank"], name)
            if on_card:
                bound = (r[f"{name}_largest"] if r["rank"] == 0 else 0) + SLACK
                assert r[f"{name}_save_extra"] <= bound, (r["rank"], name, r)
        assert r["bf16_served_as_is"] and r["bf16_agrees"] and r["bf16_max_id"] < n, r
        if on_card:
            assert r["bf16_build_extra"] <= r["bf16_shard"] + SLACK, r


@pytest.mark.cuda
def test_nccl_ranks_search_save_and_load(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards (one NCCL rank a card)")
    check(run_ranks(torch.cuda.device_count(), tmp_path), True, N)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-main"]:
        _rank_main(sys.argv[2:])
    else:
        ap = argparse.ArgumentParser(description="the ranks on the CPU (gloo)")
        ap.add_argument("--cpu-ranks", type=int, default=4)
        ap.add_argument("--n", type=int, default=N)
        a = ap.parse_args()
        with tempfile.TemporaryDirectory() as tmp:
            res = run_ranks(a.cpu_ranks, Path(tmp), "cpu", a.n)
        check(res, False, a.n)
        print(json.dumps(res))
