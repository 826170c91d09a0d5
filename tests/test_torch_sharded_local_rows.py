"""``ShardedServer`` exact built from each rank's own bf16 rows
(``LocalRows``), the serving shape of a corpus that no one card holds, in
four gloo ranks on the CPU; and the per-shard draw of the benchmark's
sharded kind (``benchmark/benchlib/sharded.py``).

The ranks hold 4 x 20,001 rows of width 96, the last shard 20,000 and a
zero pad row (``n_true``); queries near the data and near the origin.  The
served answers, on the two-phase engine (which a card mesh takes, forced
here) and on the rank route (a CPU mesh's), are held to the benchmark's
plain float64 reference: each shard ranked on its own
(``reference.knn``), the shards' lists merged by (distance, global id)
(``sharded.merge_shards``).  No JAX here.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from approximatenn_tpu_torch.harness.scoring import ids_agree
from approximatenn_tpu_torch.parallel import dryrun

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from benchlib import check, data, reference, sharded  # noqa: E402

WORLD, PER, D, M, K = 4, 20_001, 96, 48, 10
N = WORLD * PER - 1  # one zero pad row on the last shard
SEED = 2**31 + 29


def _corpus():
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.standard_normal((N, D), dtype=np.float32)).to(torch.bfloat16)
    Y = rng.standard_normal((M, D), dtype=np.float32)
    Y[: M // 4] *= 1e-3  # near the origin, where the pad row lies
    return X, torch.from_numpy(Y)


def rank_case(mesh, out_dir: Path) -> dict:
    """This rank's servers over its own bf16 rows (see the module docstring)."""
    from approximatenn_tpu_torch.parallel import serving as sv
    from approximatenn_tpu_torch.parallel import sharded as sh

    X, Y = _corpus()
    lo = mesh.rank * PER
    rows = torch.zeros((PER, D), dtype=torch.bfloat16)
    real = min(PER, N - lo)
    rows[:real] = X[lo: lo + real]
    local = sh.LocalRows(rows, (PER * mesh.size, D))
    srv = sv.ShardedServer.build(local, K, mesh=mesh, mode="exact",
                                 storage_dtype=torch.bfloat16, n_true=N)
    out = {"served_as_is": srv.points.data_ptr() == rows.data_ptr(),
           "describe": srv.describe()}
    rank_ids, _ = srv.search(Y)
    srv._route_twophase = lambda *a, **kw: True
    tp_ids, tp_d = srv.search(Y)
    # int8 from this rank's bf16 rows: the server built from the whole
    # corpus (its global-array path) stores the same rows and scale
    q8 = sv.ShardedServer.build(local, K, mesh=mesh, mode="exact", storage_dtype=torch.int8,
                                n_true=N)
    g8 = sv.ShardedServer.build(X, K,
                                mesh=mesh, mode="exact", storage_dtype=torch.int8)
    out["int8_same"] = bool(torch.equal(q8.points, g8.points) and q8.scale == g8.scale)
    torch.save({"rank_ids": rank_ids, "tp_ids": tp_ids, "tp_d": tp_d},
               out_dir / f"rank{mesh.rank}.pt")
    return out


def _rank_main(argv=None) -> None:
    import torch.distributed as dist

    from approximatenn_tpu_torch.parallel.sharded import make_mesh

    ap = dryrun.rank_parser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    dryrun.join(args, timeout=120)
    try:
        res = rank_case(make_mesh(device="cpu"), Path(args.out))
    finally:
        dist.destroy_process_group()
    print(json.dumps(res))


def _reference(X, Y, rounded: bool = True):
    """The float64 reference of the benchmark's sharded check: each shard's
    k + 8 best, merged by (distance, global id); the queries rounded to
    bf16 as the two-phase engine multiplies them, or as given."""
    q = check.as_searched(Y, torch.bfloat16) if rounded else Y
    ds, ids = [], []
    for r in range(WORLD):
        lo = r * PER
        i, d = reference.knn(X[lo: lo + PER], q, K + 8)
        ds.append(d)
        ids.append(i + lo)
    return sharded.merge_shards(torch.stack(ds), torch.stack(ids), K)


def test_local_rows_bf16_on_four_ranks_match_the_float64_reference(tmp_path):
    outs = dryrun.launch([sys.executable, str(Path(__file__).resolve()), "--rank-main"],
                         WORLD, ["--out", str(tmp_path)], timeout=300)
    res = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    for r in res:
        assert r["served_as_is"] and r["int8_same"], r
        assert r["describe"]["n"] == N and r["describe"]["n_local"] == PER
        assert r["describe"]["storage_dtype"] == "bfloat16"
    X, Y = _corpus()
    ref_i, ref_d = _reference(X, Y)
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    for g in got[1:]:  # every rank returns the same answers
        assert all(torch.equal(g[key], got[0][key]) for key in g)
    g = got[0]
    # the CPU mesh's rank route ranks the float32 queries as given
    for name, (ri, rd) in (("tp_ids", (ref_i, ref_d)),
                           ("rank_ids", _reference(X, Y, rounded=False))):
        ids = g[name]
        assert int(ids.max()) < N, name  # never the pad row
        assert ids_agree(ids, ri.int(), rd.float(), rtol=1e-5)[0], name
    # the two-phase engine's distances: fp32 sums over the bf16 rows
    np.testing.assert_allclose(g["tp_d"].double().numpy(), ref_d.numpy(), rtol=1e-5, atol=1e-5)


def _config(n: int) -> dict:
    cfg = json.loads((BENCH / "configs" / "deep-1b-bf16.json").read_text())
    return dict(cfg, n=n, n_queries=50)


def test_shard_draw_is_deterministic_per_seed_and_rank():
    """Each shard is drawn from the seed and its rank alone, as
    ``data._draw`` draws the configured mixture from that shard's
    generator, rounded to bf16 block by block; the shards together hold the
    configured n rows and zero pad rows after them; the queries are the
    same whichever rank draws them."""
    n = 10_003
    cfg = _config(n)
    shards = [sharded.draw_shard(cfg, SEED, r, WORLD, "cpu", dtype=torch.bfloat16)
              for r in range(WORLD)]
    per = -(-n // WORLD)
    assert [s.shape for s in shards] == [(per, D)] * WORLD
    assert torch.equal(sharded.draw_shard(cfg, SEED, 2, WORLD, "cpu", dtype=torch.bfloat16),
                       shards[2])
    assert not torch.equal(sharded.draw_shard(cfg, SEED + 1, 2, WORLD, "cpu",
                                              dtype=torch.bfloat16), shards[2])
    assert not torch.equal(shards[1], shards[2])
    reals = [sharded.shard_rows(n, WORLD, r)[1] for r in range(WORLD)]
    assert sum(reals) == n and reals[-1] == per - 1
    assert not shards[-1][-1].any()
    _, centers, cdf = sharded.mixture(cfg, SEED, "cpu")
    for r, s in enumerate(shards):
        gen = data.generator(sharded.shard_seed(SEED, r), "cpu")
        want = data._draw(gen, centers, cdf, reals[r]).to(torch.bfloat16)
        assert torch.equal(s[: reals[r]], want), r
    q = sharded.draw_queries(cfg, SEED, "cpu")
    assert q.shape == (50, D) and torch.equal(q, sharded.draw_queries(cfg, SEED, "cpu"))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-main"]:
        _rank_main(sys.argv[2:])
