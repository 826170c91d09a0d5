"""The port's sharded checkpoints (``approximatenn_tpu_torch/parallel/
checkpoint.py``, ``ShardedServer.save``/``load``) and ``tune_sharded``
(``parallel/serving.py``) on the CPU, against the JAX package's.

The port runs in 2 gloo processes (``tests/torch_sharded_ranks.py``, suite
"checkpoint", one launch for the file), the JAX package on a 2-device CPU
mesh; the dry run's shapes (n = 64 * 2 + 1, d = 16, 8 queries, k = 4, 2
tables, capacity 16).  The JAX package writes its npz layout where orbax
is not importable, so its checkpoints here are written with
``orbax.checkpoint`` hidden from it (the JAX files are not edited): an
index, its packed view (rows lane-padded to 128) and two servers (exact
int8 on the two-phase staging, padded to 128 lanes, and hash), which the
port loads and serves.  A checkpoint the port writes loads in the JAX
package's ``load_sharded_index`` / ``load_sharded_packed``.

Tolerance: loaded state equal to the saved state bit for bit, searches
before and after equal bit for bit; the port serving a JAX checkpoint holds
JAX's ids and distances within ``torch_sharded_ranks.assert_parity``'s
band (ids the same set per row outside near-ties, distances within 1024
float32 ULPs); a port checkpoint read by JAX gives equal arrays.

``tune_sharded`` holds the intended behaviour of two reference faults:
C-A7-3, recall scored on every query of the sample in batches of ``batch``
(the JAX tuner scores ``min(batch, m)`` of them,
``approximatenn_tpu/parallel/serving.py:502-503``), and C-A7-4, one exact
tier's corpus resident at a time (the JAX tuner keeps every tier's,
``parallel/serving.py:516-535``).  Neither has a JAX counterpart here.
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from approximatenn_tpu.parallel import checkpoint as jck
from approximatenn_tpu.parallel import sharded as jsh
from approximatenn_tpu.parallel.serving import ShardedServer as JServer
from approximatenn_tpu_torch.parallel import checkpoint as ck
from approximatenn_tpu_torch.parallel import sharded as sh
from approximatenn_tpu_torch.parallel.serving import ShardedServer
from torch_sharded_ranks import CAP, D, K, M, N, TRIES, assert_parity, ok, start_suite

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's checkpoints, written as it writes them without
    orbax, and its searches of them."""
    rng = np.random.default_rng(7)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Y = rng.standard_normal((M, D)).astype(np.float32)
    Xtune = rng.standard_normal((640, D)).astype(np.float32)
    root = tmp_path_factory.mktemp("jax_ckpt")
    mesh = jsh.make_mesh(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "orbax.checkpoint", None)
        jh = jsh.build_sharded(X, K, mesh=mesh, tries=TRIES, capacity=CAP, seed=0,
                               store_points=True)
        jsp = jsh.packed_sharded(jh, mesh=mesh)
        jck.save_sharded_index(jh, root / "index")
        jck.save_sharded_packed(jsp, root / "packed")
        exact = JServer.build(X, K, mesh=mesh, storage_dtype=jnp.int8, twophase_min_n=16)
        exact.save(root / "srv_exact")
        # the hash server over the same build (what ShardedServer.build makes)
        hashed = JServer(mesh=mesh, k=K, mode="hash", n=N, d_logical=D, sidx=jh, spk=jsp)
        hashed.save(root / "srv_hash")
    assert json.loads((root / "index" / "meta.json").read_text())["format"] == "npz"
    return dict(X=X, Y=Y, Xtune=Xtune, root=root, mesh=mesh, jh=jh, jsp=jsp, exact=exact,
                hashed=hashed)


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("port_ckpt")
    inputs = dict(X=jax_side["X"], Y=jax_side["Y"], Xtune=jax_side["Xtune"],
                  jax_dir=np.array(str(jax_side["root"])), out_dir=np.array(str(out_dir)))
    return start_suite("checkpoint", inputs, tmp_path_factory.mktemp("ckpt")), out_dir


@pytest.fixture(scope="module")
def ref(jax_side, ranks):
    j, Y, mesh = jax_side, jax_side["Y"], jax_side["mesh"]
    return dict(
        index=jsh.search_sharded(j["jh"], None, Y, mesh=mesh),
        packed=jsh.search_packed_sharded(j["jh"], j["jsp"], None, Y, mesh=mesh),
        srv_exact=j["exact"].search(Y), srv_exact_desc=j["exact"].describe(),
        srv_hash_desc=j["hashed"].describe())


@pytest.fixture(scope="module")
def port(ranks):
    return ranks[0].result()


def test_index_and_packed_roundtrip(port):
    """The port's index and packed views (bf16 rows, int8 rows with their
    scale) saved and loaded on 2 ranks: every field equal, searches equal."""
    for out in port:
        ok(out, "ckpt_own")
        assert bool(out["ckpt_own.index_same"])
        for name in ("bf16", "int8"):
            assert bool(out[f"ckpt_own.packed_{name}_same"]), name


@pytest.mark.parametrize("mode", ["exact", "hash"])
def test_server_roundtrip(port, mode):
    """``ShardedServer.save``/``load`` of the exact int8 server staged for
    two-phase (``twophase_min_n=16``) and of the hash packed server:
    ``describe()``, ``_twophase`` and the searches equal (the JAX package's
    ``TestShardedServerCheckpoint``)."""
    for out in port:
        ok(out, "ckpt_own")
        assert bool(out[f"ckpt_own.srv_{mode}_same"])
    assert str(port[0][f"ckpt_own.srv_{mode}_dtype"]) == (
        "torch.int8" if mode == "exact" else "torch.float32")


@pytest.mark.parametrize("case", ["index", "packed", "srv_exact", "srv_hash"])
def test_jax_checkpoint_serves_jax_ids(ref, port, case):
    """A JAX npz checkpoint loads in the port and serves JAX's ids: the
    index (table search), its packed view (JAX rows padded to 128 lanes,
    loaded at d = 16), and the two servers (the exact int8 corpus padded to
    128 lanes, loaded at d = 16; ``describe()`` equal but the hash view's
    ``index_mb``, which JAX counts at 128 lanes)."""
    want = ref["packed"] if case == "srv_hash" else ref[case]
    for out in port:
        ok(out, "ckpt_jax")
        assert int(out["ckpt_jax.packed_width"]) == D
        assert_parity(out[f"ckpt_jax.{case}_ids"], out[f"ckpt_jax.{case}_dd"], *want)
        if case.startswith("srv_"):
            mine = json.loads(str(out[f"ckpt_jax.{case}_desc"]))
            theirs = dict(ref[f"{case}_desc"])
            if case == "srv_hash":
                assert 0 <= mine.pop("index_mb") <= theirs.pop("index_mb")
            assert mine == theirs


def test_port_checkpoint_loads_in_jax(jax_side, ranks, port):
    """The port's ``save_sharded_index`` and ``save_sharded_packed`` read
    by the JAX package's loaders: equal arrays."""
    out_dir, mesh = ranks[1], jax_side["mesh"]
    out = port[0]
    ok(out, "ckpt_own")
    j = jck.load_sharded_index(out_dir / "index", mesh)
    for f in ("row_means", "bases", "tables", "counts", "graph", "points"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)), out[f"ckpt_own.index_{f}"])
    assert [j.n, j.n_local, j.k, j.d, j.d_short, j.tries, j.tmax, j.n_shards] == \
        out["ckpt_own.index_meta"].tolist()
    for name in ("bf16", "int8"):
        p = jck.load_sharded_packed(out_dir / f"packed_{name}", mesh)
        assert p.d_pad == D
        rows = np.asarray(p.point_rows.astype(jnp.float32) if name == "bf16" else p.point_rows)
        np.testing.assert_array_equal(rows.reshape(-1, D), np.concatenate(
            [o[f"ckpt_own.packed_{name}_rows"] for o in port]))
        assert (p.scale is not None) == (name == "int8")


def test_refuses_other_shard_counts_and_orbax(jax_side, tmp_path):
    """A 2-shard checkpoint onto a one-rank mesh, and an orbax checkpoint,
    raise ``ValueError`` before any array is read."""
    root = jax_side["root"]
    one = sh.Mesh(group=None, rank=0, size=1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="shards"):
        ck.load_sharded_index(root / "index", one)
    with pytest.raises(ValueError, match="shards"):
        ck.load_sharded_packed(root / "packed", one, d=D)
    for name, meta_file in (("index", "meta.json"), ("srv_exact", "server.json")):
        (tmp_path / name).mkdir()
        meta = json.loads((root / name / meta_file).read_text())
        (tmp_path / name / meta_file).write_text(json.dumps({**meta, "format": "orbax"}))
    with pytest.raises(ValueError, match="orbax"):
        ck.load_sharded_index(tmp_path / "index", one)
    with pytest.raises(ValueError, match="orbax"):
        ShardedServer.load(tmp_path / "srv_exact", mesh=one)


def test_jax_half_float_points_load(jax_side, tmp_path):
    """A JAX index storing bf16 points: its save writes them untagged, and
    numpy stores such an array as raw 2-byte records; the port reads them
    as bf16 by ``points_dtype``.  Rank 0's slice, loaded in this process
    (a load needs no collective)."""
    root = jax_side["root"] / "index"
    meta = json.loads((root / "meta.json").read_text())
    with np.load(root / "arrays.npz") as z:
        arrays = {key: z[key] for key in z.files}
    arrays["points"] = np.asarray(jnp.asarray(arrays["points"], jnp.bfloat16))
    np.savez(tmp_path / "arrays.npz", **arrays)
    (tmp_path / "meta.json").write_text(json.dumps({**meta, "points_dtype": "bfloat16"}))
    assert np.load(tmp_path / "arrays.npz")["points"].dtype.kind == "V"
    s = ck.load_sharded_index(tmp_path, sh.Mesh(None, 0, 2, torch.device("cpu")))
    assert s.points.dtype == torch.bfloat16
    np.testing.assert_array_equal(s.points.float().numpy(),
                                  arrays["points"][: s.n_local].astype(np.float32))


def test_tune_sharded_on_a_cpu_mesh(port):
    """Trials through ``ShardedServer.search`` on the 2-rank mesh, ranked by
    the cost proxy (``measured`` false); the exact trial's recall 1.0;
    ``report.server()`` serves.  C-A7-3: with 32 queries in batches of 12,
    every trial's recall pass searches 12 + 12 + 8 rows.  C-A7-4: with the
    f32 and bf16 tiers, no exact server is alive when the next is built."""
    for out in port:
        ok(out, "tune")
        rep = json.loads(str(out["tune.report"]))
        assert not rep["measured"] and rep["sharded"] and rep["batch"] == 12
        trials = rep["trials"]
        assert [t["engine"] for t in trials] == ["exact", "exact", "packed"]
        assert trials[0]["recall"] == 1.0 and trials[1]["storage_dtype"] == "bf16"
        assert out["tune.batches"].tolist() == [12, 12, 8] * len(trials)
        assert set(out["tune.alive_at_build"].tolist()) == {0}
        assert out["tune.server_ids"].shape == (8, 5)
        assert str(out["tune.server_mode"]) == ("exact" if rep["best"]["engine"] == "exact"
                                                else "hash")
