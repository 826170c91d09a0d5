"""The port's ``ShardedServer`` (``approximatenn_tpu_torch/parallel/
serving.py``) against the JAX package's on the CPU: the exact, hash and
routing cases of ``tests/test_sharded_serving.py``.

The port runs in 2 gloo processes (``tests/torch_sharded_ranks.py``, suite
"serving", one launch for the file), the JAX package on a 2-device CPU
mesh.  Shapes are the dry run's: n = 64 * 2 + 1 (one zero pad row on the
last shard), d = 16, 8 queries, k = 4, 2 tables, capacity 16; the hash
builds take the JAX server's bases (``jax.random`` cannot be drawn in
torch).  The port keeps the corpus at its logical width d where the JAX
two-phase staging pads it to 128 lanes (TPU layout, not ported:
``ROADMAP.md`` §A).

Reference faults ported as intended, each held to a float64 brute force
instead of JAX: C-A7-1, the two-phase knobs, which the JAX server forwards
to a ``search_exact_sharded`` without them (``approximatenn_tpu/parallel/
serving.py:225-235``, ``parallel/sharded.py:1127-1132``); C-A7-2, auto
mode at k > 128, which JAX sends to hash (``parallel/serving.py:138-140``).

Tolerance (``torch_sharded_ranks.assert_parity``): ids the same set per row
outside near-ties (adjacent reference distances within 1e-5 relative),
every distance within 1024 float32 ULPs; ``describe()`` equal key for key
(``index_mb`` excepted: JAX counts its 128 padded lanes); the int8 scale
equal exactly.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from approximatenn_tpu.engine.build import sample_bases
from approximatenn_tpu.ops.transforms import derive_dims
from approximatenn_tpu.parallel import sharded as jsh
from approximatenn_tpu.parallel.serving import ShardedServer as JServer
from approximatenn_tpu_torch.parallel import sharded as sh
from approximatenn_tpu_torch.parallel.serving import ShardedServer
from torch_sharded_ranks import CAP, D, K, M, N, TRIES, assert_parity, brute, ok, start_suite

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Y = rng.standard_normal((M, D)).astype(np.float32)
    X75 = (rng.standard_normal((75, D)) + 3.0).astype(np.float32)
    Y0 = (0.01 * rng.standard_normal((M, D))).astype(np.float32)
    Xbig = rng.standard_normal((8 * 202 * 2 + 6, 8)).astype(np.float32)
    Ybig = rng.standard_normal((M, 8)).astype(np.float32)
    # the bases JAX's hash build draws at seed 0 (its parallel/sharded.py:241-247)
    d_short, _ = derive_dims(-(-N // 2), K, D)
    bases = sample_bases(jax.random.key(0), D, d_short, TRIES, 6, 1, 1, 1, jnp.float32)
    return dict(X=X, Y=Y, X75=X75, Y0=Y0, Xbig=Xbig, Ybig=Ybig, bases=np.asarray(bases),
                mesh=jsh.make_mesh(2))


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    inputs = {key: data[key] for key in ("X", "Y", "X75", "Y0", "Xbig", "Ybig", "bases")}
    return start_suite("serving", inputs, tmp_path_factory.mktemp("serving"))


@pytest.fixture(scope="module")
def ref(data, ranks):
    X, Y, mesh = data["X"], data["Y"], data["mesh"]
    r = {}
    for name, kw in (("auto", {}), ("tp", {"twophase_min_n": 16}),
                     ("int8", {"storage_dtype": jnp.int8}),
                     ("bf16", {"storage_dtype": jnp.bfloat16}),
                     ("angular", {"mode": "exact", "metric": "angular"})):
        srv = JServer.build(X, K, mesh=mesh, **kw)
        # the two-phase staging serves through the Pallas engines in interpret mode
        r[name] = srv.search(Y, interpret=True) if name == "tp" else srv.search(Y)
        r[f"{name}_desc"] = srv.describe()
        if name == "int8":
            r["int8_scale"] = np.asarray(srv.scale)
        if name == "tp":
            r["tp_width"] = srv.points.shape[1]
    r["pad"] = JServer.build(data["X75"], 5, mesh=mesh, mode="exact").search(data["Y0"])
    jh = JServer.build(X, K, mesh=mesh, mode="hash", tries=TRIES, seed=0, capacity=CAP)
    r["bases"] = np.asarray(jh.sidx.bases)
    r["packed"], r["packed_desc"] = jh.search(Y), jh.describe()
    # the table layout over the same build (a JAX build costs ~15 s here)
    table = dataclasses.replace(jh, spk=None)
    r["table"], r["table_desc"] = table.search(Y), table.describe()
    return r


@pytest.fixture(scope="module")
def port(ranks):
    return ranks.result()


def pair(out, key):
    return out[f"{key}_ids"], out[f"{key}_dd"]


@pytest.mark.parametrize("case", ["auto", "int8", "bf16", "angular"])
def test_exact_server_matches_jax(ref, port, case):
    """Auto (exact, the rank route), the int8 tier with one global scale,
    the bf16 tier (both rank their stored values in float32) and the
    angular metric, against the JAX ShardedServer: ids and distances in the
    band, ``describe()`` equal."""
    for out in port:
        ok(out, "server_exact")
        assert_parity(*pair(out, f"server_exact.{case}"), *ref[case])
        assert json.loads(str(out[f"server_exact.{case}_desc"])) == ref[f"{case}_desc"]
    if case == "auto":
        assert ref["auto_desc"]["mode"] == "exact" and ref["auto_desc"]["exact_engine"] == "rank"
        assert ref["auto_desc"]["recall"] == 1.0


def test_int8_scale_equals_jax(ref, port):
    for out in port:
        ok(out, "server_exact")
        scale = out["server_exact.int8_scale"]
        assert scale.dtype == np.float32 and scale == ref["int8_scale"]
    assert json.loads(str(port[0]["server_exact.int8_desc"]))["recall"] is None


def test_twophase_staged_matches_jax_interpret(ref, port):
    """``twophase_min_n=16`` stages the two-phase engine (both servers
    report ``_twophase``); the JAX server's search in interpret mode (its
    emit and rescan kernels) is the reference.  The port's CPU mesh serves
    the rank route at width d, where JAX pads to 128 lanes (ROADMAP.md §A);
    ``describe()`` reports the same logical d."""
    assert ref["tp_width"] == 128
    for r, out in enumerate(port):
        ok(out, "server_exact")
        ok(out, "server_twophase")
        assert tuple(out["server_twophase.staged"]) == (1, 65, D)
        assert_parity(*pair(out, "server_exact.tp"), *ref["tp"])
        assert json.loads(str(out["server_exact.tp_desc"])) == ref["tp_desc"]


def test_twophase_knobs_stripped_on_the_rank_route(ref, port):
    """``no_twophase=True, seg=16`` and the knobs alone on a CPU mesh: the
    rank route drops them and serves the same neighbours (the JAX test's
    escape hatch); ``seg=15``, which the two-phase engine refuses, too."""
    for out in port:
        ok(out, "server_twophase")
        for key in ("stripped", "stripped_tp", "stripped_bad"):
            assert_parity(*pair(out, f"server_twophase.{key}"), *ref["tp"])


def test_twophase_knobs_forwarded(data, port):
    """C-A7-1 (``approximatenn_tpu/parallel/serving.py:225-235``: the JAX
    server forwards ``seg``/``pad_segments``/``rescan`` to a function that
    has none, a ``TypeError``; skipped against JAX).  With the two-phase
    route forced on the CPU mesh, the port runs the engine's plain version
    with them; held to a float64 brute force.  That they reach the engine:
    ``seg=15`` on the forced route raises the engine's ``ValueError`` (not a
    power of two), where the rank route drops it."""
    want = brute(data["X"], data["Y"], K)
    for out in port:
        ok(out, "server_twophase")
        assert_parity(*pair(out, "server_twophase.forced"), *want)
        assert str(out["server_twophase.forced_bad"]).startswith("ValueError: seg must be")


def test_indivisible_n_pads_masked(data, ref, port):
    """n = 75 over 2 ranks: 38 rows each, the last shard's zero pad row
    never served to near-origin queries; against JAX and a brute force."""
    want = brute(data["X75"], data["Y0"], 5)
    for out in port:
        ok(out, "server_pads")
        assert int(out["server_pads.rows"]) == 38
        ids, dd = pair(out, "server_pads.pad")
        assert (ids < 75).all()
        assert_parity(ids, dd, *ref["pad"])
        assert_parity(ids, dd, *want)


@pytest.mark.parametrize("case", ["packed", "table", "auto"])
def test_hash_server_matches_jax(ref, port, case):
    """Hash mode over the JAX bases: the packed layout (CPU mesh: the
    plain packed search, JAX's "xla" route), the table layout, and auto
    resolving to hash under ``exact_max_n=32`` (the packed server's build,
    so held to it); ids and distances in the band, ``describe()`` equal but
    ``index_mb``."""
    np.testing.assert_array_equal(ref["bases"], port[0]["server_hash.bases"])
    want = "packed" if case == "auto" else case
    for out in port:
        ok(out, "server_hash")
        assert_parity(*pair(out, f"server_hash.{case}"), *ref[want])
        mine, theirs = json.loads(str(out[f"server_hash.{case}_desc"])), dict(ref[f"{want}_desc"])
        if case != "table":  # JAX's view is wider (128 lanes): no more MB here
            assert 0 <= mine.pop("index_mb") <= theirs.pop("index_mb")
        assert mine == theirs and mine["mode"] == "hash"
    assert json.loads(str(port[0]["server_hash.packed_desc"]))["layout"] == "packed"
    assert json.loads(str(port[0]["server_hash.table_desc"]))["layout"] == "table"


def test_auto_keeps_big_k_exact(data, port):
    """C-A7-2 (``approximatenn_tpu/parallel/serving.py:138-140``: the JAX
    server sends every k > 128 to hash; skipped against JAX): at k = 200
    with n_local >= 8 * (k + 2) auto stays exact, the single-card rule, and
    both it and ``search_exact_sharded`` serve the float64 brute force."""
    want = brute(data["Xbig"], data["Ybig"], 200)
    for out in port:
        ok(out, "server_big_k")
        desc = json.loads(str(out["server_big_k.desc"]))
        assert desc["mode"] == "exact" and desc["n_local"] >= 8 * 202
        for key in ("server", "raw"):
            assert_parity(*pair(out, f"server_big_k.{key}"), *want)


def test_route_twophase_predicate():
    """The predicate ``search`` and ``describe`` share, on a one-rank mesh
    in this process (no collective in an f32 exact build): a CPU mesh runs
    the rank route; a stand-in CUDA mesh (the predicate reads only its
    device) takes the two-phase engine unless ``no_twophase``, k + 2 > 128
    or a build below ``twophase_min_n``."""
    X = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    cpu = sh.Mesh(group=None, rank=0, size=1, device=torch.device("cpu"))
    srv = ShardedServer.build(X, 10, mesh=cpu, twophase_min_n=32)
    assert srv.mode == "exact" and srv._twophase and not srv._route_twophase(10)
    assert srv.describe()["exact_engine"] == "rank"
    card = dataclasses.replace(srv, mesh=dataclasses.replace(cpu, device=torch.device("cuda")))
    assert card._route_twophase(10) and card.describe()["exact_engine"] == "twophase"
    assert not card._route_twophase(10, no_twophase=True)
    assert not card._route_twophase(127)
    assert not dataclasses.replace(card, _twophase=False)._route_twophase(10)
    assert not ShardedServer.build(X, 10, mesh=cpu, twophase_min_n=65)._twophase
    assert not ShardedServer.build(X, 127, mesh=cpu, twophase_min_n=32)._twophase
    assert not ShardedServer.build(X, 10, mesh=cpu, twophase_min_n=32,
                                   storage_dtype=torch.float64)._twophase


def test_rejects_bad_arguments():
    X = np.zeros((16, 4), np.float32)
    one = sh.Mesh(group=None, rank=0, size=1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="mode"):
        ShardedServer.build(X, 2, mesh=one, mode="banana")
    with pytest.raises(ValueError, match="exact"):
        ShardedServer.build(X, 2, mesh=one, mode="hash", storage_dtype=torch.int8)
    srv = ShardedServer.build(X, 2, mesh=one, mode="exact")
    for kw in ({"interpret": True}, {"query_block": 32}):
        with pytest.raises(ValueError, match="TPU"):
            srv.search(X, **kw)
