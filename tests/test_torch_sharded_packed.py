"""The port's sharded packed views, their plain search and the global graph
(``approximatenn_tpu_torch/parallel/sharded.py``) against the JAX package's
on the CPU.

One JAX exact-graph index on a 2-device CPU mesh (n = 64 * 2 + 1, d = 16,
8 queries, k = 4, 2 tables, capacity 16), carried to the port's 2 gloo
ranks with ``ShardedIndex.from_numpy``; each rank packs its shard in f32,
bf16 and int8 and searches it.  The JAX rows carry 128-lane padding, which
the port does not keep: rows are compared on their first d lanes.

Tolerance: packed rows, ids, starts and the int8 scale equal; search ids
the same set per row outside near-ties and distances within 1024 float32
ULPs (``torch_sharded_ranks.assert_parity``), except the bf16 plain search,
judged at bf16's precision (its test says why).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from approximatenn_tpu.parallel import sharded as jsh
from approximatenn_tpu_torch.harness.scoring import recall_at_k
from torch_sharded_ranks import (CAP, D, K, M, N, TRIES, assert_parity, brute, jax_arrays, ok,
                                 start_suite)

torch.set_num_threads(1)

DTYPES = {"f32": None, "bf16": jnp.bfloat16, "int8": jnp.int8}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Y = rng.standard_normal((M, D)).astype(np.float32)
    mesh = jsh.make_mesh(2)
    jx = jsh.build_sharded(X, K, mesh=mesh, tries=TRIES, capacity=CAP, seed=0,
                           graph_mode="exact")
    return dict(X=X, Y=Y, jx=jx, mesh=mesh)


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    inputs = dict(X=data["X"], Y=data["Y"], **jax_arrays(data["jx"], "jx_"))
    return start_suite("packed", inputs, tmp_path_factory.mktemp("packed"))


@pytest.fixture(scope="module")
def ref(data, ranks):
    X, Y, jx, mesh = data["X"], data["Y"], data["jx"], data["mesh"]
    r = dict(data)
    for name, dt in DTYPES.items():
        spk = jsh.packed_sharded(jx, X, mesh=mesh, dtype=dt)
        r[name] = spk
        r[f"{name}_search"] = jsh.search_packed_sharded(jx, spk, X, Y, mesh=mesh)
    r["gg"] = jsh.global_graph_sharded(jx, X, mesh=mesh)
    return r


@pytest.fixture(scope="module")
def port(ranks):
    outs = ranks.result()
    for out in outs:
        ok(out, "packed")
    return outs


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_packed_sharded_matches_jax(ref, port, dtype):
    """Each rank's rows, ids and starts are the JAX shard's (first d lanes
    of its rows); int8 uses the one global scale JAX computes."""
    spk = ref[dtype]
    for r, out in enumerate(port):
        n_pad_l, window, super_width = out[f"packed.{dtype}_meta"]
        assert (n_pad_l, window, super_width) == (spk.n_pad_l, spk.window, spk.super_width)
        jrows = np.asarray(spk.point_rows[r].astype(jnp.float32) if dtype == "bf16"
                           else spk.point_rows[r])[:, :D]
        np.testing.assert_array_equal(out[f"packed.{dtype}_rows"], jrows)
        np.testing.assert_array_equal(out[f"packed.{dtype}_ids"], np.asarray(spk.ids)[r])
        np.testing.assert_array_equal(out[f"packed.{dtype}_starts"], np.asarray(spk.starts)[r])
        if dtype == "int8":
            assert float(out["packed.int8_scale"]) == float(spk.scale)
        else:
            assert "packed.{dtype}_scale" not in out


def test_pad_slot_reads_the_sentinel_row(ref, port):
    """The last shard's zero pad row (local id 64) is in no packed slot: its
    slots carry the sentinel id and read the +inf row."""
    last = port[1]
    n_local = ref["jx"].n_local
    ids = last["packed.f32_ids"]
    assert not (ids == ref["jx"].n - n_local).any()
    rows = last["packed.f32_rows"].reshape(TRIES, -1, D)
    assert np.isinf(rows[ids == n_local]).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_search_packed_sharded_matches_jax(ref, port, dtype):
    """f32 and int8 in the parity band; bf16 rows are scored in bf16 by both
    packages, summed in other orders (JAX's ``engine/search.py:265``; the
    single-card packed test compares that path in f32 only), so near-ties
    and distances are judged at bf16's precision, 2^-7 relative."""
    rtol = 2.0**-7 if dtype == "bf16" else None
    for out in port:
        assert_parity(out[f"packed.{dtype}_search_ids"], out[f"packed.{dtype}_search_dd"],
                      *ref[f"{dtype}_search"], rtol=rtol)
        assert (out[f"packed.{dtype}_search_ids"] < N).all()


def test_search_packed_sharded_knobs(ref, port):
    """Port only: rerank 40 with 2 supercharge rounds does not lower
    recall@4 against a float64 brute force; a per-call ``window`` is the
    view's window."""
    true, _ = brute(ref["X"], ref["Y"], K)
    out = port[0]
    r0 = recall_at_k(true, out["packed.f32_search_ids"], K)
    r1 = recall_at_k(true, out["packed.wide_ids"], K)
    assert r1 >= r0 - 1e-9, (r0, r1)
    assert out["packed.window_same"]


def test_global_graph_sharded_matches_jax(ref, port):
    gi, gd = ref["gg"]
    for out in port:
        assert_parity(out["packed.gg_ids"], out["packed.gg_dd"], gi, gd)
        ids = out["packed.gg_ids"]
        assert not (ids == np.arange(N)[:, None]).any()  # no self-match
