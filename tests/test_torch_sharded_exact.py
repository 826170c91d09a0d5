"""The port's sharded exact search (``search_exact_sharded`` in
``approximatenn_tpu_torch/parallel/sharded.py``) against the JAX package's
on the CPU: stored f32, bf16 and int8 corpora through the rank kernel's
route and the two-phase engine (its plain versions here; the JAX Pallas
kernels in interpret mode there), and against a float64 brute force where
JAX has no counterpart here (a pre-padded corpus with ``n_true``,
near-origin queries, float64 and f16 corpora).

The port runs in 2 gloo processes (``tests/torch_sharded_ranks.py``), the
JAX package on a 2-device CPU mesh; n = 64 * 2 + 1 (one zero pad row on
the last shard, so the local k widens by one), d = 16, 8 queries, k = 4.

Tolerance (``torch_sharded_ranks.assert_parity``): ids the same set per row
outside near-ties (adjacent reference distances within 1e-5 relative),
every distance within 1024 float32 ULPs; float64 ids equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximatenn_tpu as jann
from approximatenn_tpu.parallel import sharded as jsh
from approximatenn_tpu_torch.parallel import sharded as sh
from torch_sharded_ranks import D, K, M, N, assert_parity, brute, ok, start_suite

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Y = rng.standard_normal((M, D)).astype(np.float32)
    Y0 = (0.01 * rng.standard_normal((M, D))).astype(np.float32)
    Xq, scale = jann.quantize_corpus(jnp.asarray(X))
    return dict(X=X, Y=Y, Y0=Y0, Xq=np.asarray(Xq), scale=np.asarray(scale))


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    return start_suite("exact", data, tmp_path_factory.mktemp("exact"))


@pytest.fixture(scope="module")
def ref(data, ranks):
    X, Y = data["X"], data["Y"]
    mesh = jsh.make_mesh(2)
    return dict(
        data,
        exact_f32=jsh.search_exact_sharded(X, Y, K, mesh=mesh),
        exact_bf16=jsh.search_exact_sharded(jnp.asarray(X, jnp.bfloat16), Y, K, mesh=mesh),
        exact_int8=jsh.search_exact_sharded(data["Xq"], Y, K, mesh=mesh,
                                            scale=data["scale"]),
        twophase=jsh.search_exact_sharded(X, Y, K, mesh=mesh, twophase=True, interpret=True))


@pytest.fixture(scope="module")
def port(ranks):
    return ranks.result()


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_search_exact_sharded_matches_jax(ref, port, dtype):
    """Stored f32, bf16 (ranked in float32 from the stored values) and int8
    (one global scale, the JAX quantization's) against the JAX sharded
    exact search."""
    for out in port:
        ok(out, f"exact.exact_{dtype}")
        assert_parity(out[f"exact.exact_{dtype}_ids"], out[f"exact.exact_{dtype}_dd"],
                      *ref[f"exact_{dtype}"])


@pytest.mark.parametrize("case", ["n_true", "near_origin", "f64", "f16"])
def test_search_exact_sharded_equals_brute_force(ref, port, case):
    """Global brute force (float64), pad rows never returned: a corpus the
    caller padded already (``n_true``), near-origin queries (closest to the
    zero pad row), a float64 corpus (held to float64 ids exactly), an f16
    stored corpus (held to the brute force over its stored values)."""
    Y = ref["Y0"] if case == "near_origin" else ref["Y"]
    X = ref["X"].astype(np.float16) if case == "f16" else ref["X"]
    true_ids, true_d = brute(X, Y, K)
    for out in port:
        ok(out, f"exact.exact_{case}")
        ids, dd = out[f"exact.exact_{case}_ids"], out[f"exact.exact_{case}_dd"]
        assert (ids < N).all()
        if case == "f64":
            np.testing.assert_array_equal(ids, true_ids)
            np.testing.assert_allclose(dd, true_d, rtol=1e-12)
        else:
            assert_parity(ids, dd, true_ids, true_d)


def test_search_exact_sharded_int8_needs_scale(port):
    for out in port:
        assert "scale" in str(out["exact.int8_no_scale"])


def test_search_exact_sharded_twophase_matches_jax(ref, port):
    """``twophase=True``: per rank the two-phase engine's plain version
    (emit, pick, rescan) against JAX ``exact_knn_twophase`` in interpret
    mode; the rank route (``twophase`` None or False on the CPU) gives the
    same neighbours."""
    for out in port:
        ok(out, "twophase")
        for route in ("twophase", "auto", "rank"):
            assert_parity(out[f"twophase.{route}_ids"], out[f"twophase.{route}_dd"],
                          *ref["twophase"])


def test_tpu_knobs_raise_before_any_work():
    one = sh.Mesh(group=None, rank=0, size=1, device=torch.device("cpu"))
    X = np.zeros((4, 2), np.float32)
    for kw in ({"interpret": True}, {"query_block": 32}):
        with pytest.raises(ValueError, match="TPU"):
            sh.search_exact_sharded(X, X, 1, mesh=one, **kw)
