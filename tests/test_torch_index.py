"""The index and its weights between the two packages: a JAX-built index
saved to npz loads in the port, the port's save loads in JAX, and
``ANNIndex.from_numpy`` (the weight carrier) gives the same index."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximatenn_tpu as jann
from approximatenn_tpu.index import ANNIndex as JIndex
from approximatenn_tpu_torch.index import ANNIndex

torch.set_num_threads(1)

FIELDS = ("tables", "counts", "graph", "bases", "row_means")


@pytest.fixture(scope="module")
def jax_index():
    rng = np.random.default_rng(7)
    X = rng.standard_normal((600, 16)).astype(np.float32)
    idx, _, _ = jann.build(jnp.asarray(X), 5, tries=3, seed=1)
    return idx, X


def _as_np(a):
    """A tensor or JAX array as numpy, bfloat16 widened to float32."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def assert_same(t: ANNIndex, j: JIndex):
    for f in FIELDS + ("points",):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(_as_np(a), _as_np(b), err_msg=f)
    for f in ("n", "k", "d", "d_short", "tries", "tmax", "metric"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.tables.dtype == t.graph.dtype == t.counts.dtype == torch.int32
    assert t.n_buckets == j.n_buckets


def test_jax_npz_loads_in_port_and_back(jax_index, tmp_path):
    jidx, _ = jax_index
    jidx.save(str(tmp_path / "j.npz"))
    tidx = ANNIndex.load(str(tmp_path / "j.npz"), device="cpu")
    assert_same(tidx, jidx)
    tidx.save(str(tmp_path / "t.npz"))
    back = JIndex.load(str(tmp_path / "t.npz"))
    assert_same(tidx, back)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key])


def test_from_numpy_is_the_weight_carrier(jax_index, tmp_path):
    jidx, _ = jax_index
    jidx.save(str(tmp_path / "j.npz"))
    with np.load(tmp_path / "j.npz") as z:
        a = ANNIndex.from_numpy(z, device="cpu")
    b = ANNIndex.load(str(tmp_path / "j.npz"), device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    # the JAX index's own leaves, as np.asarray gives them, work as well
    leaves = {f: np.asarray(getattr(jidx, f)) for f in FIELDS}
    leaves["meta"] = np.array([jidx.n, jidx.k, jidx.d, jidx.d_short, jidx.tries, jidx.tmax])
    assert_same(ANNIndex.from_numpy(leaves, device="cpu"), jidx)


def test_half_precision_stash_round_trip(jax_index, tmp_path):
    jidx, X = jax_index
    jb = dataclasses.replace(jidx, points=jnp.asarray(X, jnp.bfloat16))
    jb.save(str(tmp_path / "jb.npz"))
    tb = ANNIndex.load(str(tmp_path / "jb.npz"), device="cpu")
    assert tb.points.dtype == torch.bfloat16
    assert_same(tb, jb)
    tb.save(str(tmp_path / "tb.npz"))
    back = JIndex.load(str(tmp_path / "tb.npz"))
    assert back.points.dtype == jnp.bfloat16
    assert_same(tb, back)
    with np.load(tmp_path / "tb.npz") as z:
        assert str(z["points_dtype"]) == "bfloat16" and z["points"].dtype == np.uint16
    # ml_dtypes bfloat16 arrays straight from jax are accepted too
    leaves = {f: np.asarray(getattr(jb, f)) for f in FIELDS + ("points",)}
    leaves["meta"] = np.array([jb.n, jb.k, jb.d, jb.d_short, jb.tries, jb.tmax])
    assert ANNIndex.from_numpy(leaves, device="cpu").points.dtype == torch.bfloat16


@pytest.mark.parametrize("method", ["add_points", "remove_points", "with_depth",
                                    "drop_tables", "packed"])
def test_unported_updates_raise(jax_index, tmp_path, method):
    """The update methods and the packed view, once stubs that raised, now
    run and give the JAX package's index (``points`` passed where the index
    stores none, as the JAX package requires)."""
    jidx, X = jax_index
    jidx.save(str(tmp_path / "j.npz"))
    tidx = ANNIndex.load(str(tmp_path / "j.npz"), device="cpu")
    Y = X[:3] + 0.25
    args = {"add_points": ((jnp.asarray(Y),), (torch.from_numpy(Y),), {"points": X}),
            "remove_points": (([1, 2, 600],), ([1, 2, 600],), {}),
            "with_depth": ((2,), (2,), {}),
            "drop_tables": ((), (), {}),
            "packed": ((jnp.asarray(X),), (torch.from_numpy(X),), {})}[method]
    j2 = getattr(jidx, method)(*args[0], **args[2])
    t2 = getattr(tidx, method)(*args[1], **{k: torch.from_numpy(v)
                                           for k, v in args[2].items()})
    if method == "packed":
        np.testing.assert_array_equal(t2.ids.numpy(), np.asarray(j2.ids))
        assert t2.memory_bytes() < j2.memory_bytes()  # no TPU pad lanes
    elif method == "drop_tables":
        assert t2.tables is None and t2.counts is None
        np.testing.assert_array_equal(t2.graph.numpy(), np.asarray(j2.graph))
    else:
        assert_same(t2, j2)
    assert t2.memory_bytes() == j2.memory_bytes() or method == "packed"
    assert tidx.memory_bytes() == jidx.memory_bytes()
    assert tidx.memory_bytes(ragged=False) == jidx.memory_bytes(ragged=False)
    np.testing.assert_array_equal(tidx.par_maxes(), jidx.par_maxes())
