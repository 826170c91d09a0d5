"""The port's ``tune_sharded`` (``approximatenn_tpu_torch/parallel/
serving.py``) against the JAX package's on the same inputs, on the CPU.

The port runs in 2 gloo processes (``tests/torch_sharded_ranks.py``, suite
"tune", one launch for the file), the JAX package on a 2-device CPU mesh
with ``interpret=False`` (its XLA exact and packed routes).  640 x 16
gaussian points, 32 queries scored in one batch (``batch=None``, so the
JAX tuner's scoring of ``min(batch, m)`` queries, reference fault C-A7-3,
does not come into play), k = 5; the exact f32 and bf16 tiers and the
packed trials at probes {all, 18}, window 16, 3 tables, capacity 32; the
port's hash build takes the bases JAX's draws at seed 3 (``jax.random``
cannot be drawn in torch).  The JAX tuner's other fault, C-A7-4 (every
exact tier kept resident), changes no trial's numbers.

Tolerance: every trial's engine and knobs equal (the packed route is
"plain" here, "xla" in JAX), its cost proxy equal exactly, its recall
equal exactly (the trials' candidate sets are the same; no near-tie at
the k-th neighbour changes a count on these inputs), ``measured`` false on
both, and the same trial the winner.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from approximatenn_tpu.engine.build import sample_bases
from approximatenn_tpu.ops.transforms import derive_dims
from approximatenn_tpu.parallel import sharded as jsh
from approximatenn_tpu.parallel.serving import tune_sharded as jtune
from torch_sharded_ranks import ok, start_suite

torch.set_num_threads(1)
N_TUNE, D_TUNE, M_TUNE, K_TUNE, SEED = 640, 16, 32, 5, 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    X = rng.standard_normal((N_TUNE, D_TUNE)).astype(np.float32)
    Y = rng.standard_normal((M_TUNE, D_TUNE)).astype(np.float32)
    # the bases JAX's hash build draws at seed 3 (its parallel/sharded.py:241-247)
    d_short, _ = derive_dims(N_TUNE // 2, K_TUNE, D_TUNE)
    bases = sample_bases(jax.random.key(SEED), D_TUNE, d_short, 3, 6, 1, 1, 1, jnp.float32)
    return dict(X=X, Y=Y, bases=np.asarray(bases))


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    return start_suite("tune", data, tmp_path_factory.mktemp("tune"))


@pytest.fixture(scope="module")
def ref(data, ranks):
    rep = jtune(data["X"], K_TUNE, mesh=jsh.make_mesh(2), queries=data["Y"], batch=None,
                interpret=False, seed=SEED, probe_grid=(None, 18), window_grid=(16,),
                rerank_grid=(None,), exact_tiers=(None, "bf16"), tries=3, capacity=32)
    return dict(report=rep.as_dict(), recalls=[t.recall for t in rep.trials],
                costs=[t.cost for t in rep.trials],
                best=next(i for i, t in enumerate(rep.trials) if t is rep.best),
                bases=np.asarray(rep._srv_hash.sidx.bases))


@pytest.fixture(scope="module")
def port(ranks):
    return ranks.result()


def test_tune_sharded_matches_jax(data, ref, port):
    """Every trial's knobs, cost and recall, and the winner, equal to JAX
    ``tune_sharded``'s on the same corpus, queries and bases."""
    np.testing.assert_array_equal(ref["bases"], data["bases"])
    theirs = ref["report"]
    assert not theirs["measured"] and theirs["batch"] == M_TUNE
    assert [t["engine"] for t in theirs["trials"]] == ["exact", "exact", "packed", "packed"]
    for out in port:
        ok(out, "tune_parity")
        np.testing.assert_array_equal(out["tune_parity.bases"], data["bases"])
        mine = json.loads(str(out["tune_parity.report"]))
        assert not mine["measured"] and mine["batch"] == theirs["batch"]
        for a, b in zip(mine["trials"], theirs["trials"], strict=True):
            a = {key: v for key, v in a.items() if key not in ("recall", "cost_rows")}
            b = {key: v for key, v in b.items() if key not in ("recall", "cost_rows")}
            if b["engine"] == "packed":
                assert a.pop("path") == "plain" and b.pop("path") == "xla"
            assert a == b
        assert out["tune_parity.costs"].tolist() == ref["costs"]
        assert out["tune_parity.recalls"].tolist() == ref["recalls"]
        assert int(out["tune_parity.best"]) == ref["best"]
