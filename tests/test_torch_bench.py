"""``bench_torch.py``, the port's headline bench, on the CPU at a small
config (n = 2,000 x d = 32, k = 10, tries = 4, 100 queries from
``default_rng(12345)``): the JSON line's keys against ``bench.py``'s, its
exact part against the JAX package's ``exact_search``, its hash part over a
JAX-built index against the JAX ``search``, and ``main`` refusing to run
without a card.

Ids must be equal outside near-ties (adjacent reference distances within
1e-5 relative); distances agree at rtol 1e-5 / atol 1e-4.  JAX is imported
only inside the tests that compare with it, so the card case runs where
JAX is not installed.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch as bt
from approximatenn_tpu_torch.harness.scoring import ids_agree
from approximatenn_tpu_torch.index import ANNIndex
from approximatenn_tpu_torch.ops import exact as ex
from approximatenn_tpu_torch.ops.hash import query_codes

torch.set_num_threads(1)

SMALL = dict(n=2000, d=32, k=10, tries=4, ycnt=100)
# the smallest record of baselines/reference_cpu.json: the baseline keys
REF_SMALL = dict(n=1000, d=80, k=10, tries=10, ycnt=50)

# bench.py's keys, by the lines that set them
HEAD_KEYS = {"metric", "value", "unit", "vs_baseline", "config", "query_s",  # :124-133
             "latency_s", "build_s", "build_cold_s", "device"}
BASE_KEYS = {"baseline_qps", "build_vs_baseline", "baseline_recall_at_10"}  # :136-141
EXACT_KEYS = {"recall_at_10",  # :147
              "exact_qps", "exact_qps_best", "exact_qps_cv", "exact_stat",  # :187-192
              "exact_rounds", "exact_reps", "matmul_precision",  # :196
              "exact_recall_at_10",  # :199
              "hash_qps", "hash_recall_at_10", "serving_mode"}  # :207-209
ONE_M_KEYS = {"exact_1m_qps", "exact_1m_recall_at_10",  # :238-240
              "exact_1m_bf16_qps", "exact_1m_bf16_recall_at_10",  # :257-258
              "exact_1m_split3_qps", "exact_1m_split3_recall_at_10"}  # :275-276


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def small():
    X, Y = bt.bench_data(SMALL)
    truth = bt.ann.brute_force_knn(T(X), T(Y), SMALL["k"])[0]
    return X, Y, truth


@pytest.fixture(scope="module")
def small_run():
    """``run`` at the small config on the CPU, with what it scored kept."""
    keep = {}
    return bt.run(SMALL, device="cpu", reps=2, one_m=False, keep=keep), keep


def test_keys_are_bench_py_keys():
    assert set(bt.KEYS) == HEAD_KEYS | BASE_KEYS | EXACT_KEYS | ONE_M_KEYS
    assert len(bt.KEYS) == len(set(bt.KEYS))


@pytest.mark.parametrize("config", [SMALL, REF_SMALL], ids=["no-record", "record"])
def test_run_prints_bench_py_line(config, request):
    """``run`` without the 1M part gives exactly ``bench.py``'s non-1M
    keys (the baseline keys only where ``baselines/reference_cpu.json``
    holds the config), the exact number as the headline and the hash
    numbers under ``hash_*``."""
    if config is SMALL:
        r, _ = request.getfixturevalue("small_run")
    else:
        r = bt.run(config, device="cpu", reps=2, one_m=False)
    base = bt.load_baseline(config)
    assert (base is None) == (config is SMALL)
    want = HEAD_KEYS | EXACT_KEYS | (BASE_KEYS if base else set())
    assert set(r) == want
    json.dumps(r)
    assert r["metric"] == "query_qps" and r["unit"] == "queries/sec"
    assert r["config"] == config and r["device"] == "cpu"
    assert r["value"] == r["exact_qps"] > 0 and r["hash_qps"] > 0
    assert r["exact_qps_best"] >= r["exact_qps"]
    assert r["hash_qps"] == pytest.approx(config["ycnt"] / r["query_s"], rel=1e-3)
    assert r["serving_mode"] == "exact (Server auto)"
    assert r["recall_at_10"] == r["exact_recall_at_10"] == 1.0
    assert 0.0 < r["hash_recall_at_10"] <= 1.0
    assert r["exact_stat"] == "median_of_rounds" and r["exact_reps"] == 100
    assert 6 <= r["exact_rounds"] <= 24 and r["matmul_precision"] == "highest"
    assert r["build_s"] > 0 and r["build_cold_s"] > 0 and r["latency_s"] > 0
    if base is None:
        assert r["vs_baseline"] is None
    else:
        assert r["vs_baseline"] == round(r["value"] / base["qps"], 2)
        assert r["baseline_qps"] == base["qps"]
        assert r["build_vs_baseline"] == round(base["build_s"] / r["build_s"], 2)
        assert r["baseline_recall_at_10"] == base["recall_at_10"]


def test_exact_part_matches_jax_exact_search(small, small_run):
    """The ids and distances the bench's exact part scored equal the JAX
    package's ``exact_search`` on the same numpy arrays."""
    import jax.numpy as jnp

    import approximatenn_tpu as jann

    X, Y, _ = small
    k = SMALL["k"]
    r, keep = small_run
    ids, dists = keep["exact_ids"], keep["exact_dists"]
    ji, jd = jann.exact_search(jnp.asarray(X), jnp.asarray(Y), k)
    ji, jd = T(ji), T(jd)
    # the JAX reference's distances with a (k+1)-th column for the near-tie rule
    _, jd1 = jann.exact_search(jnp.asarray(X), jnp.asarray(Y), k + 1)
    ok, _ = ids_agree(ids, ji, T(jd1), rtol=1e-5)
    assert ok
    np.testing.assert_allclose(dists.numpy(), jd.numpy(), rtol=1e-5, atol=1e-4)
    assert r["exact_recall_at_10"] == 1.0


def test_hash_part_over_a_jax_index_matches_jax_search(small, tmp_path):
    """A JAX ``build(seed=7)`` index carried across by ``from_numpy`` gives,
    through the bench's hash part, the JAX ``search``'s ids and the recall
    ``bench.py`` scores for it."""
    import jax.numpy as jnp

    import approximatenn_tpu as jann
    from approximatenn_tpu.harness.scoring import recall_at_k as j_recall_at_k
    from approximatenn_tpu.ops.hash import query_codes as j_query_codes

    X, Y, truth = small
    k = SMALL["k"]
    Xd, Yd = jnp.asarray(X), jnp.asarray(Y)
    jidx, _, _ = jann.build(Xd, k, tries=SMALL["tries"], seed=7)
    path = tmp_path / "j.npz"
    jidx.save(str(path))
    with np.load(path) as z:
        tidx = ANNIndex.from_numpy(dict(z), device="cpu")
    stats, (ids, dists) = bt.hash_stats(tidx, T(X), T(Y), truth, k, reps=2)
    ji, jd = jann.search(jidx, Xd, Yd)
    # one float32 projection in each framework: a code within rounding of
    # zero could take either sign; this config has none
    jc, _ = j_query_codes(jidx.row_means, jidx.bases, Yd)
    tc, _ = query_codes(tidx.row_means, tidx.bases, T(Y))
    assert (tc.numpy() == np.asarray(jc)).all()
    ok, _ = ids_agree(ids, T(ji), T(jd), rtol=1e-5)
    assert ok
    fin = torch.isfinite(T(jd))
    np.testing.assert_allclose(dists[fin].numpy(), T(jd)[fin].numpy(), rtol=1e-5, atol=1e-4)
    jtq, _ = jann.brute_force_knn(Xd, Yd, k)
    assert stats["recall_at_10"] == round(j_recall_at_k(np.asarray(jtq), np.asarray(ji), k), 4)


def test_main_without_a_card_exits_non_zero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bt.main([])
    assert e.value.code not in (0, None)
    assert "CUDA" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_bench_imports_no_jax():
    code = ("import sys; before = set(sys.modules)\n"
            "import bench_torch\n"
            "bad = [m for m in set(sys.modules) - before if m.split('.')[0] in "
            "('jax', 'jaxlib', 'approximatenn_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(bt.BASELINE_PATH.parents[1]))
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


@pytest.mark.cuda
def test_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the rank kernel has no CPU mode)")
    r = bt.run(SMALL, device="cuda", reps=2, one_m=False)
    assert ex.launches["exact_knn"] > 0
    assert set(r) == HEAD_KEYS | EXACT_KEYS
    assert r["recall_at_10"] == 1.0 and r["device"] != "cpu"
