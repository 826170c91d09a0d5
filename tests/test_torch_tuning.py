"""The port's tuner (``approximatenn_tpu_torch.engine.tuning``) against the
JAX package's ``tune`` on the CPU, on the corpus of tests/test_tuning.py.

The port cannot reproduce ``jax.random``'s bases, so a parity case runs
the JAX ``tune`` first, carries the index it built (the tuner's ``seed``
and build keywords) across with ``ANNIndex.load``, and hands it to the
port's ``tune`` through a monkeypatched ``tuning.build``.  Both run with
``measure=False`` (the cost proxy).  What must agree: the same trials in
the same order with the same knobs (the packed route is "plain" where JAX
says "xla") and the same ``cost`` exactly; each recall within 0.01 (hash
codes of a query may flip where a projection lies near zero, see
tests/test_torch_slice.py); the same winner.

One trial is held to another reference: the exact bf16 tier.  On the CPU
the JAX package ranks a bf16 corpus with its squared norms summed in bf16
(``approximatenn_tpu/ops/distance.py:107``), which costs it recall (0.947
against the port's 0.984 on this corpus); the port ranks the stored bf16
values in float32, as both packages' kernels do on an accelerator.  That
trial's recall must equal the recall of the float64 top-k over the stored
bf16 values, within 0.01, and be no lower than the JAX one.

The other cases mirror tests/test_tuning.py on the port alone.  The
``cuda`` cases need a card and skip here.
"""

import json

import numpy as np
import pytest
import torch

import approximatenn_tpu_torch as tann
from approximatenn_tpu_torch.engine import tuning
from approximatenn_tpu_torch.engine.tuning import Trial, TuneReport, tune
from approximatenn_tpu_torch.harness.scoring import recall_at_k
from approximatenn_tpu_torch.index import ANNIndex

torch.set_num_threads(1)

RECALL_TOL = 0.01


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    # clustered so the hash path has structure to find
    centers = rng.standard_normal((20, 24)).astype(np.float32) * 3
    X = (centers[rng.integers(0, 20, 4000)]
         + rng.standard_normal((4000, 24)).astype(np.float32))
    Q = (centers[rng.integers(0, 20, 64)]
         + rng.standard_normal((64, 24)).astype(np.float32))
    return X, Q


def T(a):
    return torch.from_numpy(np.asarray(a))


def tune_both(X, Q, k, tmp_path, monkeypatch, **kw):
    """(JAX report, port report) of one tune over one index."""
    from approximatenn_tpu.engine.tuning import tune as jtune

    jrep = jtune(X, k, queries=Q, measure=False, **kw)
    path = str(tmp_path / "tuned.npz")
    jrep._index.save(path)
    carried = ANNIndex.load(path, device="cpu")
    seen = {}

    def fake_build(points, kk, **bkw):
        seen.update(bkw, k=kk)
        return carried, None, None

    monkeypatch.setattr(tuning, "build", fake_build)
    trep = tune(T(X), k, queries=None if Q is None else T(Q), measure=False, **kw)
    # the port asked for the build the JAX tuner made
    assert seen["k"] == k and seen["seed"] == kw.get("seed", 0)
    assert seen["metric"] == kw.get("metric", "l2") and seen["store_points"] is True
    return jrep, trep


def stored_bf16_recall(X, Q, k):
    """recall@k, against the float32 truth, of the float64 top-k over the
    bf16-rounded corpus: what an exact bf16 tier serves."""
    Xs = T(X).to(torch.bfloat16).double().numpy()
    Qd = np.asarray(Q, np.float64)
    dd = (Qd * Qd).sum(1)[:, None] + (Xs * Xs).sum(1)[None, :] - 2.0 * Qd @ Xs.T
    got = np.argsort(dd, axis=1, kind="stable")[:, :k]
    true_ids, _ = tann.exact_search(T(X), T(Q), k)
    return recall_at_k(true_ids.numpy(), got, k)


def assert_same_report(jrep, trep, bf16_recall=None):
    assert len(trep.trials) == len(jrep.trials)
    for jt, tt in zip(jrep.trials, trep.trials):
        jknobs = dict(jt.knobs)
        if jknobs.get("path") == "xla":
            jknobs["path"] = "plain"
        assert (tt.engine, tt.knobs) == (jt.engine, jknobs)
        assert tt.cost == jt.cost
        if tt.engine == "exact" and tt.knobs.get("storage_dtype") == "bf16":
            # see the module docstring
            assert abs(tt.recall - bf16_recall) <= RECALL_TOL, (tt, bf16_recall)
            assert tt.recall >= jt.recall
            continue
        assert abs(tt.recall - jt.recall) <= RECALL_TOL, (tt, jt)
    assert trep.trials.index(trep.best) == jrep.trials.index(jrep.best)
    jd, td = jrep.as_dict(), trep.as_dict()
    for key in ("k", "metric", "target_recall", "measured", "batch", "batch_tiled"):
        assert td[key] == jd[key]


def test_tune_matches_jax_tiers_windows_reranks_and_table(corpus, tmp_path, monkeypatch):
    """Exact tiers, windows, rerank widths and the table engine in one
    grid; the winner is the cheapest trial meeting the target."""
    X, Q = corpus
    jrep, trep = tune_both(X, Q, 5, tmp_path, monkeypatch, target_recall=0.6, tries=4,
                           seed=0, probe_grid=(12,), window_grid=(8, 16),
                           rerank_grid=(None, 20), exact_tiers=(None, "bf16", "int8"),
                           include_table=True)
    assert_same_report(jrep, trep, bf16_recall=stored_bf16_recall(X, Q, 5))
    engines = {t.engine for t in trep.trials}
    assert engines == {"exact", "packed", "table"}
    qual = [t for t in trep.trials if t.recall >= 0.6]
    assert trep.best.cost == min(t.cost for t in qual)


def test_tune_matches_jax_angular_sliced_batch(corpus, tmp_path, monkeypatch):
    """Angular metric, and batch < sample size: recall over every slice."""
    X, Q = corpus
    jrep, trep = tune_both(X, Q, 5, tmp_path, monkeypatch, metric="angular", batch=16,
                           target_recall=0.5, tries=4, seed=0, probe_grid=(12,),
                           window_grid=(8,), rerank_grid=(None,))
    assert_same_report(jrep, trep)
    assert trep.batch == 16


def test_sample_queries_bit_identical_to_jax(corpus):
    import jax.numpy as jnp

    from approximatenn_tpu.engine.tuning import _sample_queries as j_sample

    X, _ = corpus
    for n_queries, seed in ((32, 1), (256, 0), (5000, 3)):
        want = np.asarray(j_sample(jnp.asarray(X), n_queries, seed))
        got = tuning._sample_queries(T(X), n_queries, seed).numpy()
        np.testing.assert_array_equal(got, want)


def test_tune_meets_target_or_max_recall(corpus):
    X, Q = corpus
    rep = tune(T(X), 5, queries=Q, target_recall=0.6, tries=6, seed=0,
               probe_grid=(None, 12), window_grid=(8, 16),
               rerank_grid=(None,), measure=False)
    assert isinstance(rep, TuneReport)
    assert rep.trials and all(isinstance(t, Trial) for t in rep.trials)
    # exact is always a trial (recall 1.0), so the target is reachable
    assert rep.best.recall >= 0.6
    qual = [t for t in rep.trials if t.recall >= 0.6]
    assert rep.best.cost == min(t.cost for t in qual)


def test_tune_server_round_trip(corpus):
    """report.server() serves the winning config and reproduces the
    reported recall on the tuning sample."""
    X, Q = corpus
    rep = tune(T(X), 5, queries=Q, target_recall=0.5, tries=6, seed=0,
               probe_grid=(12,), window_grid=(8,),
               rerank_grid=(None, 20), measure=False)
    srv = rep.server()
    ids, dists = srv.search(T(Q))
    assert ids.shape == (64, 5)
    true_ids, _ = tann.exact_search(T(X), T(Q), 5)
    got = recall_at_k(true_ids.numpy(), ids.numpy(), 5)
    assert abs(got - rep.best.recall) < 1e-9, (got, rep.best.recall)


def test_tune_without_exact_candidate(corpus):
    """include_exact=False: the winner comes from the hash grid even when
    no config meets an impossible target (falls back to max recall)."""
    X, Q = corpus
    rep = tune(T(X), 5, queries=Q, target_recall=1.01, include_exact=False,
               tries=4, seed=0, probe_grid=(None,), window_grid=(8,),
               rerank_grid=(None,), measure=False)
    assert rep.best.engine == "packed"
    assert rep.best.recall == max(t.recall for t in rep.trials)


def test_tune_table_engine_and_dicts(corpus):
    X, Q = corpus
    rep = tune(T(X), 5, queries=Q, target_recall=0.0, include_exact=False,
               include_table=True, tries=4, seed=0, probe_grid=(12,),
               window_grid=(8,), rerank_grid=(None,), measure=False)
    assert {t.engine for t in rep.trials} == {"packed", "table"}
    d = rep.as_dict()
    assert d["best"]["engine"] in ("packed", "table")
    assert len(d["trials"]) == len(rep.trials)
    json.dumps(d)
    # a table winner serves through the table path
    rep.best = [t for t in rep.trials if t.engine == "table"][0]
    srv = rep.server()
    assert srv.packed is None
    ids, _ = srv.search(T(Q))
    assert ids.shape == (64, 5)


def test_tune_synthesizes_queries(corpus):
    X, _ = corpus
    rep = tune(T(X), 5, n_queries=32, target_recall=0.0, tries=4, seed=1,
               probe_grid=(None,), window_grid=(8,), rerank_grid=(None,),
               measure=False)
    assert rep.best is not None
    assert all(0.0 <= t.recall <= 1.0 for t in rep.trials)


def test_tune_angular_metric(corpus):
    X, Q = corpus
    rep = tune(T(X), 5, queries=Q, metric="angular", target_recall=0.0,
               tries=4, seed=0, probe_grid=(12,), window_grid=(8,),
               rerank_grid=(None,), measure=False)
    ids, _ = rep.server().search(T(Q))
    assert ids.shape == (64, 5)


@pytest.mark.parametrize("batch", [16, 200])
def test_tune_batch_knob(corpus, batch):
    """Trials dispatch at the production batch size; the packed trials
    record the route taken (the plain packed path on the CPU) and recall
    is scored over the full sample."""
    X, Q = corpus
    rep = tune(T(X), 5, queries=Q, batch=batch, target_recall=0.5,
               tries=4, seed=0, probe_grid=(12,), window_grid=(8,),
               rerank_grid=(None,), measure=False)
    assert rep.batch == batch and rep.as_dict()["batch"] == batch
    pk = [t for t in rep.trials if t.engine == "packed"]
    assert pk and all(t.knobs["path"] == "plain" for t in pk)
    assert all(0.0 <= t.recall <= 1.0 for t in rep.trials)
    ids, _ = rep.server().search(T(Q))
    assert ids.shape == (64, 5)


def test_tune_exact_tiers_and_super_grid(corpus):
    """Exact storage tiers (bf16/int8) and supercharge_rounds are knobs;
    the winner's server reproduces the winning tier."""
    X, Q = corpus
    rep = tune(T(X), 5, queries=Q, target_recall=0.0, tries=4, seed=0,
               probe_grid=(12,), window_grid=(8,), rerank_grid=(None,),
               super_grid=(1, 2), exact_tiers=(None, "bf16", "int8"),
               measure=False)
    exact_trials = [t for t in rep.trials if t.engine == "exact"]
    by_tier = {t.knobs.get("storage_dtype"): t.recall for t in exact_trials}
    assert set(by_tier) == {None, "bf16", "int8"}
    # f32 exact is 1.0 by construction; the tiers close behind on this corpus
    assert by_tier[None] == 1.0
    assert by_tier["bf16"] > 0.9 and by_tier["int8"] > 0.8
    assert {t.knobs.get("supercharge_rounds")
            for t in rep.trials if t.engine == "packed"} == {1, 2}
    rep.best = [t for t in exact_trials if t.knobs.get("storage_dtype") == "bf16"][0]
    srv = rep.server()
    assert srv.points.dtype == torch.bfloat16
    ids, _ = srv.search(T(Q))
    assert ids.shape == (64, 5)
    assert rep.as_dict()["batch_tiled"] is False


def test_tune_batch_tiled_flag(corpus):
    X, Q = corpus
    rep = tune(T(X), 5, queries=Q[:16], batch=64, target_recall=0.0,
               tries=4, seed=0, probe_grid=(12,), window_grid=(8,),
               rerank_grid=(None,), measure=False)
    assert rep.batch_tiled is True


def test_tune_sequential_tiers(corpus):
    """sequential_tiers=True: tiers trialed one at a time (built, scored,
    freed), the report and winner as in the all-resident mode."""
    X, Q = corpus
    rep = tune(T(X), 5, queries=Q, target_recall=0.9, tries=4, seed=0,
               probe_grid=(12,), window_grid=(8,), rerank_grid=(None,),
               exact_tiers=(None, "bf16", "int8"),
               sequential_tiers=True, measure=False)
    ex = [t for t in rep.trials if t.engine == "exact"]
    assert {t.knobs.get("storage_dtype") for t in ex} == {None, "bf16", "int8"}
    assert ex[0].recall == 1.0  # full-precision tier is the oracle
    ids, _ = rep.server().search(T(Q))
    assert ids.shape == (64, 5)


def test_tune_measure_default_on_cpu_is_the_cost_proxy(corpus):
    X, Q = corpus
    rep = tune(T(X), 5, queries=Q, target_recall=0.5, tries=4, seed=0,
               probe_grid=(12,), window_grid=(8,), rerank_grid=(None,))
    assert rep.measured is False
    assert all(t.qps is None for t in rep.trials)


def test_tune_numpy_corpus_needs_a_device(corpus):
    X, Q = corpus
    if torch.cuda.is_available():
        pytest.skip("a card is present: a numpy corpus goes to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tune(X, 5, queries=Q, probe_grid=(12,), window_grid=(8,), rerank_grid=(None,))


def test_ann_bench_tune_cli(capsys):
    """ann_bench --tune prints one TuneReport JSON line."""
    from approximatenn_tpu_torch.harness import ann_bench

    rc = ann_bench.main([
        "--dataset", "gaussian-10k", "--max-n", "2000", "--k", "5",
        "--tries", "4", "--batch", "32", "--tune", "--target-recall", "0.5", "-c",
    ])
    out = capsys.readouterr().out
    assert rc == 0
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["target_recall"] == 0.5 and rec["measured"] is False
    assert rec["best"]["recall"] >= 0.5  # exact is always in the pool
    assert rec["trials"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tune_on_card_times_trials_and_launches_the_kernels(corpus):
    from approximatenn_tpu_torch.ops import exact as ex

    dev = _card()
    X, Q = corpus
    ex.reset_launch_counts()
    rep = tune(T(X).to(dev), 5, queries=T(Q).to(dev), target_recall=0.5, tries=4,
               seed=0, probe_grid=(12,), window_grid=(8, 16), rerank_grid=(None,))
    assert rep.measured is True
    assert rep.best.qps is not None and rep.best.qps > 0
    pk = [t for t in rep.trials if t.engine == "packed"]
    assert pk and all(t.knobs["path"] == "fused" for t in pk)
    assert ex.launches["probe_topk"] > 0 and ex.launches["exact_knn"] > 0
    ids, _ = rep.server().search(T(Q).to(dev))
    assert ids.shape == (64, 5) and ids.device.type == "cuda"
