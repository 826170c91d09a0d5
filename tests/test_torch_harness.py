"""The port's harnesses (``approximatenn_tpu_torch.harness``) against the
JAX package's on the CPU.

The numpy helpers (``ulp_units``, ``diffcount``, ``f64_oracle``,
``arbitrate_f64``, ``true_ranks``, ``score_guesses``) must give results
equal to the JAX package's on the same arrays.  The CLIs run with ``-c``
at tiny sizes, mirroring tests/test_harness.py: ``compare_results -c``
compares the CPU with itself and must show 0 diffs.  Without a card and
without ``-c`` a harness raises rather than running on the CPU; the
``cuda`` case needs a card and skips here.
"""

import numpy as np
import pytest
import torch

from approximatenn_tpu_torch.harness import (ann_bench, compare_results, test_correctness,
                                             time_results)
from approximatenn_tpu_torch.harness.common import resolve_backend
from approximatenn_tpu_torch.harness.compare_results import (arbitrate_f64, diffcount,
                                                             f64_oracle, ulp_units)
from approximatenn_tpu_torch.harness.scoring import Score, score_guesses, true_ranks

torch.set_num_threads(1)


@pytest.fixture()
def points(rng):
    X = rng.standard_normal((120, 8)).astype(np.float32)
    X[7] = X[3]  # an exact duplicate: distance ties
    return X


class TestHelpersMatchJax:
    def test_ulp_units_and_diffcount(self, rng):
        from approximatenn_tpu.harness import compare_results as jcr

        a = rng.standard_normal(500).astype(np.float32)
        b = a * (1 + rng.standard_normal(500).astype(np.float32) * 1e-3)
        b[:5] = -b[:5]  # sign crossings
        assert ulp_units(a, b) == jcr.ulp_units(a, b) > 0
        assert ulp_units(a, b, unit=1) == jcr.ulp_units(a, b, unit=1)
        assert ulp_units(a, a.copy()) == 0.0
        ia = rng.integers(0, 50, (30, 5))
        ib = ia.copy()
        ib[::4, 2] += 1
        assert diffcount(ia, ib) == jcr.diffcount(ia, ib) == 8

    def test_f64_oracle(self, points):
        from approximatenn_tpu.harness.compare_results import f64_oracle as j_oracle

        d2, okth = f64_oracle(points, 5)
        jd2, jokth = j_oracle(points, 5)
        np.testing.assert_array_equal(d2, jd2)
        np.testing.assert_array_equal(okth, jokth)
        with pytest.raises(ValueError, match="32768"):
            f64_oracle(np.zeros((32769, 1), np.float32), 1)

    def test_arbitrate_f64(self, points):
        import approximatenn_tpu as jann
        from approximatenn_tpu.harness.compare_results import arbitrate_f64 as j_arb

        g, _ = jann.brute_force_knn_self(points, 4)
        ga = np.asarray(g)
        gb = ga.copy()
        gb[3, 0], gb[9, 1], gb[20, 3] = 7, int(np.argmax(((points - points[9]) ** 2).sum(1))), 120
        for a, b in ((ga, ga), (ga, gb), (gb, ga)):
            got = arbitrate_f64(points, a, b, 4)
            assert got == j_arb(points, a, b, 4)
        got = arbitrate_f64(points, ga, gb, 4, oracle=f64_oracle(points, 4))
        assert got == j_arb(points, ga, gb, 4)
        assert got["diff_real"] >= 1

    @pytest.mark.parametrize("query_mode", [False, True])
    def test_true_ranks_and_score_guesses(self, points, rng, query_mode):
        from approximatenn_tpu.harness import scoring as js

        y = rng.standard_normal((30, 8)).astype(np.float32) if query_mode else None
        np.testing.assert_array_equal(true_ranks(points, y), js.true_ranks(points, y))
        m = 30 if query_mode else 120
        guess = rng.integers(0, 121, (m, 6))  # 120 = the sentinel id
        for k in (1, 4, 6):
            got = score_guesses(points, y, guess, k)
            want = js.score_guesses(points, y, guess, k)
            assert isinstance(got, Score)
            assert dataclass_tuple(got) == dataclass_tuple(want)
            assert str(got) == str(want)


def dataclass_tuple(s):
    return (s.mean_excess_rank, s.prob_correct, s.max_rank_over_k)


class TestCLIs:
    def test_test_correctness_index_mode(self, capsys):
        rc = test_correctness.main(
            ["-n", "200", "-k", "5", "-d", "16", "-o", "2", "--seed", "0", "-c"]
        )
        out = capsys.readouterr().out
        assert rc == 0 and "Prob correct" in out and "(on CPU)" in out
        prob = float(out.split("Prob correct: ")[1].split(".\n")[0])
        assert prob > 0.8

    def test_test_correctness_query_mode(self, capsys):
        rc = test_correctness.main(
            ["-n", "200", "-k", "5", "-d", "16", "-o", "2", "-z", "--seed", "0", "-c"]
        )
        out = capsys.readouterr().out
        assert rc == 0 and "query" in out
        assert float(out.split("Prob correct: ")[1].split(".\n")[0]) > 0.8

    def test_test_correctness_float64_leaves_ftype(self, capsys):
        import approximatenn_tpu_torch as tann

        before = tann.ftype()
        rc = test_correctness.main(["-n", "150", "-k", "4", "-d", "8", "-o", "1",
                                    "--seed", "1", "-c", "--dtype", "float64"])
        assert rc == 0 and "Prob correct" in capsys.readouterr().out
        assert tann.ftype() == before

    def test_time_results_modes(self, capsys):
        rc = time_results.main(
            ["-n", "128", "-k", "4", "-d", "8", "-o", "2", "--seed", "0", "-c"]
        )
        assert rc == 0 and "Average time for comp" in capsys.readouterr().out
        rc = time_results.main(
            ["-n", "128", "-k", "4", "-d", "8", "-o", "2", "-y", "16", "--seed", "0", "-c"]
        )
        assert rc == 0 and "query" in capsys.readouterr().out

    def test_compare_results_parity(self, capsys):
        """CPU against itself with one generator per sample: zero diffs in
        both graph modes."""
        rc = compare_results.main(
            ["-n", "200", "-k", "5", "-d", "16", "-o", "2", "--seed", "0", "-c"]
        )
        out = capsys.readouterr().out
        assert rc == 0
        rows = out.split("graph diff count: ")[1:]
        assert len(rows) == 2 and "[graph_mode=hash]" in out
        for row in rows:
            assert float(row.split(" ")[0]) == 0.0
            assert float(row.split("units): ")[1].split("\n")[0]) == 0.0

    def test_compare_results_query_mode(self, capsys):
        rc = compare_results.main(
            ["-n", "200", "-k", "5", "-d", "16", "-o", "2", "-z", "--seed", "0", "-c"]
        )
        out = capsys.readouterr().out
        assert rc == 0
        assert float(out.split("query diff count: ")[1].split(" ")[0]) == 0.0

    def test_compare_results_arbitration_and_band(self, capsys):
        rc = compare_results.main(
            ["-n", "200", "-k", "5", "-d", "16", "-o", "2", "--seed", "0", "-c",
             "--arbitrate", "--max-diff-frac", "0.01"]
        )
        out = capsys.readouterr().out
        assert rc == 0
        assert out.count("arbitration (f64 oracle)") == 2
        for row in out.splitlines():
            if "arbitration" in row:
                acc = float(row.split("acc=")[1].split(" ")[0])
                cpu = float(row.split("cpu=")[1].split(";")[0])
                assert acc == cpu > 0.9
                assert float(row.split("real=")[1]) == 0.0

    def test_compare_results_band_fails_loudly(self, capsys):
        rc = compare_results.main(
            ["-n", "200", "-k", "5", "-d", "16", "-o", "1", "--seed", "0", "-c",
             "--max-diff-frac", "-0.1"]
        )
        assert rc == 2 and "FAIL" in capsys.readouterr().out

    def test_ann_bench_table_and_packed(self, capsys):
        import json

        for extra in ([], ["--packed", "--n-probes", "12", "--window", "16",
                           "--packed-dtype", "bf16", "--rerank-width", "10"]):
            rc = ann_bench.main(["--dataset", "gaussian-10k", "--max-n", "2000",
                                 "--max-queries", "64", "--k", "5", "--tries", "4",
                                 "--batch", "64", "--reps", "2", "-c", *extra])
            rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            assert rc == 0 and rec["synthetic"] is True and rec["device"] == "cpu"
            assert rec["n"] == 2000 and rec["batch"] == 64 and rec["qps"] > 0
            assert rec["recall_at_k"] > 0.8
            assert rec["layout"] == ("packed" if extra else "table")
        with pytest.raises(SystemExit):
            ann_bench.main(["--packed", "--fused", "-c"])


def test_resolve_backend():
    assert resolve_backend(True) == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: resolve_backend(False) returns it")
    with pytest.raises(RuntimeError, match="-c"):
        resolve_backend(False)
    with pytest.raises(RuntimeError, match="CUDA"):
        test_correctness.main(["-n", "50", "-o", "1"])


@pytest.mark.cuda
def test_resolve_backend_gives_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert resolve_backend(False).type == "cuda"
