"""The port's native host runtime and utils against the JAX package's on the
CPU.

``native``: ``bucket_table``, ``brute_force_knn`` and ``rank_guesses``
equal to the JAX package's on the same inputs, through the compiled
library (built into the package's ``_build/``) and through the numpy
fallbacks.  ``utils``: ``StageTimes``, ``trace``, ``annotate``, the cleanup
registry, ``device_init`` (the CPU on request; no quiet fallback from the
card) and ``device_summary``'s keys.
"""

import json

import numpy as np
import pytest
import torch

from approximatenn_tpu_torch import native
from approximatenn_tpu_torch.native import lib
from approximatenn_tpu_torch.utils import runtime
from approximatenn_tpu_torch.utils.profiling import StageTimes, annotate, fence, trace

torch.set_num_threads(1)


@pytest.fixture(params=["built", "fallback"])
def path(request, monkeypatch):
    """Run a case through both packages' compiled libraries, then through
    both numpy fallbacks."""
    from approximatenn_tpu.native import lib as jlib

    if request.param == "built":
        assert native.available() and jlib.available()
    else:
        monkeypatch.setattr(lib, "_load", lambda: None)
        monkeypatch.setattr(jlib, "_load", lambda: None)
        assert not native.available()
    return request.param


def test_library_builds_into_the_build_directory():
    assert native.available()
    so = lib.library_path()
    assert so.exists() and so.parent == lib.BUILD_DIR
    assert so.parent.name == "_build" and so.parent.parent.name == "approximatenn_tpu_torch"
    assert not list((lib._SRC.parent.parent).glob("*.so"))  # nothing next to the source


class TestBucketTable:
    @pytest.mark.parametrize("capacity", [None, 3, 40])
    def test_matches_jax(self, rng, path, capacity):
        from approximatenn_tpu import native as jn

        n, nb = 500, 32
        codes = rng.integers(0, nb, n).astype(np.int32)
        table, counts, tmax = native.bucket_table(codes, nb, capacity, n)
        jt, jc, jm = jn.bucket_table(codes, nb, capacity, n)
        np.testing.assert_array_equal(table, jt)
        np.testing.assert_array_equal(counts, jc)
        assert tmax == jm

    def test_first_seen_order_and_overflow(self, path):
        codes = np.array([2, 0, 2, 1, 2], np.int32)
        table, counts, tmax = native.bucket_table(codes, 4, None, 5)
        assert tmax == 3
        np.testing.assert_array_equal(table[2], [0, 2, 4])
        np.testing.assert_array_equal(table[0], [1, 5, 5])
        table, _, tmax = native.bucket_table(np.zeros(10, np.int32), 2, 3, 10)
        assert tmax == 10 and table.shape == (2, 3)
        np.testing.assert_array_equal(table[0], [0, 1, 2])
        with pytest.raises(ValueError):
            native.bucket_table(np.array([5], np.int32), 4, None, 1)


class TestBruteForce:
    @pytest.mark.parametrize("k,offset", [(7, -1), (3, 0), (400, -1)])
    def test_matches_jax(self, rng, path, k, offset):
        from approximatenn_tpu import native as jn

        n, d, m = 300, 17, 23
        p = rng.standard_normal((n, d)).astype(np.float32)
        q = p[:m] + 0.01 * rng.standard_normal((m, d)).astype(np.float32)
        ids, dd = native.brute_force_knn(p, q, k, exclude_self_offset=offset)
        jids, jdd = jn.brute_force_knn(p, q, k, exclude_self_offset=offset)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(dd, jdd)
        if offset == 0:
            assert not any(i in ids[i] for i in range(m))
        if k > n:
            assert (ids[:, n:] == n).all() and np.isinf(dd[:, n:]).all()

    def test_agrees_with_the_torch_oracle(self, rng):
        from approximatenn_tpu_torch.ops.distance import brute_force_knn

        p = rng.standard_normal((400, 12)).astype(np.float32)
        q = rng.standard_normal((30, 12)).astype(np.float32)
        ids, dd = native.brute_force_knn(p, q, 6)
        tids, tdd = brute_force_knn(torch.from_numpy(p), torch.from_numpy(q), 6)
        np.testing.assert_array_equal(np.sort(ids, 1), np.sort(tids.numpy(), 1))
        np.testing.assert_allclose(dd, tdd.numpy(), rtol=1e-4, atol=1e-5)


class TestRankGuesses:
    @pytest.mark.parametrize("offset", [-1, 0])
    def test_matches_jax(self, rng, path, offset):
        from approximatenn_tpu import native as jn

        n, d, m, k = 120, 9, 10, 5
        p = rng.standard_normal((n, d)).astype(np.float32)
        q = p[:m].copy() if offset == 0 else rng.standard_normal((m, d)).astype(np.float32)
        guesses = rng.integers(-1, n + 1, (m, k)).astype(np.int32)  # bad ids at both ends
        guesses[0] = native.brute_force_knn(p, q, k, exclude_self_offset=offset)[0][0]
        got = native.rank_guesses(p, q, guesses, exclude_self_offset=offset)
        want = jn.rank_guesses(p, q, guesses, exclude_self_offset=offset)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got[1][0] == 0 and got[2][0] <= k - 1  # the exact row misses nothing

    def test_sentinel_guess_worst_rank(self, rng, path):
        p = rng.standard_normal((30, 4)).astype(np.float32)
        rank_sum, miss, mx = native.rank_guesses(p, p[:2], np.full((2, 3), 30, np.int32))
        np.testing.assert_array_equal(mx, 30)
        np.testing.assert_array_equal(miss, 3)
        np.testing.assert_array_equal(rank_sum, 90)


class TestProfiling:
    def test_stage_times_accumulate_and_fence(self):
        st = StageTimes()
        with st.stage("a") as sink:
            sink.append({"x": [torch.ones(4, 4) * 2]})
        with st.stage("a"):
            pass
        with st.stage("b") as sink:
            sink.append(("no tensor", None))
        assert st.counts["a"] == 2 and st.totals["a"] > 0 and st.counts["b"] == 1
        report = st.report()
        assert "a" in report and "x2" in report
        fence()
        fence("cpu")
        fence(torch.zeros(1))

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with trace(str(tmp_path)) as d:
            with annotate("ann: region"):
                torch.ones(64, 64).sum()
        assert d == str(tmp_path)
        data = json.loads((tmp_path / "trace.json").read_text())
        names = {e.get("name") for e in data["traceEvents"]}
        assert "ann: region" in names

    def test_trace_noops_where_the_profiler_cannot_start(self, tmp_path, monkeypatch):
        def refuse(*a, **kw):
            raise RuntimeError("profiler unavailable")

        monkeypatch.setattr(torch.profiler, "profile", refuse)
        with trace(str(tmp_path / "t")) as d:
            assert torch.ones(3).sum() == 3
        assert d == str(tmp_path / "t") and not (tmp_path / "t").exists()

    def test_annotate_outside_a_trace(self):
        with annotate("no profiler"):
            assert torch.ones(2).sum() == 2


class TestRuntime:
    def test_device_init_cpu_and_dtypes(self):
        assert runtime.device_init("cpu") == torch.device("cpu")
        assert runtime.device_init("cpu", require_dtype=torch.float64).type == "cpu"
        assert runtime.device_init("cpu", require_dtype="bfloat16").type == "cpu"
        with pytest.raises(TypeError):
            runtime.device_init("cpu", require_dtype="float12")
        with pytest.raises(ValueError, match="TPU"):
            runtime.device_init("tpu")

    def test_device_init_never_falls_back_from_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: device_init() returns it")
        for prefer in (None, "gpu", "cuda"):
            with pytest.raises(RuntimeError, match="cpu"):
                runtime.device_init(prefer)

    def test_cleanup_registry(self):
        order = []
        runtime.register_cleanup(lambda: order.append("a"))
        runtime.register_cleanup(lambda: order.append("b"))
        runtime.register_cleanup(lambda: 1 / 0)  # exceptions suppressed
        runtime.cleanup()
        assert order == ["b", "a"]  # LIFO
        runtime.cleanup()
        assert order == ["b", "a"]

    def test_device_summary_keys(self):
        from approximatenn_tpu.utils import runtime as jrt

        info = runtime.device_summary()
        assert set(jrt.device_summary()) <= set(info)
        assert info["process_count"] == 1 and info["device_count"] == len(info["devices"])
        if torch.cuda.is_available():
            assert info["platform"] == "gpu" and "card" in info
        else:
            assert info["platform"] == "cpu" and info["devices"] == ["cpu"]


@pytest.mark.cuda
def test_device_init_and_summary_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = runtime.device_init()
    assert dev.type == "cuda" and runtime.device_init("gpu") == dev
    info = runtime.device_summary()
    assert info["platform"] == "gpu" and info["devices"][0] == torch.cuda.get_device_name(0)
    assert info["card"] and "W" in info["card"]
