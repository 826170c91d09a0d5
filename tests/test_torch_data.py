"""The port's dataset layer (``approximatenn_tpu_torch.data``) against the
JAX package's on the CPU.

File formats: round trips, and the same bytes as the JAX writer (both
readers read both files).  ``synthesize``: arrays bit-identical to the JAX
package's.  ``ensure_groundtruth``: the same ids as the JAX package's, l2
and angular (queries in general position: no distance ties at these
sizes).  ``load``: from files the test writes under ``ANN_TPU_DATA``
(nothing is downloaded).
"""

import numpy as np
import pytest
import torch

from approximatenn_tpu_torch.data import (SPECS, Dataset, ensure_groundtruth, load,
                                          read_any, read_vecs, synthesize, vecs_info,
                                          write_vecs)
from approximatenn_tpu_torch.data import datasets as tds

torch.set_num_threads(1)


class TestFormats:
    @pytest.mark.parametrize("suffix,comp", [
        (".fvecs", np.float32), (".ivecs", np.int32), (".bvecs", np.uint8),
    ])
    def test_roundtrip_and_same_bytes_as_jax(self, tmp_path, rng, suffix, comp):
        from approximatenn_tpu.data import formats as jf

        if comp is np.uint8:
            arr = rng.integers(0, 256, (13, 9)).astype(comp)
        elif comp is np.int32:
            arr = rng.integers(-1000, 1000, (13, 9)).astype(comp)
        else:
            arr = rng.standard_normal((13, 9)).astype(comp)
        p, q = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
        write_vecs(p, arr)
        jf.write_vecs(q, arr)
        assert p.read_bytes() == q.read_bytes()
        np.testing.assert_array_equal(read_vecs(p, dtype=comp), arr)
        np.testing.assert_array_equal(read_vecs(q, dtype=comp), jf.read_vecs(p, dtype=comp))
        assert vecs_info(p) == jf.vecs_info(q) == {"n": 13, "d": 9, "component": str(np.dtype(comp))}
        np.testing.assert_array_equal(read_any(p, dtype=comp, offset=4, count=5), arr[4:9])

    def test_offset_count_and_npy(self, tmp_path, rng):
        arr = rng.standard_normal((20, 5)).astype(np.float32)
        p = tmp_path / "x.fvecs"
        write_vecs(p, arr)
        np.testing.assert_array_equal(read_vecs(p, offset=7, count=4), arr[7:11])
        np.testing.assert_array_equal(read_vecs(p, offset=18, count=9), arr[18:])
        n = tmp_path / "x.npy"
        np.save(n, arr)
        np.testing.assert_array_equal(read_any(n), arr)
        np.testing.assert_array_equal(read_any(n, offset=2, count=3), arr[2:5])
        np.testing.assert_array_equal(read_any(n, mmap=False), arr)

    def test_errors(self, tmp_path, rng):
        arr = rng.standard_normal((4, 3)).astype(np.float32)
        p = tmp_path / "x.fvecs"
        write_vecs(p, arr)
        raw = bytearray(p.read_bytes())
        raw[16:20] = np.int32(7).tobytes()  # corrupt row 1's dim field
        p.write_bytes(raw)
        with pytest.raises(ValueError, match="row 1"):
            read_vecs(p)
        with pytest.raises(ValueError, match="format"):
            write_vecs(tmp_path / "x.txt", arr)
        write_vecs(tmp_path / "y.fvecs", arr)
        with pytest.raises(ValueError, match="out of range"):
            read_vecs(tmp_path / "y.fvecs", offset=9)
        (tmp_path / "z.fvecs").write_bytes(np.int32(5).tobytes() + b"\0" * 7)
        with pytest.raises(ValueError, match="multiple"):
            vecs_info(tmp_path / "z.fvecs")


class TestSynthetic:
    @pytest.mark.parametrize("name,max_n", [("gaussian-10k", 3000), ("gaussian-100k", 60_000),
                                            ("clustered-hard-1m", 20_000)])
    def test_synthesize_bit_identical_to_jax(self, name, max_n):
        from approximatenn_tpu.data.datasets import synthesize as j_synth

        spec = SPECS[name]
        nq = 50
        ds = synthesize(name, max_n, spec["d"], nq, spec["metric"])
        jds = j_synth(name, max_n, spec["d"], nq, spec["metric"])
        assert ds.synthetic and (ds.n, ds.d) == (max_n, spec["d"])
        assert ds.base.dtype == jds.base.dtype == np.float32
        np.testing.assert_array_equal(ds.base, jds.base)
        np.testing.assert_array_equal(ds.queries, jds.queries)
        assert ds.metric == jds.metric

    def test_specs_match_jax(self):
        from approximatenn_tpu.data.datasets import SPECS as J_SPECS

        assert SPECS == J_SPECS


class TestGroundTruth:
    @pytest.mark.parametrize("metric", ["l2", "angular"])
    def test_ensure_groundtruth_matches_jax(self, metric):
        from approximatenn_tpu.data.datasets import ensure_groundtruth as j_gt

        ds = synthesize("t", 700, 12, 25, metric)
        jds = synthesize("t", 700, 12, 25, metric)  # the same arrays, a dataset of its own
        gt = ensure_groundtruth(ds, 6, device="cpu")
        want = j_gt(jds, 6)
        assert gt.dtype == np.int32 and gt.shape == (25, 6)
        np.testing.assert_array_equal(gt, want)
        # cached on the dataset: a second call returns it, cut to k
        assert ds.groundtruth is gt
        np.testing.assert_array_equal(ensure_groundtruth(ds, 4), gt[:, :4])

    def test_ensure_groundtruth_needs_a_device(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: ground truth goes to it")
        ds = synthesize("t", 100, 4, 5, "l2")
        with pytest.raises(RuntimeError, match="CUDA"):
            ensure_groundtruth(ds, 3)


class TestLoad:
    def test_load_from_files(self, tmp_path, rng, monkeypatch):
        monkeypatch.setenv("ANN_TPU_DATA", str(tmp_path))
        assert tds.data_root() == tmp_path
        d = tmp_path / "sift-1m"
        d.mkdir()
        base = rng.standard_normal((300, 8)).astype(np.float32)
        qs = rng.standard_normal((20, 8)).astype(np.float32)
        write_vecs(d / "base.fvecs", base)
        write_vecs(d / "query.fvecs", qs)
        ds = load("sift-1m", max_queries=10)
        assert isinstance(ds, Dataset) and not ds.synthetic
        assert ds.metric == "l2" and (ds.n, ds.d) == (300, 8)
        np.testing.assert_array_equal(ds.base, base)
        np.testing.assert_array_equal(ds.queries, qs[:10])
        assert ds.groundtruth is None
        # computed, then cached next to the real data, and read back
        gt = ensure_groundtruth(ds, 5, device="cpu")
        assert (d / "groundtruth.ivecs").exists()
        again = load("sift-1m", max_queries=10)
        np.testing.assert_array_equal(again.groundtruth, gt)
        # a truncated base drops the ground truth (ids of the full base)
        assert load("sift-1m", max_n=100).groundtruth is None

    def test_load_npy_without_queries_and_unknown(self, tmp_path, rng, monkeypatch):
        monkeypatch.setenv("ANN_TPU_DATA", str(tmp_path))
        (tmp_path / "mine").mkdir()
        base = rng.standard_normal((50, 3)).astype(np.float32)
        np.save(tmp_path / "mine" / "base.npy", base)
        ds = load("mine", max_queries=7)
        np.testing.assert_array_equal(ds.queries, base[:7])
        with pytest.raises(FileNotFoundError):
            load("nothing-here")
        with pytest.raises(FileNotFoundError):
            load("gaussian-10k", allow_synthetic=False)

    def test_load_falls_back_to_the_jax_stand_in(self, tmp_path, monkeypatch):
        from approximatenn_tpu.data.datasets import load as j_load

        monkeypatch.setenv("ANN_TPU_DATA", str(tmp_path))
        ds = load("gaussian-10k", max_n=2000, max_queries=30)
        jds = j_load("gaussian-10k", max_n=2000, max_queries=30)
        assert ds.synthetic and (ds.n, ds.queries.shape[0]) == (2000, 30)
        np.testing.assert_array_equal(ds.base, jds.base)
        np.testing.assert_array_equal(ds.queries, jds.queries)
