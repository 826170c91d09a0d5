"""The harness on the CPU at tiny sizes: the result line's keys, a cell
and a kind of run added as files alone, the refusals of a run without a
card, with the JAX package loaded or with a metric the reference does not
compute, and ``correct`` coming out false under each fault a cell can have
(the look for a chip skipped, the rest of a run driven)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import run as entry
from benchlib import faults
from benchlib.harness import load_cell, make_run, prefixes, resolve

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TINY = {"n": 20_000, "n_queries": 2_000}
SEED = 2**31 + 11


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


EXACT = "sift-1m.exact-b10000-pinned"
HASH = "sift-1m.hash-b10000"


def _run(name, trace=False, wrap=None, seconds=0.5, sizes=TINY, batch=1000, **kw):
    cell = load_cell(name)
    if cell.kind == "build":
        cell.traffic = dict(cell.traffic, warmup_rows=1000)
    else:
        cell.traffic = dict(cell.traffic, batch=batch)
    return make_run(cell, SEED, seconds, trace, device="cpu", wrap=wrap, sizes=sizes,
                    **kw).run()


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    r = _run(EXACT, trace=trace, seconds=1.5 if trace else 0.5)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] % 1000 == 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in r["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"], name
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU has no device trace
        assert set(r["metrics"]) == {"server.host_ms.exact.sift-1m", "exact_p95_ms.sift-1m"}
    else:
        assert set(r["metrics"]) == {"exact_qps.sift-1m", "setup_s"}
        for m in r["metrics"].values():
            assert m["value"] > 0 and m["unit"]
    json.dumps(r)


def _bench_copy(tmp_path):
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics", "kinds"):
        shutil.copytree(BENCH / sub, bench / sub)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "sift-1m.json").read_text())
    cfg.update(name="tiny-l2", n=5000, d=24, n_queries=1000,
               data={"kind": "clustered_gaussian", "n_clusters": 40, "spread": 3.0,
                     "zipf": 1.1})
    (bench / "configs" / "tiny-l2.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "tiny-l2", "source": "https://example.org/tiny",
                            "file": "benchmark/configs/tiny-l2.json", "reduced": [],
                            "why": "a test"})
    return bench, spec, cfg


def test_cell_added_as_data(tmp_path):
    """A configuration, a traffic mix, limits and a per-layer metric added
    as new files and entries, with no file of the harness edited; the
    cell's end-to-end metric and the metric split by configuration take
    the kind's quantity and the reader of their dotted prefix."""
    bench, spec, _ = _bench_copy(tmp_path)
    (bench / "traffic" / "exact-b500.json").write_text(json.dumps(
        {"kind": "exact", "loop": "closed", "clients": 1, "batch": 500}))
    (bench / "limits" / "tiny-l2.exact-b500.json").write_text(json.dumps(
        {"limits": {"dist_err": 1e-5, "rank_gap": 1e-5}}))
    (bench / "metrics" / "queries_per_batch.py").write_text(
        "def read(ctx):\n    return float(ctx.batch)\n")
    spec["workloads"].append({"name": "tiny-l2.exact-b500", "config": "tiny-l2",
                              "traffic": "exact-b500", "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "exact_qps.tiny-l2", "unit": "queries/s",
                               "better": "higher", "bound": 0.05, "source": "host_clock",
                               "workloads": ["tiny-l2.exact-b500"]})
    spec["per_layer"] += [
        {"name": "queries_per_batch", "unit": "queries", "better": "higher",
         "source": "program_counter", "layer": "traffic", "moves": "exact_qps.tiny-l2",
         "workloads": ["tiny-l2.exact-b500"]},
        {"name": "server.host_ms.exact.tiny-l2", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "engine/serving.py (Server: routing, entry)",
         "moves": "exact_qps.tiny-l2", "workloads": ["tiny-l2.exact-b500"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = load_cell("tiny-l2.exact-b500", bench_dir=bench)
    assert cell.config["n"] == 5000 and cell.traffic["batch"] == 500
    assert [m["name"] for m in cell.per_layer] == ["queries_per_batch",
                                                   "server.host_ms.exact.tiny-l2"]
    r = make_run(cell, SEED, 1.5, True, device="cpu").run()
    assert r["correct"] is True
    assert r["metrics"]["queries_per_batch"] == {"value": 500.0, "unit": "queries"}
    assert r["metrics"]["server.host_ms.exact.tiny-l2"]["value"] > 0
    r = make_run(cell, SEED, 0.3, False, device="cpu").run()
    assert set(r["metrics"]) == {"exact_qps.tiny-l2", "setup_s"}


KIND = '''
from benchlib import check, reference, system
from benchlib.serve import SearchRun


class Run(SearchRun):
    """Exact search with k + 1 asked and the first k kept."""

    def make_engine(self, corpus, k):
        srv = system.ServerEngine(corpus, k + 1, self.cell.spec, self.seed)

        class Engine:
            def search(self, q):
                ids, dd = srv.search(q)
                return ids[:, :k], dd[:, :k]
        return Engine()

    def check(self):
        corpus, _ = self.draw()
        ids, dd, q = self.sampled(corpus.device)
        _, ref_d = reference.knn(corpus, q, self.cell.config["k"])
        return check.exact_numbers(ids, dd, q, corpus, corpus.dtype, ref_d,
                                   check.median_sq_norm(corpus))
'''


def test_kind_added_as_a_file(tmp_path):
    """A new kind of run (its loop, quantities and check) added as
    ``kinds/<kind>.py``, with a traffic mix naming it: no harness edit."""
    bench, spec, cfg = _bench_copy(tmp_path)
    cfg["serving"]["exact_k1"] = cfg["serving"]["exact"]
    (bench / "configs" / "tiny-l2.json").write_text(json.dumps(cfg))
    (bench / "kinds" / "exact_k1.py").write_text(KIND)
    (bench / "traffic" / "k1-b250.json").write_text(json.dumps(
        {"kind": "exact_k1", "loop": "closed", "clients": 1, "batch": 250}))
    (bench / "limits" / "tiny-l2.k1-b250.json").write_text(json.dumps(
        {"limits": {"dist_err": 1e-5, "rank_gap": 1e-5}}))
    spec["workloads"].append({"name": "tiny-l2.k1-b250", "config": "tiny-l2",
                              "traffic": "k1-b250", "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "exact_k1_qps", "unit": "queries/s",
                               "better": "higher", "bound": 0.05, "source": "host_clock",
                               "workloads": ["tiny-l2.k1-b250"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    r = make_run(load_cell("tiny-l2.k1-b250", bench_dir=bench), SEED, 0.3, False,
                 device="cpu").run()
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == {"exact_k1_qps", "setup_s"}


def test_a_metric_the_reference_does_not_compute_fails_loudly():
    cell = load_cell(EXACT)
    cell.config = dict(cell.config, metric="angular")
    with pytest.raises(ValueError, match="angular"):
        make_run(cell, SEED, 0.1, False, device="cpu")


def test_host_memory_is_one_the_client_knows():
    assert load_cell(EXACT).traffic["host_memory"] == "pinned"
    cell = load_cell(EXACT)
    cell.traffic = dict(cell.traffic, batch=1000, host_memory="mapped")
    with pytest.raises(ValueError, match="mapped"):
        make_run(cell, SEED, 0.1, False, device="cpu", sizes=TINY).run()


def test_names_resolve_by_dotted_prefix():
    assert prefixes("a.b-c.d") == ["a.b-c.d", "a.b-c", "a"]
    assert resolve("exact_qps.sift-1m", {"exact_qps": 2.0, "setup_s": 1.0}) == 2.0
    with pytest.raises(KeyError):
        resolve("hash_qps", {"exact_qps": 2.0})


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = entry.main(["--workload", EXACT, "--seed", "1", "--seconds", "1",
                     "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_modules_compared_whole(monkeypatch):
    assert entry.forbidden_modules() == []
    import approximatenn_tpu_torch  # noqa: F401  (begins with the JAX package's name)
    assert entry.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "approximatenn_tpu", object())
    assert entry.forbidden_modules() == ["approximatenn_tpu", "jaxlib"]


def test_harness_and_program_load_no_jax():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; import run; "
            "from benchlib import harness, system, reference, check, tracing, layers; "
            "import approximatenn_tpu_torch; from approximatenn_tpu_torch.ops import exact; "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), str(BENCH)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    src = (BENCH / "benchlib" / "reference.py").read_text()
    assert "approximatenn" not in src.split('"""', 2)[2]


# ---------------------------------------------------------------- faults
TINY_BUILD = {"n": 8000, "n_queries": 1000}


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_exact_faults_fail(fault):
    r = _run(EXACT, wrap=faults.wrap(fault))
    assert r["correct"] is False


def test_stale_fails_with_the_whole_pool_a_batch():
    """A batch of the whole pool is the same set each time: returning the
    last batch's answers still fails, since each pass has its own order."""
    r = _run(EXACT, wrap=faults.wrap("stale"), batch=TINY["n_queries"])
    assert r["correct"] is False


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_build_faults_fail(fault):
    r = _run("sift-1m.build", wrap=faults.broken_build(fault, TINY_BUILD["n"]),
             seconds=2.5, sizes=TINY_BUILD)
    assert r["attempted"] >= 2
    assert r["correct"] is False


def test_build_is_correct():
    r = _run("sift-1m.build", seconds=1.0, sizes=TINY_BUILD)
    assert r["correct"] is True, r["checks"]


TINY_HASH = {"n": 4000, "n_queries": 1000}
# a table's probe windows cover a small share of its rows, as at the cell's
# size, so that a table or probes lost change the answers
SPARSE_HASH = {"n": 20000, "n_queries": 1000}


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """Route packed serving to the probe kernel's path on the CPU too (its
    plain version there), the path the cell's card runs."""
    import approximatenn_tpu_torch.engine.serving as serving

    monkeypatch.setattr(serving, "packed_route", lambda *a, **k: "fused")


def _hash(wrap=None, control=False, sizes=TINY_HASH):
    cell = load_cell(HASH)
    cell.traffic = dict(cell.traffic, batch=100, warmup_batches=1)
    return make_run(cell, SEED, 1.0, False, device="cpu", wrap=wrap, sizes=sizes,
                    control=control).run()


def test_hash_is_correct_and_its_control_is_not(fused_on_cpu):
    r = _hash()
    assert r["correct"] is True, r["checks"]
    assert set(r["checks"]) == {"code_flips", "layout_errors", "graph_gap", "dist_err",
                                "mismatch_share"}
    c = _hash(control=True)
    assert c["correct"] is False
    assert any(v["value"] > v["limit"] for v in c["checks"].values())


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "drop_table", "drop_probes"])
def test_hash_faults_fail(fused_on_cpu, fault):
    sizes = SPARSE_HASH if fault.startswith("drop") else TINY_HASH
    assert _hash(wrap=faults.wrap(fault), sizes=sizes)["correct"] is False


@pytest.mark.parametrize("fault,number", [("codes", "code_flips"), ("graph", "graph_gap")])
def test_hash_index_faults_fail_on_their_number(fused_on_cpu, fault, number):
    """A served index hashed into the wrong buckets, or with a wrong kNN
    graph, is caught by the check's own codes and graph rows: the reference
    does not follow the program's mistake."""
    r = _hash(wrap=faults.wrap(fault))
    assert r["correct"] is False
    c = r["checks"][number]
    assert c["value"] > c["limit"]
