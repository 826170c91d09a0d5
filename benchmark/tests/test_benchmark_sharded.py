"""The sharded kind on the CPU (four gloo ranks at a tiny size) and its
readers: the result line of a run over several ranks, ``correct`` from the
shards' reference and false under a planted fault, the merge's and the
entry's span readers, and ``emit_roofline.shard``'s accounting where the
engine launches the emit several times a batch."""

import json
import time
from types import SimpleNamespace

import pytest

from benchlib import faults, roofline
from benchlib.harness import load_cell, make_run

CELL = "deep-1b-bf16.sharded-b10000"
SEED = 2**31 + 17
TINY = {"n": 40_003, "n_queries": 1_000}


def _cell(**config):
    cell = load_cell(CELL)
    cell.traffic = dict(cell.traffic, batch=500)
    cell.config = dict(cell.config, **config)
    return cell


def _reader(name):
    return load_cell(CELL).readers[name]


def test_four_ranks_result_line_and_check():
    """float32 storage on the CPU (whose rank route ranks as float64 does to
    rounding): ``correct`` under tight limits, the card count, the traced
    span metrics; false with an answer altered on every rank."""
    cell = _cell(serving={"sharded": {"mode": "exact"}})
    cell.limits = {"dist_err": 1e-5, "rank_gap": 1e-5}
    r = make_run(cell, SEED, 0.5, False, device="cpu", sizes=TINY).run()
    assert r["correct"] is True and r["attempted"] % 500 == 0, r
    assert r["device"]["count"] == 4 and r["device"]["platform"] == "cpu"
    assert set(r["metrics"]) == {"exact_qps.deep-10m-bf16", "setup_s"}
    json.dumps(r)
    t = make_run(cell, SEED, 1.5, True, device="cpu", sizes=TINY).run()
    assert t["correct"] is True
    # the CPU has no device trace: the span and client readers only
    assert set(t["metrics"]) == {"exact_p95_ms.deep-1b-bf16", "sharded.merge_ms",
                                 "sharded.self_ms"}
    assert 0 < t["metrics"]["sharded.merge_ms"]["value"]
    bad = make_run(cell, SEED, 0.5, False, device="cpu", sizes=TINY,
                   wrap=faults.wrap("altered")).run()
    assert bad["correct"] is False and bad["checks"]["dist_err"]["value"] > 1e-3


def test_span_readers():
    from approximatenn_tpu_torch.utils.profiling import reset_spans, span

    merge, self_ms = _reader("sharded.merge_ms"), _reader("sharded.self_ms")
    reset_spans()
    assert merge(None) is None and self_ms(None) is None
    for _ in range(3):
        with span("sharded.search"):
            time.sleep(0.004)
            with span("exact.twophase"):
                time.sleep(0.002)
            with span("sharded.merge"):
                time.sleep(0.003)
    with span("server.search"):  # another root: not read
        with span("sharded.merge"):
            time.sleep(0.05)
    assert 3 <= merge(None) < 40
    assert 4 <= self_ms(None) < 40
    reset_spans()


def _ctx(launched, engine_calls, secs, m=10_000, n_local=250_000_000):
    trace = SimpleNamespace(groups={"emit": (secs, launched)},
                            launches={"twophase_emit": launched,
                                      "twophase_calls": engine_calls})
    return SimpleNamespace(trace=trace, spec={"storage_dtype": "bfloat16"}, n_local=n_local,
                           n=4 * n_local, d=96, batch=m)


def test_emit_roofline_shard_counts_blocks():
    """Ten emit calls a batch (query blocks) do one batch's products and
    read the shard ten times: the bound is a batch's, the time the ten
    calls'; one call a batch reads what ``emit_roofline`` reads."""
    read = _reader("emit_roofline.shard")
    n_local, d = 250_000_000, 96
    shard = n_local * d * 2
    # m = 10,000: the products bound a batch
    ops = 2.0 * 10_000 * n_local * d
    got = read(_ctx(launched=40, engine_calls=4, secs=4 * 1.5))
    assert got == pytest.approx(100 * ops / roofline.PEAK_OPS["bfloat16"] / 1.5)
    # m = 1: the bytes do, the shard counted once a call
    nbytes = 10 * shard + d * 4 + -(-n_local // 512) * 8
    got = read(_ctx(launched=40, engine_calls=4, secs=4 * 0.5, m=1))
    assert got == pytest.approx(100 * nbytes / roofline.HBM_BYTES_PER_S / 0.5)
    one = load_cell("deep-10m-bf16.exact-b10000").readers["emit_roofline"]
    ctx = _ctx(launched=3, engine_calls=3, secs=0.17, n_local=10_000_000)
    ctx.n = 10_000_000
    assert read(ctx) == pytest.approx(one(ctx))
    assert read(_ctx(launched=40, engine_calls=0, secs=1.0)) is None
    missing = _ctx(launched=40, engine_calls=4, secs=1.0)
    del missing.trace.launches["twophase_calls"]
    assert read(missing) is None
