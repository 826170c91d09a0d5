"""The roofline arithmetic: peaks, each kernel's operations and bytes, the
kernel names of the device trace and the trace's reduction."""

import pytest

from benchlib import roofline, tracing


@pytest.mark.parametrize("m,flop,ms", [(1000, 2.56e11, 1.552), (10_000, 2.56e12, 15.52)])
def test_rank_serving_bound_1m(m, flop, ms):
    ops, nbytes = roofline.rank_call(1_000_000, 128, m, 10, "float32")
    assert ops == flop
    assert nbytes == 1_000_000 * 128 * 4 + m * 128 * 4 + m * 10 * 8
    assert roofline.bound_s(ops, nbytes, "float32") == pytest.approx(ms * 1e-3, rel=1e-3)


@pytest.mark.parametrize("m,flop,ms", [(1000, 1.92e12, 1.941), (10_000, 1.92e13, 19.41)])
def test_emit_bound_10m_bf16(m, flop, ms):
    ops, nbytes = roofline.emit_call(10_000_000, 96, m, 512, "bfloat16")
    assert ops == flop
    # operations bound it at 989 TFLOP/s; the bytes (corpus, queries, the
    # segment minima) take far less
    assert roofline.bound_s(ops, nbytes, "bfloat16") == pytest.approx(ms * 1e-3, rel=1e-3)
    assert nbytes / roofline.HBM_BYTES_PER_S < ops / roofline.PEAK_OPS["bfloat16"]


def test_graph_bound_1m():
    ops, _ = roofline.rank_call(1_000_000, 128, 1_000_000, 10, "float32", exclude=True)
    assert ops / roofline.PEAK_OPS["float32"] == pytest.approx(1.552, rel=1e-3)


def test_probe_bound_is_bytes():
    # the probe's read measured at 1M: 903 MB of distinct bf16 rows (3.53M rows of 128)
    slots = 903e6 / (128 * 2)
    ops, nbytes = roofline.probe_call(slots, 128, 1000, 10, 18, 96, 10, "bfloat16")
    assert nbytes / roofline.HBM_BYTES_PER_S > 50 * ops / roofline.PEAK_OPS["bfloat16"]
    assert roofline.bound_s(ops, nbytes, "bfloat16") == pytest.approx(0.270e-3, rel=0.02)


def test_share_needs_a_time():
    assert roofline.share_pct(1.0, 0.0) is None
    assert roofline.share_pct(1.0, 4.0) == 25.0


@pytest.mark.parametrize("name,group", [
    ("void knn::tile::tiled_kernel<float, (anonymous namespace)::RankSelect<float>, 0>"
     "(knn::tile::TiledArgs)", "rank"),
    ("void knn::tile::tiled_kernel<__nv_bfloat16, (anonymous namespace)::EmitSelect"
     "<__nv_bfloat16>, 0>(knn::tile::TiledArgs)", "emit"),
    ("void (anonymous namespace)::rescan_kernel<__nv_bfloat16, 8, 4>(...)", "rescan"),
    ("void (anonymous namespace)::probe_kernel<__nv_bfloat16, 8>(...)", "probe"),
    ("_Z12tiled_kernelIf10RankSelectIfELi0EEv9TiledArgs", "rank"),
    ("void at::native::reduce_kernel<512, 1>(...)", None),
])
def test_kernel_groups(name, group):
    assert roofline.kernel_group(name) == group


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_reduce_trace():
    rank = "tiled_kernel<float, RankSelect<float>, 0>"
    events = [
        _ev("user_annotation", tracing.SLICE, 0.0, 1000.0),
        _ev("user_annotation", "bench.search", 0.0, 300.0),
        _ev("cpu_op", "aten::copy_", 50.0, 100.0),
        _ev("kernel", rank, 200.0, 400.0),
        _ev("kernel", "knn::split_merge_kernel(float const*)", 600.0, 5.0),
        _ev("gpu_memcpy", "Memcpy DtoH", 605.0, 95.0),
        _ev("kernel", rank, 1200.0, 100.0),  # after the slice: not counted
    ]
    r = tracing.reduce_trace(events, 1, {"exact_knn": 1})
    assert r.window_s == pytest.approx(1e-3)
    assert r.busy_s == pytest.approx(500e-6)
    # the split merge joins the rank call's time, not its count
    assert r.groups["rank"] == (pytest.approx(405e-6), 1)
    gaps = dict(r.idle_gaps)
    assert gaps["bench.search > aten::copy_"] == pytest.approx(200e-6)
    assert gaps["host idle"] == pytest.approx(300e-6)
    assert r.device_ops[0][0] == rank
