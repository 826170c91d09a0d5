"""The two-phase emit kernel's share of its roofline over one shard, on
rank 0's card: a batch's least time, 2 m n_local d operations at the stored
precision's peak or the bytes (the shard read once per emit call, the
queries, and the segment minima at 512-row segments, the longest the
engine uses) over HBM bandwidth, over the emit's device time a batch, in
percent.  The engine launches the emit once a query block, so the calls a
batch come from the program's counters (``twophase_emit`` launches over
``twophase_calls``, the engine's calls), whatever the block size."""

from benchlib import roofline
from benchlib.layers import group_time


def read(ctx):
    got = group_time(ctx, "emit")
    engine_calls = ctx.trace.launches.get("twophase_calls") if ctx.trace else None
    if got is None or not engine_calls:
        return None
    secs, launched = got
    storage = ctx.spec.get("storage_dtype", "float32")
    ops, nbytes = roofline.emit_call(ctx.n_local, ctx.d, ctx.batch, 512, storage)
    corpus = ctx.n_local * ctx.d * roofline.ELEM_BYTES[storage]
    nbytes += (launched / engine_calls - 1) * corpus
    return roofline.share_pct(roofline.bound_s(ops, nbytes, storage), secs / engine_calls)
