"""The two-phase emit kernel's share of its roofline: 2 m n d operations at
the stored precision's peak (a bf16 corpus multiplies bf16-rounded
queries), or the corpus, queries and segment minima once over HBM
bandwidth, over its device time per call (tiled_kernel with EmitSelect),
in percent.  The minima are counted at 512-row segments, the longest the
engine uses, so the bytes are never counted high."""

from benchlib import roofline
from benchlib.layers import group_time


def read(ctx):
    got = group_time(ctx, "emit")
    if got is None:
        return None
    secs, calls = got
    storage = ctx.spec.get("storage_dtype", "float32")
    ops, nbytes = roofline.emit_call(ctx.n, ctx.d, ctx.batch, 512, storage)
    return roofline.share_pct(roofline.bound_s(ops, nbytes, storage), secs / calls)
