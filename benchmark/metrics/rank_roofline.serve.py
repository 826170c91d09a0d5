"""The rank kernel's share of its roofline at the serving shape: the least
time of one call (2 m n d operations at the stored precision's peak, or
the corpus, queries and winners once over HBM bandwidth) over the
kernel's device time per call in the trace (tiled_kernel with RankSelect,
plus the split merge it launches), in percent."""

from benchlib import roofline
from benchlib.layers import group_time


def read(ctx):
    got = group_time(ctx, "rank")
    if got is None:
        return None
    secs, calls = got
    storage = ctx.spec.get("storage_dtype", "float32")
    ops, nbytes = roofline.rank_call(ctx.n, ctx.d, ctx.batch, ctx.k, storage)
    return roofline.share_pct(roofline.bound_s(ops, nbytes, storage), secs / calls)
