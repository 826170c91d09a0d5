"""The rank kernel's share of its roofline where it makes the exact graph: every
row's k nearest other rows (2 n^2 d operations at float32's peak, or per
launch the corpus, its chunk of query rows, their excluded ids and winners
once over HBM bandwidth) over the kernel's device time in the traced
build, in percent."""

from benchlib import roofline
from benchlib.layers import group_time


def read(ctx):
    got = group_time(ctx, "rank")
    if got is None:
        return None
    secs, launches = got
    n, d, k = ctx.n, ctx.d, ctx.k
    ops, _ = roofline.rank_call(n, d, n, k, "float32", exclude=True)
    nbytes = launches * n * d * roofline.ELEM_BYTES["float32"] + n * d * 4 + n * k * 8 + n * 4
    return roofline.share_pct(roofline.bound_s(ops, nbytes, "float32"), secs)
