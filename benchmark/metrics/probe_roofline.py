"""The probe-window kernel's share of its roofline: the distinct stored rows
the batch's windows cover (worked out by the reference from the inputs)
plus queries, starts and winners once over HBM bandwidth, or one window a
(query, table) at the row type's peak, over its device time per call
(probe_kernel), in percent."""

from benchlib import roofline
from benchlib.layers import group_time


def read(ctx):
    got = group_time(ctx, "probe")
    if got is None or not ctx.probe_slots:
        return None
    secs, calls = got
    spec = ctx.spec
    storage = spec["packed_dtype"]
    ops, nbytes = roofline.probe_call(ctx.probe_slots, ctx.d, ctx.batch, spec["tries"],
                                      spec["n_probes"], spec["window"], ctx.k, storage)
    return roofline.share_pct(roofline.bound_s(ops, nbytes, storage), secs / calls)
