"""Seconds per build of the exact kNN graph: the "graph" stage of
build(stage_times=), fenced, mean over the window's builds."""

from benchlib.layers import stage_mean


def read(ctx):
    return stage_mean(ctx, ("graph",))
