"""Seconds per build outside the graph: the "hash", "tables" and "pack"
stages of build(stage_times=) and Server.build, fenced, mean over the
window's builds."""

from benchlib.layers import stage_mean


def read(ctx):
    return stage_mean(ctx, ("hash", "tables", "pack"))
