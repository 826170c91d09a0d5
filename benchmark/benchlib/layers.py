"""What the per-layer readers share: the idle share of a traced slice, the
host span of ``Server.search``, and a kernel group's time per call checked
against the program's launch counters.  A reader that finds nothing to read
returns None and the metric is left out of the line."""

from __future__ import annotations

import sys

from . import roofline


def idle_pct(ctx) -> float | None:
    """Share of the traced slice in which no operation ran on the device."""
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def host_ms(ctx) -> float | None:
    """Mean host milliseconds from the call into ``Server.search`` until it
    returns, over the window's batches outside the traced slice."""
    if not ctx.host_s:
        return None
    return 1e3 * sum(ctx.host_s) / len(ctx.host_s)


def latency_ms(ctx, q: float) -> float | None:
    """The q-quantile, in milliseconds, of the batches' latency from the
    queries in host memory to the answers in host memory, over the window's
    untraced batches (linear interpolation between order statistics)."""
    if not ctx.latency_s:
        return None
    v = sorted(ctx.latency_s)
    x = q * (len(v) - 1)
    lo = int(x)
    hi = min(lo + 1, len(v) - 1)
    return 1e3 * (v[lo] + (x - lo) * (v[hi] - v[lo]))


def group_time(ctx, group: str):
    """(seconds, instances) of a kernel group in the traced slice, or None
    where the group is absent or its instances disagree with the program's
    launch counts over the slice."""
    t = ctx.trace
    if t is None or group not in t.groups:
        return None
    secs, count = t.groups[group]
    launched = sum(t.launches.get(key, 0) for key in roofline.LAUNCH_KEYS[group])
    if count == 0 or count != launched:
        print(f"kernel group {group}: {count} instances in the trace, {launched} "
              "launches counted; share not reported", file=sys.stderr)
        return None
    return secs, count


def stage_mean(ctx, names) -> float | None:
    """Mean seconds per build of the named ``build(stage_times=)`` stages."""
    if not ctx.stages:
        return None
    return sum(sum(st.get(n, 0.0) for n in names) for st in ctx.stages) / len(ctx.stages)
