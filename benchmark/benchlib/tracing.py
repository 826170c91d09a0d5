"""The device trace of a slice of the window, reduced in memory.

``Slice`` runs ``torch.profiler`` (host and device activity) around a
steady part of the window inside a ``bench.slice`` range, writes the
Chrome trace to a temporary directory, reads it back and deletes it.  From
the trace: the seconds some operation ran on the device inside the slice
(the union of kernels, copies and sets), the slice's length, each kernel
group's time and instance count, the device operations that took most
time, and the idle gaps named by what the host was doing.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from types import SimpleNamespace

import torch

from . import roofline

_GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("user_annotation", "cpu_op")
SLICE = "bench.slice"
TOP = 10
_SHORT_US = 10.0


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."


def reduce_trace(events: list, calls: int, launches: dict) -> SimpleNamespace:
    """Reduce Chrome-trace events (times in microseconds) of one slice."""
    marks = [e for e in events if e.get("ph") == "X" and e.get("name") == SLICE
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace holds no bench.slice range")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    gpu = [e for e in events if e.get("ph") == "X" and e.get("cat") in _GPU_CATS]
    spans = [(max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"])))
             for e in gpu]
    busy = _union([(a, b) for a, b in spans if b > a])
    busy_us = sum(b - a for a, b in busy)

    groups: dict = defaultdict(lambda: [0.0, 0])
    ops: dict = defaultdict(float)
    last = None
    for e in sorted((e for e in gpu if e["cat"] == "kernel"), key=lambda e: float(e["ts"])):
        if not w0 <= float(e["ts"]) < w1:
            continue
        dur = float(e["dur"]) * 1e-6
        ops[_short(e["name"])] += dur
        g = roofline.kernel_group(e["name"])
        if g is None and "split_merge_kernel" in e["name"]:
            g, count = last, 0
        else:
            count = 1
        if g is not None:
            groups[g][0] += dur
            groups[g][1] += count
        last = g

    gaps = _name_gaps(events, busy, w0, w1)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return SimpleNamespace(busy_s=busy_us * 1e-6, window_s=(w1 - w0) * 1e-6,
                           groups={g: tuple(v) for g, v in groups.items()},
                           launches=dict(launches), calls=calls,
                           device_ops=top(ops), idle_gaps=top(gaps))


def _innermost(evs, starts, mid, reach=4000):
    """The event of ``evs`` (sorted by start) with the latest start that
    covers ``mid``."""
    i = bisect.bisect_right(starts, mid) - 1
    for j in range(i, max(-1, i - reach), -1):
        e = evs[j]
        if float(e["ts"]) + float(e["dur"]) >= mid:
            return e["name"]
    return None


def _name_gaps(events, busy, w0, w1) -> dict:
    """Seconds of device idle inside [w0, w1], summed by what the host was
    doing at each gap's middle: the innermost benchmark range and the
    innermost host operation.  Gaps under ``_SHORT_US`` are summed as one
    entry (the launch gaps between back-to-back kernels)."""
    per = {}
    for cat in _HOST_CATS:
        evs = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == cat
                      and e.get("name") != SLICE), key=lambda e: float(e["ts"]))
        per[cat] = (evs, [float(e["ts"]) for e in evs])
    gaps: dict = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < _SHORT_US:
            gaps[f"gaps under {_SHORT_US:g} us"] += (b - a) * 1e-6
            continue
        mid = 0.5 * (a + b)
        parts = [n for n in (_innermost(*per[c], mid) for c in _HOST_CATS) if n]
        gaps[" > ".join(parts) or "host idle"] += (b - a) * 1e-6
    return gaps


class Slice:
    """Profile the enclosed calls: ``with Slice(counters) as s: ...; s.result``.
    ``counters``: a function returning the program's launch counts (read
    before and after, the deltas kept); ``s.calls`` is set by the caller."""

    def __init__(self, counters=None):
        self.counters = counters or (lambda: {})
        self.calls = 0
        self.result = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            acts.append(ProfilerActivity.CUDA)
        self._before = dict(self.counters())
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark = record_function(SLICE)
        self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._mark.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        after = self.counters()
        delta = {k: after[k] - self._before.get(k, 0) for k in after}
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        self.result = reduce_trace(events, self.calls, delta)
        return False
