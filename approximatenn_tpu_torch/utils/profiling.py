"""Completion fence, per-stage timing and profiler traces (port of
``approximatenn_tpu/utils/profiling.py``).

PyTorch returns before the card finishes, so a host clock read without a
fence measures the enqueue.  :func:`fence` is ``torch.cuda.synchronize()``
on CUDA and does nothing on the CPU, where every op has finished when it
returns.  :class:`StageTimes` accumulates fenced wall-clock per named
stage; :func:`trace` records a ``torch.profiler`` trace (Chrome format)
around a region and :func:`annotate` names a range inside it, as the
``add_points:`` ranges of ``index.py`` do.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.profiler import record_function


def fence(device=None) -> None:
    """Wait for all queued work on ``device`` (a CUDA device, a tensor, or
    None for the current CUDA device); no-op on the CPU."""
    if isinstance(device, torch.Tensor):
        device = device.device
    if device is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class StageTimes:
    """Accumulated wall-clock per named stage."""

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str, out=None):
        """Time a stage; append the stage's output to the yielded list to
        fence the card before the clock stops."""
        sink: list = []
        t0 = time.perf_counter()
        try:
            yield sink
        finally:
            if sink:
                fence()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:28s} {t*1e3:10.2f} ms total  {t/c*1e3:9.2f} ms/call  x{c}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Record a ``torch.profiler`` trace around a region, with CUDA activity
    when a card is in use, and write it as ``trace.json`` (Chrome format)
    under ``logdir`` (default ``ann_torch_trace`` in the temporary
    directory).  Yields ``logdir``; where the profiler cannot start, the
    region runs untraced."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "ann_torch_trace")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(ProfilerActivity.CUDA)
    prof = None
    try:
        prof = profile(activities=acts)
        prof.__enter__()
    except RuntimeError:
        prof = None
    try:
        yield logdir
    finally:
        if prof is not None:
            fence()
            prof.__exit__(None, None, None)
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named range that shows in profiler traces
    (``torch.profiler.record_function``)."""
    return record_function(name)
