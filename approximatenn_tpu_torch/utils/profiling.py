"""Completion fence, per-stage timing and profiler traces (port of
``approximatenn_tpu/utils/profiling.py``).

PyTorch returns before the card finishes, so a host clock read without a
fence measures the enqueue.  :func:`fence` is ``torch.cuda.synchronize()``
on CUDA and does nothing on the CPU, where every op has finished when it
returns.  :class:`StageTimes` accumulates fenced wall-clock per named
stage and, when asked, the card's peak memory in each; :func:`trace`
records a ``torch.profiler`` trace (Chrome format) around a region and
:func:`annotate` names a range inside it, as the ``add_points:`` ranges of
``index.py`` do.
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


def _card_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def fence(device=None) -> None:
    """Wait for all queued work on ``device`` (a CUDA device, a tensor, or
    None for the current CUDA device); no-op on the CPU."""
    if isinstance(device, torch.Tensor):
        device = device.device
    if device is None:
        if _card_in_use():
            torch.cuda.synchronize()
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class StageTimes:
    """Accumulated wall-clock per named stage.  With ``memory=True`` and a
    card in use, each stage also resets the card's peak-memory counter
    (``torch.cuda.reset_peak_memory_stats``) when it starts and keeps
    ``torch.cuda.max_memory_allocated()`` when it ends: ``peaks[name]``,
    bytes, the largest over the stage's calls.  The counter is the
    process's: a stage resets it for every other reader too."""

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    memory: bool = False
    peaks: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str, out=None):
        """Time a stage; append the stage's output to the yielded list to
        fence the card before the clock stops (with ``memory``, the card
        is always fenced)."""
        sink: list = []
        track = self.memory and _card_in_use()
        if track:
            fence()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            yield sink
        finally:
            if sink or track:
                fence()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            if track:
                self.peaks[name] = max(self.peaks[name], torch.cuda.max_memory_allocated())

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            peak = (f"  peak {self.peaks[name] / 2**30:8.2f} GiB" if name in self.peaks
                    else "")
            lines.append(f"{name:28s} {t*1e3:10.2f} ms total  {t/c*1e3:9.2f} ms/call  "
                         f"x{c}{peak}")
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
    if _card_in_use():
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
