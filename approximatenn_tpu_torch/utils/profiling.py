"""Completion fence, per-stage timing and profiler traces (port of
``approximatenn_tpu/utils/profiling.py``).

PyTorch returns before the card finishes, so a host clock read without a
fence measures the enqueue.  :func:`fence` is ``torch.cuda.synchronize()``
on CUDA and does nothing on the CPU, where every op has finished when it
returns.  :class:`StageTimes` accumulates fenced wall-clock per named
stage and, when asked, the card's peak memory in each; :func:`trace`
records a ``torch.profiler`` trace (Chrome format) around a region.

:class:`span` marks a region of the program at a layer boundary
(``server.search``, ``search.merge``, ``build.graph``, the ``add_points:``
ranges, ...).  Every span reads the host clock at entry and exit and
leaves a record in a bounded in-memory ring (:func:`spans`) and a per-name
total (:func:`span_summary`); only while a profiler is recording does it
also enter a ``torch.profiler.record_function`` range, so that the region
shows on the device trace's timeline.  A span fences nothing and launches no
card operation.  :func:`annotate` is :class:`span`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import NamedTuple

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


class SpanRecord(NamedTuple):
    """One finished span.  ``self_ns`` is the duration less its child
    spans' durations; ``parent`` the enclosing span's name (None for a
    root); ``request`` the id every span under one root shares; ``rows``
    the rows (queries, points) the region worked on, where given."""

    name: str
    start_ns: int
    end_ns: int
    self_ns: int
    parent: str | None
    request: int
    rows: int | None


RING = 65536
# finished spans as plain tuples (a SpanRecord's fields), made into
# records when read
_ring: deque = deque(maxlen=RING)
_requests = itertools.count(1)
# each thread's open spans
_local = threading.local()
# name -> [count, total ns, self ns], over every thread
_totals: dict = {}
_totals_lock = threading.Lock()
_profiler_enabled = torch._C._autograd._profiler_enabled


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        stack = _local.stack = []
        return stack


class span:
    """``with span(name, rows=None): ...``: time a region on the host clock
    (``time.perf_counter_ns``) and record it on exit (:func:`spans`,
    :func:`span_summary`).  Spans nest per thread: a span opened inside
    another is its child and shares its ``request``; a root span takes the
    next id of a process-wide counter.  While a profiler is recording
    (checked at entry) the region is also a ``record_function`` range;
    otherwise no profiler object is made.  ``rows`` may be set on the
    yielded span before it exits."""

    __slots__ = ("name", "rows", "request", "_parent", "_child_ns", "_range", "_t0",
                 "_stack")

    def __init__(self, name: str, rows: int | None = None):
        self.name = name
        self.rows = rows

    def __enter__(self) -> "span":
        stack = self._stack = _stack()
        parent = self._parent = stack[-1] if stack else None
        self.request = next(_requests) if parent is None else parent.request
        self._child_ns = 0
        self._range = None
        if _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        self._stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        dur = t1 - self._t0
        own = dur - self._child_ns
        parent = self._parent
        if parent is not None:
            parent._child_ns += dur
        _ring.append((self.name, self._t0, t1, own, parent and parent.name, self.request,
                      self.rows))
        with _totals_lock:
            tot = _totals.get(self.name)
            if tot is None:
                _totals[self.name] = [1, dur, own]
            else:
                tot[0] += 1
                tot[1] += dur
                tot[2] += own
        return False


annotate = span


def spans() -> list:
    """The ring's records (:class:`SpanRecord`), oldest first: the last
    ``RING`` spans that finished in this process."""
    return [SpanRecord._make(r) for r in list(_ring)]


def span_summary() -> dict:
    """``{name: (count, total seconds, self seconds)}`` over every span
    that finished since the last :func:`reset_spans`, in every thread."""
    with _totals_lock:
        return {name: (c, t * 1e-9, own * 1e-9) for name, (c, t, own) in _totals.items()}


def reset_spans() -> None:
    """Clear the ring and the per-name totals."""
    with _totals_lock:
        _ring.clear()
        _totals.clear()


@contextlib.contextmanager
def build_stage(name: str, stage_times: StageTimes | None = None, rows: int | None = None):
    """A build stage: the span ``build.<name>`` around
    ``stage_times.stage(name)`` when a :class:`StageTimes` is given (which
    fences and times it), around nothing else otherwise.  Yields the
    stage's sink (see :meth:`StageTimes.stage`)."""
    with span(f"build.{name}", rows=rows):
        if stage_times is None:
            yield []
        else:
            with stage_times.stage(name) as sink:
                yield sink
