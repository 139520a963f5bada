"""Tracing and profiling: spans and counters inside the program, and the
operator's profiler export.

- :func:`span` marks a layer of the program (``with span("ba.linearize"):
  ...``). Outside a recording and a profiler session it does nothing.
  Inside :func:`recording` it appends a :class:`SpanRecord` to the
  recording's ``spans``; while a ``torch.profiler`` session is active it
  also enters a ``torch.profiler.record_function`` range of the same name,
  so the span shows in the profiler's events and Chrome export.
- :func:`count` adds to a named host counter of the active recording. A
  recording also reads the launch counts that the kernel wrappers
  registered with :func:`counts_launches` keep, and holds their deltas as
  ``launches.<wrapper>``.
- :func:`profile_trace` records a ``torch.profiler`` trace (CPU and, when
  a card is present, CUDA activity) and writes it under ``log_dir`` as a
  Chrome trace (``trace.json``) readable in Perfetto or TensorBoard.

A span or a counter reads no device value, synchronizes nothing and
launches no kernel. Span stamps are nanoseconds on the profiler's clock:
``time.perf_counter_ns`` shifted by an offset taken when the recording
starts (``torch.profiler``'s events are stamped on the epoch clock,
``time.time_ns``), so records and profiler events can be matched in time.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import Counter
from dataclasses import dataclass, field

import torch
# its _is_profiler_enabled is true while a torch.profiler session records
import torch.autograd.profiler as _autograd_profiler

# Spans named so are solves: each record carries the number of the
# outermost solve span around it (or itself), one per solve.
SOLVE_SPAN = "ba.solve"

_recording = None  # the active Recording, or None
# the kernel wrappers whose ``launches`` a recording reads, by name
_wrappers = {}


@dataclass(slots=True)
class SpanRecord:
    """One span: its name, its stamps (ns, profiler clock; ``end_ns`` is
    None while it is open), the index of its parent in the recording's
    ``spans`` (None at the top), the number of its solve (None outside a
    solve) and the keyword attributes it was opened with."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    solve: int | None
    attrs: dict


@dataclass
class Recording:
    """What :func:`recording` collects: span records in the order they
    opened, and host counters."""

    offset_ns: int  # profiler clock minus time.perf_counter_ns
    spans: list = field(default_factory=list)
    counters: Counter = field(default_factory=Counter)
    solves: int = 0
    _open: list = field(default_factory=list)


def _profiler_clock_offset() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the closest of a
    few back-to-back pairs of reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def counts_launches(fn):
    """Register ``fn``, a kernel wrapper that adds each launch to its
    ``launches`` attribute: set it to 0 and return ``fn`` itself, not a
    wrapper of it, so that what watches ``fn.__code__`` still sees its
    calls."""
    fn.launches = 0
    _wrappers[fn.__name__] = fn
    return fn


def counted_wrappers() -> dict:
    """The wrappers registered with :func:`counts_launches`, by name."""
    return dict(_wrappers)


def _launch_counts() -> dict:
    return {w: fn.launches for w, fn in _wrappers.items()}


@contextlib.contextmanager
def recording():
    """Record the spans and counters of the block: ``with recording() as
    rec: ...``, then ``rec.spans`` and ``rec.counters``. Recordings do not
    nest."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording is already active")
    rec = Recording(offset_ns=_profiler_clock_offset())
    before = _launch_counts()
    _recording = rec
    try:
        yield rec
    finally:
        _recording = None
        # a wrapper registered during the recording counts from 0
        for w, n in _launch_counts().items():
            rec.counters[f"launches.{w}"] += n - before.get(w, 0)


class _Span:
    __slots__ = ("name", "attrs", "index", "range")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs
        self.index = self.range = None

    def __enter__(self):
        rec = _recording
        if rec is not None:
            parent = rec._open[-1] if rec._open else None
            solve = None if parent is None else rec.spans[parent].solve
            if solve is None and self.name == SOLVE_SPAN:
                solve, rec.solves = rec.solves, rec.solves + 1
            self.index = len(rec.spans)
            rec.spans.append(SpanRecord(
                self.name, time.perf_counter_ns() + rec.offset_ns, None,
                parent, solve, self.attrs))
            rec._open.append(self.index)
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        rec = _recording
        if rec is not None and self.index is not None:
            rec.spans[self.index].end_ns = (time.perf_counter_ns()
                                            + rec.offset_ns)
            rec._open.pop()
        return False


_NO_SPAN = contextlib.nullcontext()


def span(name: str, **attrs):
    """A span of the program named ``name`` with host-side ``attrs``
    (see the module's docstring)."""
    if _recording is None and not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, attrs)


def count(name: str, n: int = 1):
    """Add ``n`` (a host int) to counter ``name`` of the active
    recording; nothing outside one."""
    if _recording is not None:
        _recording.counters[name] += n


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Record a profiler trace of the block and write it to
    ``log_dir/trace.json``. Yields the ``torch.profiler.profile`` object
    (``key_averages()`` for sums by kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
