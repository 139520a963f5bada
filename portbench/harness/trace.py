"""The traced run: ``torch.profiler`` over a bounded number of whole solves,
and what the per-layer readers read from it.

Each traced solve runs inside a ``portbench.solve`` range; device time is
read only inside those ranges. Kernel calls of the program are counted
without touching it: ``sys.monitoring`` reports each start of the
functions a reader lists in its ``WATCH`` (module, function, extractor),
and the extractor keeps what the reader needs from the call's arguments
(shapes and the long-lived layout tensors, never the per-call operands).
No Chrome trace is written: the events are read in memory.
"""

from __future__ import annotations

import bisect
import importlib
import sys
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

SOLVE_RANGE = "portbench.solve"
_TOOL_ID = 4  # sys.monitoring's free tool ids are 0-5


@dataclass
class Trace:
    """What a traced run gives the readers. Times in nanoseconds of the
    profiler's clock, durations in seconds where named ``*_s``."""

    windows: list  # (start, end) of each traced solve
    kernels: list  # (name, start, end) of device kernels inside them
    device_ops: list  # (name, start, end): kernels, copies and fills
    host_ops: list  # (name, start, end) host-side ranges and ops
    solves: list  # per traced solve: {"iterations", "cg_iterations"}
    cg_max_iters: int
    calls: dict = field(default_factory=dict)  # (module, fn) -> records

    @property
    def window_s(self) -> float:
        return sum(e - s for s, e in self.windows) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(union_ns([(s, e) for _, s, e in self.device_ops], lo, hi)
                   for lo, hi in self.windows) * 1e-9

    @property
    def iterations(self) -> int:
        return sum(s["iterations"] for s in self.solves)

    def kernel_seconds(self, part: str) -> tuple[int, float]:
        """(count, summed device seconds) of the kernels whose name holds
        ``part``."""
        hits = [e - s for name, s, e in self.kernels if part in name]
        return len(hits), sum(hits) * 1e-9


def union_ns(intervals, lo, hi) -> int:
    """Length of the union of ``intervals`` (start, end) clipped to
    [lo, hi]."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo, hi) -> list:
    """The (start, end) spans of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]


def _innermost(host_ops, starts, t):
    """Name of the shortest host op that holds time ``t``."""
    i = bisect.bisect_right(starts, t)
    best = None
    for name, s, e in reversed(host_ops[max(0, i - 64):i]):
        if s <= t < e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else "(no host op)"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device ops that took most time, and the idle gaps inside the
    traced solves summed by the host op that held each gap's middle."""
    by_op = defaultdict(int)
    for name, s, e in trace.device_ops:
        by_op[name] += e - s
    host = sorted(trace.host_ops, key=lambda o: o[1])
    starts = [s for _, s, _ in host]
    by_host = defaultdict(int)
    for lo, hi in trace.windows:
        for s, e in idle_gaps([(s, e) for _, s, e in trace.device_ops],
                              lo, hi):
            by_host[_innermost(host, starts, (s + e) // 2)] += e - s

    def rank(d):
        return [[k, v * 1e-9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}


class Watch:
    """Counts calls of the program's functions while active: for each
    (module, function, extractor), ``records[(module, function)]`` gets
    ``extractor(arguments)`` at every call."""

    def __init__(self, targets):
        self.targets = {}
        for module, fn, extract in targets:
            code = getattr(importlib.import_module(module), fn).__code__
            self.targets[code] = ((module, fn), extract)
        self.records = defaultdict(list)

    def _on_start(self, code, offset):
        key, extract = self.targets[code]
        self.records[key].append(extract(sys._getframe(1).f_locals))

    @contextmanager
    def active(self):
        mon = sys.monitoring
        if not self.targets:
            yield self
            return
        mon.use_tool_id(_TOOL_ID, "portbench")
        try:
            mon.register_callback(_TOOL_ID, mon.events.PY_START,
                                  self._on_start)
            for code in self.targets:
                mon.set_local_events(_TOOL_ID, code, mon.events.PY_START)
            yield self
        finally:
            for code in self.targets:
                mon.set_local_events(_TOOL_ID, code, 0)
            mon.register_callback(_TOOL_ID, mon.events.PY_START, None)
            mon.free_tool_id(_TOOL_ID)


def _is_copy_or_fill(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def collect(prof, solves, cg_max_iters, calls) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    windows, device_ops, host_ops = [], [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            # a range's copy on the device timeline is no device work
            annotation = getattr(ev, "is_user_annotation", lambda: False)()
            if not (annotation or ev.name() == SOLVE_RANGE):
                device_ops.append((ev.name(), s, e))
        elif ev.name() == SOLVE_RANGE:
            windows.append((s, e))
        else:
            host_ops.append((ev.name(), s, e))
    windows.sort()

    def inside(s):
        return any(lo <= s < hi for lo, hi in windows)

    device_ops = [op for op in device_ops if inside(op[1])]
    kernels = [op for op in device_ops if not _is_copy_or_fill(op[0])]
    return Trace(windows=windows, kernels=kernels, device_ops=device_ops,
                 host_ops=host_ops, solves=solves, cg_max_iters=cg_max_iters,
                 calls=dict(calls))
