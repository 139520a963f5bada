"""The program's own spans in a traced run: per-layer host time from solves
run under ``libwave_tpu_torch.utils.trace.recording()`` with no profiler,
and per-layer device time from solves run under the profiler and a
recording together.

Each device operation of a profiled solve is put down to the innermost
program span that was open when its launch call started on the host: the
operation and the runtime call that launched it carry one correlation id.
An operation launched in no program span is put down to the harness's own
range, ``portbench.solve``. Span stamps are on the profiler's clock (the
recording shifts them there), so launches and spans compare directly.

Span records are ``libwave_tpu_torch.utils.trace.SpanRecord``: ``name``,
``start_ns``, ``end_ns``, ``parent`` (an index into the same list) and
``solve``. Times are nanoseconds unless a name ends in ``_ms``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass

from portbench.harness import trace as tr

ITERATION = "ba.iteration"
LM_ITERATIONS = "ba.lm_iterations"
OUTSIDE = tr.SOLVE_RANGE  # device ops launched in no program span


@dataclass
class DeviceOp:
    """A device operation of a profiled solve, with the host time at
    which the call that launched it started (None if no launch matched)."""

    name: str
    start: int
    end: int
    launch: int | None
    kernel: bool


@dataclass
class SpanRun:
    """What the span readers read."""

    untraced: list  # span records of the unprofiled solves
    untraced_counters: dict
    traced: list  # span records of the profiled solves
    traced_counters: dict
    windows: list  # the profiled solves' ranges
    device_ops: list  # DeviceOp, inside the windows


def device_ops(events, windows) -> list:
    """The device operations (kernels, copies, fills) of the profiler's
    kineto ``events`` that start inside ``windows``, each with the start of
    the runtime call that launched it, matched by correlation id."""
    from torch.autograd import DeviceType

    launch, ops = {}, []
    for ev in events:
        if ev.device_type() == DeviceType.CUDA:
            annotation = getattr(ev, "is_user_annotation", lambda: False)()
            if not (annotation or ev.name() == tr.SOLVE_RANGE):
                s = ev.start_ns()
                ops.append((ev.name(), s, s + ev.duration_ns(),
                            ev.correlation_id()))
        elif ev.name().startswith("cu") and ev.correlation_id():
            # a runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
            # cudaMemcpyAsync, ...) on the host
            launch[ev.correlation_id()] = ev.start_ns()
    return [DeviceOp(name, s, e, launch.get(cid),
                     not name.startswith(("Memcpy", "Memset")))
            for name, s, e, cid in sorted(ops, key=lambda o: o[1])
            if any(lo <= s < hi for lo, hi in windows)]


class Spans:
    """Lookups over one list of span records (nested, in start order)."""

    def __init__(self, records):
        self.records = records
        self.starts = [r.start_ns for r in records]

    def innermost(self, t):
        """Index of the innermost span open at time ``t``, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0:
            r = self.records[i]
            if r.end_ns is not None and r.start_ns <= t < r.end_ns:
                return i
            i = r.parent
        return None

    def name(self, i):
        return OUTSIDE if i is None else self.records[i].name

    def within(self, i, name):
        """Whether span ``i`` is ``name`` or nested inside one."""
        while i is not None:
            if self.records[i].name == name:
                return True
            i = self.records[i].parent
        return False


def self_ns(records) -> list:
    """Each span's duration minus its children's."""
    out = [r.end_ns - r.start_ns for r in records]
    for r in records:
        if r.parent is not None:
            out[r.parent] -= r.end_ns - r.start_ns
    return out


def owners(run: SpanRun) -> list:
    """The innermost traced span (index, or None) of each device op's
    launch; an op with no matched launch gets -1."""
    spans = Spans(run.traced)
    return [-1 if op.launch is None else spans.innermost(op.launch)
            for op in run.device_ops]


def _iterations(counters) -> int:
    return int(counters.get(LM_ITERATIONS, 0))


def host_ms_per_iter(run: SpanRun, name: str = ITERATION):
    """Summed durations of the unprofiled solves' ``name`` spans, per LM
    iteration; None without such spans."""
    n = _iterations(run.untraced_counters)
    total = [r.end_ns - r.start_ns for r in run.untraced if r.name == name]
    if not n or not total:
        return None
    return 1e-6 * sum(total) / n


def device_ms_per_iter(run: SpanRun, name: str):
    """The union of the device ops launched inside ``name`` spans
    (nested spans included) in the profiled solves, per LM iteration; None
    without such spans or ops."""
    n = _iterations(run.traced_counters)
    if not n or not run.device_ops:
        return None
    spans = Spans(run.traced)
    picked = [(op.start, op.end) for op, i in zip(run.device_ops, owners(run))
              if i is not None and i >= 0 and spans.within(i, name)]
    if not picked:
        return None
    return 1e-6 * sum(tr.union_ns(picked, lo, hi)
                      for lo, hi in run.windows) / n


def table(run: SpanRun) -> dict:
    """Per span name (``portbench.solve`` for what no span holds): count in
    the profiled solves; host self ms per iteration in the unprofiled
    ones; device ms (the union of the ops it launched itself), kernels and
    idle ms (device gaps whose middle falls in its self time) per iteration
    in the profiled ones. ``unmatched`` counts device ops with no launch."""
    n_u = _iterations(run.untraced_counters) or 1
    n_t = _iterations(run.traced_counters) or 1
    rows = defaultdict(lambda: {"count": 0, "host_self_ms": 0.0,
                                "device_ms": 0.0, "kernels": 0.0,
                                "idle_ms": 0.0})
    for r in run.traced:
        rows[r.name]["count"] += 1
    for r, ns in zip(run.untraced, self_ns(run.untraced)):
        rows[r.name]["host_self_ms"] += 1e-6 * ns / n_u
    spans = Spans(run.traced)
    by_name = defaultdict(list)
    unmatched = 0
    for op, i in zip(run.device_ops, owners(run)):
        if i == -1:
            unmatched += 1
            continue
        by_name[spans.name(i)].append((op.start, op.end))
        rows[spans.name(i)]["kernels"] += op.kernel / n_t
    for name, iv in by_name.items():
        rows[name]["device_ms"] = 1e-6 * sum(
            tr.union_ns(iv, lo, hi) for lo, hi in run.windows) / n_t
    busy = [(op.start, op.end) for op in run.device_ops]
    for lo, hi in run.windows:
        for s, e in tr.idle_gaps(busy, lo, hi):
            name = spans.name(spans.innermost((s + e) // 2))
            rows[name]["idle_ms"] += 1e-6 * (e - s) / n_t
    return {"rows": dict(rows), "unmatched": unmatched}


def lines(tab: dict) -> list:
    """One line per span name, for standard error."""
    out = []
    for name, r in sorted(tab["rows"].items(),
                          key=lambda kv: -kv[1]["device_ms"]):
        out.append(
            f"portbench: span {name}: count {r['count']}; host self "
            f"{r['host_self_ms']:.3f} ms/iter untraced; device "
            f"{r['device_ms']:.3f} ms/iter; {r['kernels']:.1f} kernels/iter; "
            f"idle {r['idle_ms']:.3f} ms/iter")
    out.append(f"portbench: device ops with no matched launch: "
               f"{tab['unmatched']}")
    return out
