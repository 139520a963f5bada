"""Per-layer host and device time of one cell's solves, read from the
program's own spans (``libwave_tpu_torch.utils.trace``):

    python3 portbench/span_table.py --workload <cell> --seed <n> [--pairs 6]

from the root of a checkout, on a card. After the cell's set-up and
warm-up (as ``run.py`` makes them) it runs, in this order, in one process:

1. ``--pairs`` pairs of solves with a recording on and off, alternating
   which runs first: the cost of recording, with no profiler;
2. the mix's ``trace_solves`` solves under a recording, with no profiler:
   host times without the profiler's inflation (a profiler session slows
   every later launch of its process, so these come first);
3. as many solves under ``torch.profiler`` and a recording: each device
   op put down to the span that launched it (``portbench.harness.spans``).

Standard error gets one line per span name; the last line of standard
output is one JSON object: the span metrics, the table, the cost of
recording, how far the profiler's ranges start after the span records of
the same names, and the per-layer metrics of ``BENCHMARK.json`` that
read the profile alone, for comparison with ``run.py --trace 1``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# per-layer metrics of BENCHMARK.json that need no call counts
PROFILE_READERS = ("kernels_per_iter", "device_ms_per_iter", "device_idle",
                   "pcg_live_share")


def _clock_lags(records, events):
    """How far each profiler range starts after the span record of the
    same name (paired in order, name by name), in ns: (median, max)."""
    ranges = defaultdict(list)
    for ev in events:
        ranges[ev.name()].append(ev.start_ns())
    for starts in ranges.values():
        starts.sort()
    seen = defaultdict(int)
    lags = []
    for r in records:
        k = seen[r.name]
        seen[r.name] += 1
        if k < len(ranges.get(r.name, ())):
            lags.append(ranges[r.name][k] - r.start_ns)
    if not lags:
        return None, None
    return statistics.median(lags), max(lags, key=abs)


def measure(cell, seed: int, device, pairs: int) -> dict:
    """The three phases of the module's docstring on ``cell``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from libwave_tpu_torch.utils.trace import recording
    from portbench.harness import port, runner, spec
    from portbench.harness import spans as sp
    from portbench.harness import trace as tr
    from portbench.harness.scene import make_scene

    traffic = cell.traffic
    scene = make_scene(cell.config, traffic, seed, device)
    problem, state0, cfg = port.build(scene, cell.config, traffic, device)
    for _ in range(traffic["warmup_solves"]):
        runner._timed_solve(port.solve, problem, state0, cfg, device)

    def timed(on):
        with recording() if on else contextlib.nullcontext():
            return runner._timed_solve(port.solve, problem, state0, cfg,
                                       device)

    seconds = {True: [], False: []}
    for k in range(pairs):
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            _, _, _, t0, t1 = timed(on)
            seconds[on].append(t1 - t0)

    with recording() as untraced:
        for _ in range(traffic["trace_solves"]):
            runner._timed_solve(port.solve, problem, state0, cfg, device)

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    solves = []
    with profile(activities=activities) as prof, recording() as traced:
        for _ in range(traffic["trace_solves"]):
            with record_function(tr.SOLVE_RANGE):
                _, info, _, _, _ = runner._timed_solve(
                    port.solve, problem, state0, cfg, device)
            solves.append({"iterations": cfg.max_iterations,
                           "cg_iterations": [int(c) for c in
                                             info["cg_iterations"].cpu()]})
    events = list(prof.profiler.kineto_results.events())
    whole = tr.collect(prof, solves, cfg.cg_max_iters, {})
    run = sp.SpanRun(untraced=untraced.spans,
                     untraced_counters=dict(untraced.counters),
                     traced=traced.spans,
                     traced_counters=dict(traced.counters),
                     windows=whole.windows,
                     device_ops=sp.device_ops(events, whole.windows))
    tab = sp.table(run)
    for line in sp.lines(tab):
        print(line, file=sys.stderr)

    breakdown = tr.breakdown(whole, top=1000)
    idle_s = whole.window_s - whole.busy_s
    no_host = dict(breakdown["idle_gaps"]).get("(no host op)", 0.0)
    lag_median, lag_max = _clock_lags(
        traced.spans, [ev for ev in events
                       if ev.device_type().name == "CPU"])
    profile_metrics = {}
    for name in PROFILE_READERS:
        profile_metrics[name] = spec.load_reader(name).read(whole)
    span_device_ms = sum(r["device_ms"] for r in tab["rows"].values())
    off, on = (statistics.median(seconds[k]) for k in (False, True))
    return {
        "metrics": {
            "host_ms_per_iter": sp.host_ms_per_iter(run),
            "linearize_host_ms_per_iter": sp.host_ms_per_iter(
                run, "ba.linearize"),
            "linearize_device_ms_per_iter": sp.device_ms_per_iter(
                run, "ba.linearize"),
            "pcg_device_ms_per_iter": sp.device_ms_per_iter(run, "schur.pcg"),
        },
        "spans": tab["rows"],
        "unmatched_device_ops": tab["unmatched"],
        "device_ops": len(run.device_ops),
        "span_device_ms_sum": span_device_ms,
        "profile_metrics": profile_metrics,
        "idle_s": idle_s,
        "no_host_op_idle_s": no_host,
        "idle_gaps": breakdown["idle_gaps"][:12],
        "counters": {"untraced": dict(untraced.counters),
                     "traced": dict(traced.counters)},
        "recording_cost": {"solve_s_off": seconds[False],
                           "solve_s_on": seconds[True],
                           "median_off": off, "median_on": on,
                           "on_over_off": on / off},
        "range_lag_ns": {"median": lag_median, "max": lag_max},
        "torch": torch.__version__,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this file")
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print(f"portbench: {args.workload} needs a CUDA card; found none",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    out = measure(cell, args.seed, device, args.pairs)
    out["device"] = torch.cuda.get_device_name(device)
    out["seconds"] = time.perf_counter() - T_START
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
