"""One run of one cell: set-up, the measured window (or the traced solves),
then the check against the plain reference.

The window is a closed loop of one client: ``solve_ba`` again and again on
the seed's problem from the same start state, each solve ended by a host
read of its final cost and a synchronize. It ends at the first solve end
after ``seconds``; the rate is all LM iterations of the window's solves over
the time from the first solve's start to the last one's end. The last
solve's answer is what the check judges.
"""

from __future__ import annotations

import math
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

from portbench.harness import check, port, spec
from portbench.harness import trace as tr
from portbench.harness.scene import make_scene

GIB = 2**30


@dataclass
class Outcome:
    """What a run prints: its result line and its check lines."""

    result: dict
    check_lines: list = field(default_factory=list)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _power_limit():
    """The card's power limit (W) as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _peak_reset(device):
    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return peak


def _peak(device):
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" \
        else 0


def _timed_solve(solve, problem, state, cfg, device):
    t0 = time.perf_counter()
    out_state, info = solve(problem, state, cfg)
    final = float(info["final_cost"])
    _sync(device)
    return out_state, info, final, t0, time.perf_counter()


def _failed(info, final):
    return not math.isfinite(final) or not bool(info["accepted"].any())


def _metric(value, unit):
    return {"value": value, "unit": unit}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             solve=port.solve) -> Outcome:
    """Run ``cell`` once. ``t_start`` is the process's start on
    ``time.perf_counter``'s clock; ``solve`` is the timed call (the port's
    ``solve_ba``; a test may put a broken one in its place)."""
    traffic = cell.traffic
    marks = [("start", time.perf_counter())]
    scene = make_scene(cell.config, traffic, seed, device)
    _sync(device)
    marks.append(("scene", time.perf_counter()))
    problem, state0, cfg = port.build(scene, cell.config, traffic, device)
    settings = port.settings(cell.config, traffic)
    _sync(device)
    marks.append(("port set-up", time.perf_counter()))
    for _ in range(traffic["warmup_solves"]):
        _timed_solve(solve, problem, state0, cfg, device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    print("portbench: set-up " + ", ".join(
        f"{name} {t - marks[i][1]:.3f} s" for i, (name, t) in
        enumerate(marks[1:])) + f"; imports {marks[0][1] - t_start:.3f} s; "
        f"largest camera {scene.max_camera_observations} observations, "
        f"pose-ELL padding {scene.ell_padding_share:.4f}", file=sys.stderr)

    whole_peak = _peak_reset(device)
    metrics, extra_device, breakdown = {}, {}, None
    if not trace:
        runs = []
        while True:
            state, info, final, t0, t1 = _timed_solve(
                solve, problem, state0, cfg, device)
            runs.append((t0, t1, final, _failed(info, final)))
            if t1 - runs[0][0] >= seconds:
                break
        window_peak = _peak(device)
        times = sorted(t1 - t0 for t0, t1, _, _ in runs)
        print(f"portbench: solve seconds min {times[0]:.4f} median "
              f"{times[len(times) // 2]:.4f} max {times[-1]:.4f}",
              file=sys.stderr)
        elapsed = runs[-1][1] - runs[0][0]
        iters = len(runs) * cfg.max_iterations
        e2e = {
            "lm_iter_per_s": _metric(iters / elapsed, "iter/s"),
            "peak_mem_gib": _metric(window_peak / GIB, "GiB"),
            "setup_s": _metric(setup_s, "s"),
        }
        metrics = {m["name"]: e2e[m["name"]] for m in cell.end_to_end}
        attempted, failed = len(runs), sum(r[3] for r in runs)
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        readers = {m["name"]: (spec.load_reader(m["name"]), m["unit"])
                   for m in cell.per_layer}
        watch = tr.Watch([t for r, _ in readers.values()
                          for t in getattr(r, "WATCH", ())])
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        solves, finals = [], []
        with profile(activities=activities) as prof, watch.active():
            for _ in range(traffic["trace_solves"]):
                with record_function(tr.SOLVE_RANGE):
                    state, info, final, _, _ = _timed_solve(
                        solve, problem, state0, cfg, device)
                solves.append({
                    "iterations": cfg.max_iterations,
                    "cg_iterations": [int(c) for c in
                                      info["cg_iterations"].cpu()]})
                finals.append(_failed(info, final))
        window_peak = _peak(device)
        traced = tr.collect(prof, solves, cfg.cg_max_iters, watch.records)
        for name, (reader, unit) in readers.items():
            value = reader.read(traced)
            if value is not None:
                metrics[name] = _metric(value, unit)
        extra_device = {"busy_s": traced.busy_s, "window_s": traced.window_s}
        breakdown = tr.breakdown(traced)
        attempted, failed = len(finals), sum(finals)

    answer = check.answer_of(state, info)
    del problem, state, info
    check.free_device_memory()
    t_ref = time.perf_counter()
    reference = check.reference_solve(scene, settings)
    print(f"portbench: {attempted} solves, reference "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    values = check.readings(scene, answer, reference)
    correct, lines = check.judge(values, cell.limits)

    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": cell.chips,
        "memory_peak_bytes": max(whole_peak, window_peak),
        "power_limit_w": _power_limit() if device.type == "cuda" else None,
        **extra_device,
    }
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": values[k], "limit": cell.limits[k]}
                        for k in check.NAMES}
    return Outcome(result=result, check_lines=lines)
