"""A whole run, past the look for a card, with the timed path broken
underneath: ``correct`` comes out false for each fault a solve can have,
and true for the sound path. (One chip: there is no exchange between chips
to leave out.) On the CPU at a tiny size; on the card at each cell's own
size (``-s`` prints each fault's compared numbers beside their limits)."""

import json
import time

import pytest

from conftest import ROOT, tiny_cell
from portbench.harness import port, runner, spec

LIMITS = json.loads((ROOT / "portbench/limits/venice-mf.json").read_text())


def sound(problem, state, cfg):
    return port.solve(problem, state, cfg)


def state_unchanged(problem, state, cfg):
    _, info = port.solve(problem, state, cfg)
    return state, info


def half_the_observations(problem, state, cfg):
    """Every other observation left out, the rest weighted twice: the sum
    stands for the whole as a mean over the rest would."""
    w = problem.weight.clone()
    w[1::2] = 0.0
    return port.solve(problem._replace(weight=2.0 * w), state, cfg)


def answer_state_altered(problem, state, cfg):
    out, info = port.solve(problem, state, cfg)
    lm = out.lm.clone()
    lm[0] += 1.0  # one point of the answer moved by a camera spacing
    return out._replace(lm=lm), info


def answer_cost_altered(problem, state, cfg):
    out, info = port.solve(problem, state, cfg)
    return out, dict(info, final_cost=info["final_cost"] * 1.01)


FAULTS = [
    (sound, True),
    (state_unchanged, False),
    (half_the_observations, False),
    (answer_state_altered, False),
    (answer_cost_altered, False),
]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _judged(out, correct):
    assert out.result["correct"] is correct, out.check_lines
    assert list(out.result)[-1] == "checks"
    assert len(out.check_lines) == len(out.result["checks"]) == 4


@pytest.mark.parametrize("solve,correct", FAULTS)
def test_run_judges_the_timed_path(cpu, solve, correct):
    out = runner.run_cell(tiny_cell(limits=LIMITS), 2**35 + 11, 0.5, False,
                          cpu, time.perf_counter(), solve=solve)
    _judged(out, correct)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("solve,correct", FAULTS)
def test_cell_judges_the_timed_path(cuda_device, workload, solve, correct):
    out = runner.run_cell(spec.load_cell(workload), 2**33 + 2**31 + 7, 1.0,
                          False, cuda_device, time.perf_counter(),
                          solve=solve)
    print(workload, solve.__name__, "; ".join(out.check_lines))
    _judged(out, correct)
