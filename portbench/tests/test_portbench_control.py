"""The control (the plain reference in the program's place, computed in
TF32) fails the check where the program passes, at a size the CPU holds;
``portbench/control.py`` takes the same readings on the card at the cells'
own sizes."""

import json
import sys

import pytest

from conftest import ROOT, tiny_cell
from portbench.harness import check

sys.path.insert(0, str(ROOT / "portbench"))
import control  # noqa: E402

LIMITS = json.loads((ROOT / "portbench/limits/venice-mf.json").read_text())


@pytest.mark.parametrize("seed", [5, 2**34 + 9])
def test_control_fails_where_the_program_passes(cpu, seed):
    got = control.readings_for_seed(tiny_cell(), seed, cpu)
    ok, _ = check.judge(got["program"], LIMITS)
    bad, _ = check.judge(got["control"], LIMITS)
    assert ok and not bad
    assert got["control"]["cost_gap"] > 100 * got["program"]["cost_gap"]
