"""The plain reference: it imports nothing of the port, and on the CPU at a
tiny size it solves as ``libwave_tpu_torch``'s ``solve_ba`` does, on both
of the port's routes."""

import subprocess
import sys

import pytest
import torch

from conftest import ROOT, tiny_cell
from portbench.harness import check, port
from portbench.harness.scene import make_scene
from portbench.reference import ba_ref


def test_reference_imports_only_torch():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.ba_ref; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    names = set(eval(out))
    assert not names & {"libwave_tpu_torch", "libwave_tpu", "jax",
                        "jaxlib", "flax"}


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11,
                      1.0 + 2**-12, -3.0 - 2**-9 - 2**-13], dtype=torch.float32)
    got = ba_ref.tf32(x)
    want = torch.tensor([1.0, 1.0, 1.0 + 2**-9, 1.0, -3.0 - 2**-9],
                        dtype=torch.float32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("traffic", ["lm5_matrix_free", "lm5_explicit_s"])
def test_reference_follows_solve_ba(cpu, traffic):
    cell = tiny_cell(traffic)
    scene = make_scene(cell.config, cell.traffic, 2**33 + 1, cpu)
    problem, state0, cfg = port.build(scene, cell.config, cell.traffic, cpu)
    assert (problem.bands is not None) == (traffic == "lm5_explicit_s")
    state, info = port.solve(problem, state0, cfg)
    ref = check.reference_solve(scene, port.settings(cell.config,
                                                     cell.traffic))
    got = check.readings(scene, check.answer_of(state, info), ref)
    assert got["cost_gap"] < 1e-5
    assert got["reported_gap"] < 1e-5
    assert got["trajectory_gap"] < 1e-3
    assert got["state_gap"] < 3e-2
    start = ba_ref.exact_cost(check.observations(scene), scene.q0, scene.p0,
                              scene.X0)
    assert ref[3] < 0.1 * start  # the solve does real work
