"""No run loads JAX, jaxlib, flax or the JAX package (whole top-level
names; the port's name begins with the JAX package's and passes), and the
command refuses to run without a card."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, tiny_cell

CODE = """
import sys, time, torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import tiny_cell
from portbench.harness import runner
sys.path.insert(0, {bench!r})
import run
torch.set_num_threads(2)
out = runner.run_cell(tiny_cell(), 3, 0.2, {trace}, torch.device("cpu"),
                      time.perf_counter())
assert out.result["correct"], out.check_lines
print("libwave_tpu_torch" in sys.modules, run.forbidden_modules())
"""


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_loads_no_jax(trace):
    code = CODE.format(root=str(ROOT), tests=str(ROOT / "portbench/tests"),
                       bench=str(ROOT / "portbench"), trace=trace)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(ROOT / "portbench"))
    import run

    monkeypatch.setitem(sys.modules, "libwave_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxfake.sub", object())
    assert "libwave_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax.numpy" in run.forbidden_modules()


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell["name"],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert (f"{cell['name']} needs {cell['chips']} CUDA card(s); found 0"
            in out.stderr)


@pytest.mark.cuda
def test_tiny_cell_on_the_card(cuda_device):
    import time

    from portbench.harness import runner

    for trace in (False, True):
        out = runner.run_cell(tiny_cell(), 17, 0.5, trace, cuda_device,
                              time.perf_counter())
        assert out.result["correct"], out.check_lines
        assert out.result["device"]["platform"] == "gpu"
