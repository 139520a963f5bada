"""The port and chip_smoke.py run without JAX, and chip_smoke.py refuses to
run without a CUDA device: it exits non-zero and never prints its result.

Each case runs in a fresh interpreter: one where ``jax`` (and the JAX
package ``libwave_tpu``) cannot be imported, so any import of them from the
port fails the test.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

BLOCK_JAX = """
import sys
for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]:
    del sys.modules[name]
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["libwave_tpu"] = None
"""

IMPORT_ALL = BLOCK_JAX + """
import importlib, pkgutil
import libwave_tpu_torch
names = [m.name for m in pkgutil.walk_packages(libwave_tpu_torch.__path__,
                                                "libwave_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "libwave_tpu")
            and sys.modules[m] is not None], "a JAX module was loaded"
for new in ("ops.hamming", "vision.matcher", "vision.tracker",
            "containers.landmark", "pipelines.visual_frontend",
            "bench_frontend", "sim.render", "utils.config", "ops.segmm",
            "geometry.se3", "benchmark.trajectory", "optim.imu",
            "kinematics.two_wheel", "vision.camera", "sim.vo_dataset",
            "pipelines.vio", "utils.device", "launch_count",
            "datasets.euroc", "sim.euroc_sim", "optim.marginalization",
            "pipelines.euroc_vio", "bench_designs", "utils.checkpoint",
            "pipelines.windowed_vio", "pipelines.windowed_ba",
            "bench_windowed"):
    assert "libwave_tpu_torch." + new in names, new
print("imported", len(names), "modules")
"""


def _run(args, timeout=300, **env_extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), **env_extra)
    return subprocess.run(
        [sys.executable, *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def test_port_and_chip_smoke_import_without_jax():
    proc = _run(["-c", IMPORT_ALL])
    assert proc.returncode == 0, proc.stderr
    count = int(proc.stdout.split()[1])
    # the back end's, the front end's, VIO's, EuRoC VIO's and the windowed
    # solvers' modules
    assert count >= 47


def test_chip_smoke_fails_without_cuda():
    # hide any card, so the case means the same on a machine that has one
    proc = _run(["chip_smoke.py"], CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr
