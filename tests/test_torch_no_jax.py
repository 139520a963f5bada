"""The port and chip_smoke.py run without JAX (and write and read PNGs
without PIL, and fill parameter dataclasses without PyYAML, whose
``load_config`` then raises ``ConfigError("pyyaml unavailable")``), and
chip_smoke.py refuses to run without a CUDA device: it
exits non-zero and never prints its result.

Each case runs in a fresh interpreter: one where ``jax`` (and the JAX
package ``libwave_tpu``), PIL and ``yaml`` cannot be imported, so any
import of them from the port fails the test.
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
sys.modules["PIL"] = None
sys.modules["yaml"] = None
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
            if m.split(".")[0] in ("jax", "jaxlib", "libwave_tpu", "PIL",
                                   "yaml")
            and sys.modules[m] is not None], "a JAX module was loaded"
for new in ("ops.hamming", "vision.matcher", "vision.tracker",
            "containers.landmark", "pipelines.visual_frontend",
            "bench_frontend", "sim.render", "utils.config", "ops.segmm",
            "geometry.se3", "benchmark.trajectory", "optim.imu",
            "kinematics.two_wheel", "vision.camera", "sim.vo_dataset",
            "pipelines.vio", "utils.device", "datasets.euroc",
            "sim.euroc_sim", "optim.marginalization", "pipelines.euroc_vio",
            "utils.checkpoint",
            "pipelines.windowed_vio", "pipelines.windowed_ba",
            "bench_windowed", "geometry.euler", "native", "matching",
            "matching.pointcloud", "matching.knn", "matching.loop",
            "matching.icp", "matching.gicp", "matching.ndt", "matching.multi",
            "matching.ground_segmentation", "pipelines.lidar_odometry",
            "datasets.kitti", "bench_lidar", "vision.images", "vision.flann",
            "vision.epipolar", "vision.detector", "vision.descriptor",
            "pipelines.vo_frontend", "optim.states", "optim.factors",
            "optim.nlls", "vision.flann_float", "geography",
            "geography.world_frame", "containers.measurement",
            "geometry.frames", "geometry.pose_cov", "controls",
            "controls.pid", "kinematics.pose", "kinematics.gimbal",
            "kinematics.quadrotor", "bench_trajectory", "parallel",
            "parallel.mesh", "parallel.dist_ba", "parallel.dist_vio",
            "parallel.dist_pose_graph", "parallel.multihost",
            "pipelines.overlap", "utils.trace", "utils.timing", "utils.math",
            "utils.angles", "utils.io", "utils.file", "utils.log", "testing",
            "viz", "bench_parallel"):
    assert "libwave_tpu_torch." + new in names, new
# cam0 PNGs are written and read back with PIL blocked
import os, tempfile
import numpy as np
from libwave_tpu_torch.sim import euroc_sim
from libwave_tpu_torch.vision import images
root = tempfile.mkdtemp()
sim = euroc_sim.EurocSimParams(duration=0.4, cam_hz=5.0, nb_landmarks=30,
                               width=64, height_px=48, fx=40.0, fy=40.0,
                               cx=32.0, cy=24.0, render_images=True)
euroc_sim.generate_euroc_sequence(root, sim, seed=1, device="cpu")
got = images.read_image_sequence(os.path.join(root, "mav0", "cam0", "data"))
assert (got == euroc_sim.cam0_frames(sim, seed=1)).all(), "PNG round trip"
# a VO dataset through its directory, BA problems from it, a batch of two
import torch
from libwave_tpu_torch.optim import ba
from libwave_tpu_torch.sim import vo_dataset
params = vo_dataset.VoSimParams(nb_landmarks=30, steps=100, hz=10.0,
                                fx=200.0, fy=200.0)
ds = vo_dataset.generate_vo_dataset(params, seed=2, device="cpu")
vo_dataset.save_vo_dataset(ds, os.path.join(root, "vo"))
back = vo_dataset.load_vo_dataset(os.path.join(root, "vo"), device="cpu")
problems, states = zip(*(ba.ba_from_dataset(
    d, noise_pixels=0.5, generator=torch.Generator().manual_seed(0),
    device="cpu") for d in (ds, back)))
assert torch.equal(problems[0].uv, problems[1].uv), "dataset round trip"
out, info = ba.solve_ba_batched(problems, states,
                                ba.BAConfig(max_iterations=2))
assert info["costs"].shape == (2, 2) and torch.isfinite(out.lm).all()
# parameters without PyYAML: from_dict fills them, load_config refuses
import dataclasses
from libwave_tpu_torch.utils import config
from libwave_tpu_torch.vision.flann_float import FloatIndexParams
assert config.yaml is None
assert config.from_dict(FloatIndexParams, {"method": "kmeans"}).method \
    == "kmeans"
try:
    config.load_config(FloatIndexParams, os.path.join(root, "none.yaml"))
except config.ConfigError as e:
    assert str(e) == "pyyaml unavailable", str(e)
else:
    raise AssertionError("load_config ran without PyYAML")
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
    # the back end's, the front end's, VIO's, EuRoC VIO's, the windowed
    # solvers', the lidar path's, the pixels path's and the trajectory
    # back end's and leaves' modules, the distributed layer and the last
    # utilities
    assert count >= 97


def test_chip_smoke_fails_without_cuda():
    # hide any card, so the case means the same on a machine that has one
    proc = _run(["chip_smoke.py"], CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr
