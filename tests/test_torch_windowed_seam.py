"""The seam test: a second pass repairs a drifted first pass, on both
packages (on the CPU at f64).

A stiff mini-chain: 3 s at a 20 Hz camera and 200 Hz IMU, 100 landmarks,
seed 0 (61 keyframes; the IMU whitening passes the 3e4 gate, so the
Hessian sums are the widened path's), written by the JAX package, run at
``window=20, overlap=5`` (4 windows) with ``passes=1`` and a checkpoint.
The checkpoint's pass-1 estimate is then drifted, growing along the chain
to 0.03 rad of yaw about gravity and (0.06, -0.04, 0.02) m, as two passes
that drift apart in the unobservable directions would. A rerun with
``passes=2`` resumes into the second pass, whose windows initialize their
tails from the drifted estimate gauge-aligned at each seam. Its ATE must be
no larger than the drifted estimate's (read by a rerun with ``passes=1``,
which only scores the checkpoint). Each package runs the test on its own
files: the port measured 0.009803 m for pass 1, 0.021160 m drifted and
0.009554 m after pass 2, the JAX package the same to the digits shown. The
JAX package's half takes about 64 s, most of it compiling, and is marked
``slow``; the port's half takes about 10 s.
"""

import os

import numpy as np
import pytest
import torch

from libwave_tpu.pipelines import windowed_vio as jw
from libwave_tpu.pipelines.euroc_vio import EurocVIOParams as JParams
from libwave_tpu.sim import euroc_sim as jsim
from libwave_tpu.utils import checkpoint as jck
from libwave_tpu_torch.pipelines import windowed_vio as tw
from libwave_tpu_torch.pipelines.euroc_vio import EurocVIOParams as TParams
from libwave_tpu_torch.utils import checkpoint as tck
from test_torch_windowed_vio import one_torch_thread  # noqa: F401

WIN = dict(window=20, overlap=5, solve_iters_chunk=4, solve_chunks_max=3)
KEYS = ("est_q", "est_p", "est_v", "est_bg", "est_ba", "solved_upto",
        "windows_done", "window_costs", "prior_Lambda", "prior_b",
        "excl_pairs", "pass_done")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wvio_seam"))
    jsim.generate_euroc_sequence(
        root, jsim.EurocSimParams(duration=3.0, cam_hz=20.0, imu_hz=200.0,
                                  nb_landmarks=100), seed=0)
    return root


def _drift(snap):
    """The pass-1 estimate drifted in yaw and position, growing linearly
    from the first keyframe (host numpy)."""
    q, p, v = (np.array(snap[k], np.float64) for k in ("est_q", "est_p",
                                                         "est_v"))
    u = np.linspace(0.0, 1.0, len(q))[:, None]
    yaw = 0.03 * u[:, 0]
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.zeros((len(q), 3, 3))
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = c, -s, s, c
    R[:, 2, 2] = 1.0
    qz = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], 1)
    snap = dict(snap)
    snap["est_q"] = tw._quat_mult_np(qz, q)
    snap["est_p"] = (np.einsum("nij,nj->ni", R, p - p[0]) + p[0]
                     + u * np.array([0.06, -0.04, 0.02]))
    snap["est_v"] = np.einsum("nij,nj->ni", R, v)
    return snap


def _seam(root, ck, run, load, save):
    r1 = run(root, 1, ck)
    path = os.path.join(ck, "windowed_vio.npz")
    snap = {k: np.asarray(x) for k, x in load(
        path, {k: np.zeros(0) for k in KEYS}).items()}
    assert int(snap["windows_done"]) == r1["num_windows"] == 4
    assert int(snap["pass_done"]) == 0
    save(path, _drift(snap))
    drifted = run(root, 1, ck)  # nothing left to solve: scores the file
    assert drifted["completed"] and drifted["solve_seconds"] == 0.0
    r2 = run(root, 2, ck)
    assert r2["passes"] == 2 and r2["completed"]
    assert drifted["ate_rmse"] > r1["ate_rmse"]
    return r1["ate_rmse"], drifted["ate_rmse"], r2["ate_rmse"]


def test_second_pass_repairs_drift_port(root, tmp_path):
    def run(root, passes, ck):
        return tw.run_euroc_vio_windowed(
            root, TParams(), tw.WindowedVIOParams(**WIN, passes=passes),
            checkpoint_dir=ck, device="cpu", dtype=torch.float64)[1]

    def load(path, like):
        return {k: v.numpy() for k, v in tck.load_checkpoint(path,
                                                             like).items()}

    ate1, ate_drift, ate2 = _seam(root, str(tmp_path), run, load,
                                  tck.save_checkpoint)
    print(f"port: pass 1 {ate1:.6f} m, drifted {ate_drift:.6f} m, pass 2 "
          f"{ate2:.6f} m")
    assert ate2 <= ate_drift


@pytest.mark.slow  # ~64 s on one CPU worker: two jit compiles per run
def test_second_pass_repairs_drift_reference(root, tmp_path):
    def run(root, passes, ck):
        return jw.run_euroc_vio_windowed(
            root, JParams(), jw.WindowedVIOParams(**WIN, passes=passes),
            checkpoint_dir=ck)[1]

    ate1, ate_drift, ate2 = _seam(root, str(tmp_path), run,
                                  jck.load_checkpoint, jck.save_checkpoint)
    print(f"JAX package: pass 1 {ate1:.6f} m, drifted {ate_drift:.6f} m, "
          f"pass 2 {ate2:.6f} m")
    assert ate2 <= ate_drift
