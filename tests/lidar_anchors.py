"""The JAX package's figures on ``bench_lidar``'s arrays: the anchors of
``chip_smoke.py``'s icp, lidar_odometry and ground phases.

    JAX_PLATFORMS=cpu python tests/lidar_anchors.py [icp] [odometry] [ground]

(all three without arguments) builds each configuration's arrays with
``libwave_tpu_torch.bench_lidar`` (the bytes ``chip_smoke.py`` checks by
sha256), runs the JAX package on them in f32 with x64 off, as ``bench.py``
runs, on this machine's CPU, and prints one JSON line per part:

- ``icp``: the scan pair through ``icp_match`` (multiscale and single
  scale), ``gicp_match`` and ``ndt_match`` under ``jax.jit``: translation
  error (m) against the true motion, ``||T_est - T_true||_F`` and
  iterations;
- ``odometry``: ``lidar_odometry`` on ``scan_sequence(T=50, n=4096)``,
  full-resolution ICP with LUM information and pose-graph refinement
  (``PoseGraphConfig()``), ``bench.py``'s multiscale ICP, and NDT without
  information: the worst position error (m) over the sequence;
- ``ground``: ``segment_ground`` on ``ground_scene()`` at the default bins,
  under ``jax.jit`` and called without it (which differ, ROADMAP.md §C):
  ground, obstacle and drivable recall and ground precision.

Not collected by pytest (no ``test_`` prefix). Minutes on a CPU: the
odometry part runs 49 pairs of 4,096 points at full resolution.
"""

import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from libwave_tpu import matching as jm  # noqa: E402
from libwave_tpu.geometry.se3 import SE3  # noqa: E402
from libwave_tpu.optim.pose_graph import PoseGraphConfig  # noqa: E402
from libwave_tpu.pipelines import LidarOdometryConfig, lidar_odometry  # noqa: E402
from libwave_tpu_torch import bench_lidar as bl  # noqa: E402


def _params(cls, port_params):
    """The JAX package's dataclass with the port configuration's fields."""
    return cls(**{f: getattr(port_params, f)
                  for f in cls.__dataclass_fields__})


def part_icp():
    ref, tgt, t_true = bl.scan_pair()
    c, s = np.cos(bl.PAIR_YAW), np.sin(bl.PAIR_YAW)
    T_true = np.eye(4)
    T_true[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T_true[:3, 3] = t_true
    a = jm.make_cloud(jnp.asarray(ref))
    b = jm.make_cloud(jnp.asarray(tgt))
    out = {"sha256": [bl.sha256(ref), bl.sha256(tgt)]}
    for name, fn, params in (
            ("multiscale", jm.icp_match, _params(jm.ICPParams,
                                                 bl.ICP_MULTISCALE)),
            ("singlescale", jm.icp_match, _params(jm.ICPParams,
                                                  bl.ICP_SINGLE)),
            ("gicp", jm.gicp_match, _params(jm.GICPParams, bl.GICP)),
            ("ndt", jm.ndt_match, _params(jm.NDTParams, bl.NDT))):
        res = jax.jit(lambda r, t: fn(r, t, params))(a, b)
        T = np.asarray(SE3(*res.transform).matrix(), np.float64)
        out[name] = {
            "t_err_m": float(np.linalg.norm(np.asarray(res.transform.t)
                                            - t_true)),
            "t_diff": float(np.linalg.norm(T - T_true)),
            "iterations": int(res.iterations),
        }
    return out


def part_odometry(T=50, n=4096):
    pts, mask, _, p_true = bl.scan_sequence(T, n)
    scans = jm.PointCloud(jnp.asarray(pts.astype(np.float32)),
                          jnp.asarray(mask))
    out = {"sha256": [bl.sha256(pts), bl.sha256(mask)], "T": T, "n": n}
    runs = {
        "icp_refined": (jm.icp_match, LidarOdometryConfig(
            icp=_params(jm.ICPParams, bl.ODOMETRY_ICP),
            refine_pose_graph=True, pose_graph=PoseGraphConfig())),
        "icp_multiscale": (jm.icp_match, LidarOdometryConfig(
            icp=_params(jm.ICPParams, bl.ICP_MULTISCALE))),
        "ndt": (jm.ndt_match, LidarOdometryConfig(
            icp=_params(jm.NDTParams, bl.NDT), estimate_information=False)),
    }
    for name, (matcher, cfg) in runs.items():
        t0 = time.perf_counter()
        res = jax.jit(lambda s: lidar_odometry(s, cfg, matcher=matcher))(
            scans)
        err = np.linalg.norm(np.asarray(res.trajectory.t, np.float64)
                             - p_true, axis=-1)
        out[name] = {"worst_position_err_m": float(err.max()),
                     "converged": bool(np.asarray(res.converged).all()),
                     "iterations": np.asarray(res.iterations).tolist(),
                     "cpu_s": time.perf_counter() - t0}
    return out


def part_ground():
    pts, labels = bl.ground_scene()
    params = _params(jm.GroundSegmentationParams, bl.GROUND_PARAMS)
    cloud = jm.make_cloud(jnp.asarray(pts))
    out = {"sha256": [bl.sha256(pts), bl.sha256(labels)]}
    jit = np.asarray(jax.jit(lambda c: jm.segment_ground(c, params))(
        cloud).labels)
    eager = np.asarray(jm.segment_ground(cloud, params).labels)
    out["jit"] = bl.ground_scores(jit, labels)
    out["eager"] = bl.ground_scores(eager, labels)
    out["jit_vs_eager_points"] = int((jit != eager).sum())
    return out


if __name__ == "__main__":
    parts = {"icp": part_icp, "odometry": part_odometry,
             "ground": part_ground}
    for name in sys.argv[1:] or list(parts):
        print(json.dumps({name: parts[name]()}), flush=True)
