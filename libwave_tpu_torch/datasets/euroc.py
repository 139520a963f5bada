"""EuRoC MAV dataset (ASL format) loaders.

Port of ``libwave_tpu.datasets.euroc``. Layout:
``<seq>/mav0/{imu0,cam0,cam1,state_groundtruth_estimate0}/data.csv`` with
nanosecond timestamps (the ``mav0`` level may be left out). These feed the
VIO pipeline (``pipelines.euroc_vio``). The reference parses the CSVs with
its native reader; here they go through numpy's ``loadtxt``, the
reference's own fallback, with the same result: host float64 arrays.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np


class EurocImu(NamedTuple):
    times: np.ndarray  # (N,) seconds (from ns)
    gyro: np.ndarray  # (N, 3) rad/s
    accel: np.ndarray  # (N, 3) m/s^2


class EurocGroundTruth(NamedTuple):
    times: np.ndarray  # (N,) seconds
    p: np.ndarray  # (N, 3)
    q: np.ndarray  # (N, 4) [w, x, y, z]
    v: np.ndarray  # (N, 3)
    bg: np.ndarray  # (N, 3)
    ba: np.ndarray  # (N, 3)


def load_csv(path: str) -> np.ndarray:
    """A numeric CSV (``#`` comment lines skipped) as (rows, cols) f64."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return np.loadtxt(path, delimiter=",", comments="#", ndmin=2)


def _data_csv(root: str, sensor: str) -> str:
    direct = os.path.join(root, sensor, "data.csv")
    if os.path.exists(direct):
        return direct
    nested = os.path.join(root, "mav0", sensor, "data.csv")
    if os.path.exists(nested):
        return nested
    raise FileNotFoundError(f"no {sensor}/data.csv under {root}")


def load_euroc_imu(root: str) -> EurocImu:
    """imu0/data.csv: timestamp[ns], w_xyz, a_xyz.

    Nanosecond epochs pass through float64, which quantizes 2014-era
    timestamps at ~0.25 us: negligible for 200 Hz IMU integration.
    """
    m = load_csv(_data_csv(root, "imu0"))
    if m.shape[1] < 7:
        raise ValueError("imu0 csv needs 7 columns")
    return EurocImu(times=m[:, 0] * 1e-9, gyro=m[:, 1:4], accel=m[:, 4:7])


def load_euroc_ground_truth(root: str) -> EurocGroundTruth:
    """state_groundtruth_estimate0/data.csv: t, p(3), q_wxyz(4), v(3),
    bg(3), ba(3)."""
    m = load_csv(_data_csv(root, "state_groundtruth_estimate0"))
    if m.shape[1] < 17:
        raise ValueError("ground truth csv needs 17 columns")
    return EurocGroundTruth(
        times=m[:, 0] * 1e-9,
        p=m[:, 1:4],
        q=m[:, 4:8],  # EuRoC stores w, x, y, z
        v=m[:, 8:11],
        bg=m[:, 11:14],
        ba=m[:, 14:17],
    )


def load_euroc_camera_index(root: str, cam: str = "cam0"):
    """cam0/data.csv: timestamp[ns], filename. Returns (times_s, paths)."""
    path = _data_csv(root, cam)
    times, names = [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            if len(parts) < 2:
                continue
            times.append(float(parts[0]) * 1e-9)
            names.append(
                os.path.join(os.path.dirname(path), "data", parts[1].strip())
            )
    return np.asarray(times), names


def load_euroc_tracks(root: str, cam: str = "cam0") -> np.ndarray:
    """cam0/tracks.csv feature-track sidecar: (frame, landmark_id, u, v)
    rows, float64 (T, 4): what a front end's tracker exports from the cam0
    images."""
    path = _data_csv(root, cam).replace("data.csv", "tracks.csv")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no tracks.csv next to {cam}/data.csv")
    return load_csv(path)


# EuRoC cam0 intrinsics (sensor.yaml of the public dataset)
EUROC_CAM0_K = np.array(
    [[458.654, 0.0, 367.215], [0.0, 457.296, 248.375], [0.0, 0.0, 1.0]]
)
