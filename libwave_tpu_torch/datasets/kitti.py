"""KITTI odometry dataset loaders.

Port of ``libwave_tpu.datasets.kitti``. Layout:
``sequences/<NN>/velodyne/*.bin`` (float32 x, y, z, intensity),
``poses/<NN>.txt`` (3x4 row-major world-from-camera per line),
``sequences/<NN>/times.txt``. Text files go through the port's
:func:`libwave_tpu_torch.native.load_csv`.
"""

from __future__ import annotations

import numpy as np
import torch

from libwave_tpu_torch import native
from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.utils.device import resolve


def load_kitti_velodyne(path: str, max_points: int | None = None) -> np.ndarray:
    """One velodyne scan .bin -> (N, 3) float32 (intensity dropped)."""
    raw = np.fromfile(path, dtype=np.float32)
    if raw.size % 4 != 0:
        raise ValueError(f"corrupt velodyne bin: {path}")
    pts = raw.reshape(-1, 4)[:, :3]
    if max_points is not None and len(pts) > max_points:
        step = len(pts) / max_points
        pts = pts[(np.arange(max_points) * step).astype(int)]
    return np.ascontiguousarray(pts)


def load_kitti_poses(path: str, device=None) -> SE3:
    """poses txt -> SE3 batch (f64) on ``device`` (default: the card)."""
    m = native.load_csv(path)
    if m.shape[1] != 12:
        m = np.loadtxt(path, ndmin=2)
    if m.shape[1] != 12:
        raise ValueError("KITTI pose rows must have 12 values")
    T = torch.as_tensor(m.reshape(-1, 3, 4), device=resolve(device))
    return SE3(q=so3.rot_to_quat(T[:, :, :3]), t=T[:, :, 3])


def load_kitti_times(path: str) -> np.ndarray:
    return native.load_csv(path).reshape(-1)
