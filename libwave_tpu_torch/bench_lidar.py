"""The lidar configurations the port is measured on, and their data.

JAX-free numpy copies of what ``bench.py`` and the JAX package's tests
build, for ``chip_smoke.py``'s icp, lidar_odometry and ground phases:

- :func:`scan_pair`: ``bench.py``'s ``bench_icp`` pair (``bench.py:644-676``,
  the synthetic ring-of-road fallback): 4,096 points from
  ``default_rng(1)``, the target turned 0.02 rad about z and moved by
  ``(0.3, -0.15, 0.02)`` m;
- :func:`scan_sequence`: ``tests/test_pipelines.py``'s
  ``make_scan_sequence`` (a world cloud from ``synthetic_scan`` seen from
  a sensor moving 0.08 m and 0.02 rad of yaw a scan);
- :func:`ground_scene`: ``tests/test_ground_segmentation.py``'s labelled
  scene at a KITTI HDL-64 scan's density (116,800 points);
- :func:`numpy_icp`: ``bench.py``'s single-scale numpy SVD-ICP anchor
  (``bench.py:700-719``), its neighbours from the port's
  ``native.knn_exact``.

Every array is made with numpy's seeded generators, elementwise numpy
arithmetic and ``math``'s sin and cos (no BLAS product, whose rounding may
depend on the CPU), so every machine makes the same bytes:
:data:`SHA256` holds each array's sha256 (:func:`sha256`).
The JAX package's figures on these arrays are taken by
``tests/lidar_anchors.py``.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from libwave_tpu_torch import native
from libwave_tpu_torch.matching.gicp import GICPParams
from libwave_tpu_torch.matching.ground_segmentation import (
    DRIVABLE,
    GROUND,
    OBSTACLE,
    GroundSegmentationParams,
)
from libwave_tpu_torch.matching.icp import ICPParams
from libwave_tpu_torch.matching.ndt import NDTParams
from libwave_tpu_torch.matching.pointcloud import synthetic_scan

# int(jax.random.randint(jax.random.key(0), (), 0, 2**31 - 1)) with x64
# enabled: the seed tests/test_pipelines.py's synthetic_scan(key(0)) draws
SCAN_SEED = 1089934416

# bench.py's bench_icp (Config 3) and its single-scale anchor schedule
ICP_MULTISCALE = ICPParams(max_iter=25, multiscale_steps=2, res=0.3)
ICP_SINGLE = ICPParams(max_iter=25, multiscale_steps=0, res=-1.0)
# the JAX package's own test settings (tests/test_matching.py:173,185)
GICP = GICPParams(res=0.1, max_iter=50)
NDT = NDTParams(res=2.0, max_iter=60)
# lidar odometry at full resolution (tests/test_pipelines.py:107)
ODOMETRY_ICP = ICPParams(res=0, multiscale_steps=0, max_corr=1.0,
                         max_iter=40)
# the reference's default bins: 72 x 200, rmax 100 m
GROUND_PARAMS = GroundSegmentationParams()

PAIR_YAW = 0.02
PAIR_T = (0.3, -0.15, 0.02)

SHA256 = {
    "pair": ("e69ea018e7cb0a3c600ed04c344c7fe228dfd4ea077f129c"
             "887be407e281b127",
             "ae06a18928562f32335c68e2c26f663586bb0ba831e30db0"
             "1daa04e75b438de3"),
    # points and mask of scan_sequence(50, 4096)
    "sequence": ("8118744dcc9a1499977e8c211cf93f5a73701306a97c3cdf"
                 "62b8c2d440e66d66",
                 "85ef729c1dbabefb800c88e1f933dca472fced6660a0d392"
                 "ece22689be371e1f"),
    "ground": ("4ab833dff79163d7bfcdefb0c93c1c33c6f01742792f76bc"
               "25363fe846198307",
               "6f58bccfced1bffddd28bc2e8bcd9cb04f029b8e77135e0c"
               "94cb602db5a07462"),
}


def sha256(*arrays) -> str:
    """sha256 of the arrays' bytes, in order."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _cos(a):
    return np.array([math.cos(x) for x in np.ravel(a)]).reshape(np.shape(a))


def _sin(a):
    return np.array([math.sin(x) for x in np.ravel(a)]).reshape(np.shape(a))


def scan_pair():
    """(ref (4096, 3), target (4096, 3)) float32 and the true translation
    (3,) float32: target = R_z(0.02) ref + t."""
    rng = np.random.default_rng(1)
    n = 4096
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = np.abs(rng.normal(12, 6, n)) + 2
    z = rng.uniform(-1.5, 1.5, n) + 0.1 * rad
    pts = np.stack([rad * _cos(ang), rad * _sin(ang), z],
                   axis=-1).astype(np.float32)
    c, s = np.float32(math.cos(PAIR_YAW)), np.float32(math.sin(PAIR_YAW))
    t = np.asarray(PAIR_T, np.float32)
    x, y = pts[:, 0], pts[:, 1]
    tgt = np.stack([x * c - y * s + t[0], x * s + y * c + t[1],
                    pts[:, 2] + t[2]], axis=-1)
    return pts, tgt, t


def _cross(a, b):
    return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], axis=-1)


def _quat_rotate(q, v):
    w, u = q[..., 0:1], q[..., 1:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def scan_sequence(T: int = 50, n: int = 4096, step: float = 0.08,
                  yaw_step: float = 0.02):
    """``make_scan_sequence``'s scans of one world cloud from a moving
    sensor, f64: points (T, n, 3), mask (T, n), and the sensor poses q
    (T, 4), p (T, 3) (scan_t = T_t^-1 world)."""
    world = synthetic_scan(SCAN_SEED, n=n, dtype=torch.float64,
                           device="cpu")
    wp = world.points.numpy()
    q = np.zeros((T, 4))
    p = np.zeros((T, 3))
    pts = np.zeros((T, n, 3))
    for k in range(T):
        yaw = yaw_step * k
        if yaw * yaw < 1e-12:  # exp_quat's small-angle branch
            q[k] = (1.0 - yaw * yaw / 8.0, 0.0, 0.0,
                    (0.5 - yaw * yaw / 48.0) * yaw)
        else:
            theta = math.sqrt(yaw * yaw)
            q[k] = (math.cos(0.5 * theta), 0.0, 0.0,
                    math.sin(0.5 * theta) / theta * yaw)
        p[k] = (step * k, -0.5 * step * k, 0.0)
        qi = q[k] * np.array([1.0, -1.0, -1.0, -1.0])
        pts[k] = _quat_rotate(qi, wp) - _quat_rotate(qi, p[k])
    mask = np.broadcast_to(world.mask.numpy(), (T, n)).copy()
    return pts, mask, q, p


def ground_scene(n_ground: int = 96000, n_obs: int = 16000,
                 n_drv: int = 4800):
    """``tests/test_ground_segmentation.py``'s scene from
    ``default_rng(0)``: gently sloped ground, vertical posts (obstacles)
    and high wires (drivable-under). Returns points (N, 3) float32 and the
    true labels (N,) int64."""
    rng = np.random.default_rng(0)
    gx = rng.uniform(-40, 40, n_ground)
    gy = rng.uniform(-40, 40, n_ground)
    gz = 0.01 * gx + 0.02 * gy + rng.normal(0, 0.03, n_ground)
    px = np.repeat(rng.uniform(-30, 30, n_obs // 20), 20)
    py = np.repeat(rng.uniform(-30, 30, n_obs // 20), 20)
    pz = 0.01 * px + 0.02 * py + rng.uniform(0.4, 1.1, n_obs)
    wx = rng.uniform(-30, 30, n_drv)
    wy = rng.uniform(-30, 30, n_drv)
    wz = 0.01 * wx + 0.02 * wy + rng.uniform(2.5, 4.0, n_drv)
    pts = np.concatenate([np.stack([gx, gy, gz], axis=-1),
                          np.stack([px, py, pz], axis=-1),
                          np.stack([wx, wy, wz], axis=-1)], axis=0)
    labels = np.concatenate([np.full(n_ground, GROUND),
                             np.full(n_obs, OBSTACLE),
                             np.full(n_drv, DRIVABLE)])
    return pts.astype(np.float32), labels


def ground_scores(labels, true_labels):
    """The JAX package test's four figures: ground recall, obstacle and
    drivable recall among labelled points, ground precision."""
    g, o, d = (true_labels == c for c in (GROUND, OBSTACLE, DRIVABLE))
    labeled = labels != -1
    return {
        "ground_recall": float((labels[g] == GROUND).mean()),
        "obstacle_recall": float((labels[o] == OBSTACLE)[labeled[o]].mean()),
        "drivable_recall": float((labels[d] == DRIVABLE)[labeled[d]].mean()),
        "ground_precision": float(g[labels == GROUND].mean()),
    }


def numpy_icp(src, dst, iters: int = 25):
    """``bench.py``'s numpy point-to-point SVD-ICP (single scale, ``iters``
    trips), exact nearest neighbours from ``native.knn_exact``. Returns
    the estimated translation (3,) f64."""
    T_R = np.eye(3)
    T_t = np.zeros(3)
    moved = src.astype(np.float64)
    for _ in range(iters):
        idx, _ = native.knn_exact(moved.astype(np.float32),
                                  dst.astype(np.float32), 1)
        q = dst[idx[:, 0]].astype(np.float64)
        cp, cq = moved.mean(0), q.mean(0)
        H = (moved - cp).T @ (q - cq)
        U, _, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
        t = cq - R @ cp
        moved = moved @ R.T + t
        T_R = R @ T_R
        T_t = R @ T_t + t
    return T_t
