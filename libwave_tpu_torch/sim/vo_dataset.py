"""Synthetic VO dataset: a two-wheel robot on a circle observing landmarks.

Port of ``libwave_tpu.sim.vo_dataset`` (the reference's
``VoDatasetGenerator``): ``nb_landmarks`` landmarks uniform in x/y/z bounds,
a two-wheel robot driving a circle of radius 0.5 m at 1 m/s in steps of
``dt``, a camera mounted with q_BC = Rz(-90°) Rx(-90°) and rate-gated at
``hz``; per triggered frame every landmark is projected through the pinhole
model and kept when in front of the camera and strictly inside the image.
Observations come out dense: ``pixels (T, M, 2)`` with ``visible (T, M)``.

The JAX package draws the landmarks from a ``jax.random`` key; here they
come from a seeded numpy generator, or from the caller (``landmarks=``), so
that both packages can be fed the same landmarks. Everything after the
landmarks is deterministic. The robot's Euler recurrence and the camera's
rate gate (sequential, 3 numbers per step) run on the host in ``dtype``;
the (T, M) projection runs on ``device``. Directory save and load are not
ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.kinematics.two_wheel import two_wheel_step
from libwave_tpu_torch.utils.device import resolve
from libwave_tpu_torch.vision import camera as cam


@dataclasses.dataclass(frozen=True)
class VoSimParams:
    """Generator parameters (defaults as in the JAX package)."""

    image_width: int = 640
    image_height: int = 480
    fx: float = 554.25
    fy: float = 554.25
    cx: float = 320.0
    cy: float = 240.0
    hz: float = 100.0
    nb_landmarks: int = 100
    landmark_x_bounds: tuple = (-10.0, 10.0)
    landmark_y_bounds: tuple = (-10.0, 10.0)
    landmark_z_bounds: tuple = (-1.0, 1.0)
    circle_radius: float = 0.5
    velocity: float = 1.0
    dt: float = 0.01
    steps: int = 300

    def K(self, dtype=torch.float64, device=None) -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
             [0.0, 0.0, 1.0]],
            dtype=dtype, device=resolve(device),
        )

    def validate(self):
        if self.nb_landmarks <= 0:
            raise ValueError("nb_landmarks must be > 0")
        if self.hz <= 0 or self.dt <= 0:
            raise ValueError("hz and dt must be > 0")


class VoDataset(NamedTuple):
    """Dense synthetic dataset (all tensors fixed-shape)."""

    landmarks: torch.Tensor  # (M, 3) world positions
    camera_K: torch.Tensor  # (3, 3)
    times: torch.Tensor  # (T,)
    robot_p_GB: torch.Tensor  # (T, 3) body position (z = 0)
    robot_q_GB: torch.Tensor  # (T, 4) body orientation wxyz
    pixels: torch.Tensor  # (T, M, 2) projections (valid where visible)
    visible: torch.Tensor  # (T, M) bool — in-frustum AND camera triggered
    frame_has_obs: torch.Tensor  # (T,) bool — camera triggered this step

    @property
    def num_frames(self) -> int:
        return self.times.shape[0]


def q_BC(dtype=torch.float64, device=None) -> torch.Tensor:
    """Body-to-camera rotation Rz(-90°) * Rx(-90°)."""
    z = torch.zeros((2, 3), dtype=dtype, device=resolve(device))
    z[0, 2] = -math.pi / 2
    z[1, 0] = -math.pi / 2
    qz, qx = so3.exp_quat(z)
    return so3.quat_multiply(qz, qx)


def draw_landmarks(params: VoSimParams, seed: int = 0) -> np.ndarray:
    """(M, 3) float64 landmarks uniform in the parameter bounds, from a
    seeded numpy generator."""
    rng = np.random.default_rng(seed)
    bounds = (params.landmark_x_bounds, params.landmark_y_bounds,
              params.landmark_z_bounds)
    return np.stack([rng.uniform(lo, hi, params.nb_landmarks)
                     for lo, hi in bounds], axis=-1)


def generate_vo_dataset(params: VoSimParams, seed: int = 0, landmarks=None,
                        dtype=torch.float64, device=None) -> VoDataset:
    """Simulate the dataset on ``device`` (default: the card). Landmarks are
    ``landmarks`` (M, 3) when given, else :func:`draw_landmarks` of
    ``seed``."""
    params.validate()
    device = resolve(device)
    T, dt = params.steps, params.dt
    if landmarks is None:
        landmarks = draw_landmarks(params, seed)
    lm = torch.as_tensor(np.array(landmarks), dtype=dtype).to(device)

    # robot recurrence and camera gate, step by step as the reference's scan
    w = params.velocity / params.circle_radius
    u = torch.tensor([params.velocity, w], dtype=dtype)
    pose = torch.zeros(3, dtype=dtype)
    cam_acc = torch.zeros((), dtype=dtype)
    poses, triggers = [], []
    for _ in range(T):
        pose = two_wheel_step(pose, u, dt)
        cam_acc = cam_acc + dt
        trigger = bool(cam_acc > 1.0 / params.hz)
        if trigger:
            cam_acc = torch.zeros_like(cam_acc)
        poses.append(pose)
        triggers.append(trigger)
    pose2d = torch.stack(poses).to(device)
    trig = torch.tensor(triggers, device=device)

    zero = torch.zeros_like(pose2d[:, 0])
    p_GB = torch.stack([pose2d[:, 0], pose2d[:, 1], zero], dim=-1)
    q_GB = so3.exp_quat(torch.stack([zero, zero, pose2d[:, 2]], dim=-1))
    q_GC = so3.quat_multiply(q_GB, q_BC(dtype, device))
    K = params.K(dtype, device)
    uv, in_front = cam.pinhole_project(K, q_GC[:, None, :], p_GB[:, None, :],
                                       lm[None, :, :])
    vis = in_front & cam.in_image(uv, params.image_width, params.image_height)
    vis = vis & trig[:, None]
    return VoDataset(
        landmarks=lm,
        camera_K=K,
        times=torch.arange(T, dtype=dtype, device=device) * dt,
        robot_p_GB=p_GB,
        robot_q_GB=q_GB,
        pixels=uv,
        visible=vis,
        frame_has_obs=trig,
    )
