"""Two-wheel (unicycle) robot model (port of
``libwave_tpu.kinematics.two_wheel``).

The reference's ``TwoWheelRobot2DModel`` (wave_kinematics/include/wave/
kinematics/two_wheel.hpp:15, src/two_wheel.cpp:5-11): state ``[x, y,
theta]``, input ``[v, omega]``, Euler integration
``pose += [v cos(theta), v sin(theta), omega] * dt``.
"""

from __future__ import annotations

import torch


def two_wheel_step(pose: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """One Euler step. pose (..., 3) [x, y, theta]; u (..., 2) [v, omega]."""
    v, omega = u[..., 0], u[..., 1]
    theta = pose[..., 2]
    delta = torch.stack(
        [v * torch.cos(theta), v * torch.sin(theta), omega.expand_as(theta)],
        dim=-1,
    )
    return pose + delta * dt


def simulate_two_wheel(pose0: torch.Tensor, inputs: torch.Tensor,
                       dt) -> torch.Tensor:
    """Roll out T steps; inputs (T, 2) -> poses (T, 3), the pose *after*
    each step (the reference's update loop)."""
    traj = []
    pose = pose0
    for u in inputs:
        pose = two_wheel_step(pose, u, dt)
        traj.append(pose)
    return torch.stack(traj) if traj else pose0.new_zeros((0, 3))
