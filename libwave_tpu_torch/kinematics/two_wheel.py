"""Two-wheel (unicycle) robot model (port of
``libwave_tpu.kinematics.two_wheel.two_wheel_step``): state ``[x, y,
theta]``, input ``[v, omega]``, Euler integration
``pose += [v cos(theta), v sin(theta), omega] * dt``."""

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
