"""Combined manifold states over trajectories (port of
``libwave_tpu.optim.states``).

The reference's wave_gtsam state types with their block Retract/Local
(stacked sub-tangents):

- ``PoseVelState``        {Pose3, 6d twist},              dim 12
  (wave_gtsam/include/wave/gtsam/pose_vel.hpp:24,69)
- ``PoseVelBiasState``    + 3d translational (GPS) bias,  dim 15, offsets
  pose=0 / vel=6 / bias=12 (pose_vel_bias.hpp:26,37,77)
- ``PoseVelAccBiasState`` + 6d acceleration state,        dim 21
  (pose_vel_acc_bias.hpp:27,83)

A state is the whole trajectory as stacked tensors (q (T, 4), p (T, 3),
vel (T, 6), ...); ``retract``/``local`` work on (T, D) tangent blocks at
once. The pose block uses the SE(3) exponential retraction of
:mod:`libwave_tpu_torch.geometry.se3`, twist order [omega, v].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libwave_tpu_torch.geometry import se3, so3
from libwave_tpu_torch.geometry.se3 import SE3


def _zeros(T, n, dtype, device):
    return torch.zeros((T, n), dtype=dtype, device=device)


class PoseVelState(NamedTuple):
    """dim 12 per step: [pose(6), vel(6)]."""

    q: torch.Tensor  # (T, 4)
    p: torch.Tensor  # (T, 3)
    vel: torch.Tensor  # (T, 6) angular then linear (pose_vel.hpp comment)

    DIM = 12

    @staticmethod
    def identity(T: int, dtype=torch.float64, device=None) -> "PoseVelState":
        q = so3.quat_identity((T,), dtype, device)
        return PoseVelState(q=q, p=_zeros(T, 3, dtype, q.device),
                            vel=_zeros(T, 6, dtype, q.device))

    def pose(self) -> SE3:
        return SE3(q=self.q, t=self.p)

    def retract(self, dx: torch.Tensor) -> "PoseVelState":
        """dx (T, 12): [xi_pose(6), dvel(6)]."""
        new_pose = se3.boxplus(self.pose(), dx[:, 0:6])
        return PoseVelState(q=new_pose.q, p=new_pose.t,
                            vel=self.vel + dx[:, 6:12])

    def local(self, other: "PoseVelState") -> torch.Tensor:
        """Tangent taking self to other (gtsam Local(origin=self, other))."""
        xi = se3.boxminus(other.pose(), self.pose())
        return torch.cat([xi, other.vel - self.vel], dim=-1)


class PoseVelBiasState(NamedTuple):
    """dim 15 per step: [pose(6), vel(6), bias(3)]."""

    q: torch.Tensor
    p: torch.Tensor
    vel: torch.Tensor
    bias: torch.Tensor  # (T, 3) translational (GPS) bias

    DIM = 15

    @staticmethod
    def identity(T: int, dtype=torch.float64,
                 device=None) -> "PoseVelBiasState":
        q = so3.quat_identity((T,), dtype, device)
        return PoseVelBiasState(q=q, p=_zeros(T, 3, dtype, q.device),
                                vel=_zeros(T, 6, dtype, q.device),
                                bias=_zeros(T, 3, dtype, q.device))

    def pose(self) -> SE3:
        return SE3(q=self.q, t=self.p)

    def retract(self, dx: torch.Tensor) -> "PoseVelBiasState":
        new_pose = se3.boxplus(self.pose(), dx[:, 0:6])
        return PoseVelBiasState(
            q=new_pose.q,
            p=new_pose.t,
            vel=self.vel + dx[:, 6:12],
            bias=self.bias + dx[:, 12:15],
        )

    def local(self, other: "PoseVelBiasState") -> torch.Tensor:
        xi = se3.boxminus(other.pose(), self.pose())
        return torch.cat(
            [xi, other.vel - self.vel, other.bias - self.bias], dim=-1
        )


class PoseVelAccBiasState(NamedTuple):
    """dim 21 per step: [pose(6), vel(6), accel(6), bias(3)]
    (pose_vel_acc_bias.hpp layout)."""

    q: torch.Tensor
    p: torch.Tensor
    vel: torch.Tensor
    accel: torch.Tensor  # (T, 6)
    bias: torch.Tensor  # (T, 3)

    DIM = 21

    @staticmethod
    def identity(T: int, dtype=torch.float64,
                 device=None) -> "PoseVelAccBiasState":
        q = so3.quat_identity((T,), dtype, device)
        return PoseVelAccBiasState(
            q=q,
            p=_zeros(T, 3, dtype, q.device),
            vel=_zeros(T, 6, dtype, q.device),
            accel=_zeros(T, 6, dtype, q.device),
            bias=_zeros(T, 3, dtype, q.device),
        )

    def pose(self) -> SE3:
        return SE3(q=self.q, t=self.p)

    def retract(self, dx: torch.Tensor) -> "PoseVelAccBiasState":
        new_pose = se3.boxplus(self.pose(), dx[:, 0:6])
        return PoseVelAccBiasState(
            q=new_pose.q,
            p=new_pose.t,
            vel=self.vel + dx[:, 6:12],
            accel=self.accel + dx[:, 12:18],
            bias=self.bias + dx[:, 18:21],
        )

    def local(self, other: "PoseVelAccBiasState") -> torch.Tensor:
        xi = se3.boxminus(other.pose(), self.pose())
        return torch.cat(
            [
                xi,
                other.vel - self.vel,
                other.accel - self.accel,
                other.bias - self.bias,
            ],
            dim=-1,
        )
