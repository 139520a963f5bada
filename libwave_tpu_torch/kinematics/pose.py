"""Position + orientation record (port of ``libwave_tpu.kinematics.pose``).

The reference's ``Pose`` (wave_kinematics/include/wave/kinematics/
pose.hpp:21 {Vec3 position, Quaternion orientation}), with its accessor
names.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libwave_tpu_torch.geometry import so3


class Pose(NamedTuple):
    position: torch.Tensor  # (..., 3)
    orientation: torch.Tensor  # (..., 4) quaternion [w, x, y, z]

    def rotation_matrix(self) -> torch.Tensor:
        return so3.quat_to_rot(self.orientation)

    @staticmethod
    def identity(shape=(), dtype=torch.float32, device=None) -> "Pose":
        q = so3.quat_identity(shape, dtype, device)
        return Pose(position=q.new_zeros(tuple(shape) + (3,)), orientation=q)
