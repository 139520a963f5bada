"""Rotation algebra, frame conventions and uncertain poses (port of
``libwave_tpu.geometry``)."""

from libwave_tpu_torch.geometry import euler, frames, se3, so3  # noqa: F401
from libwave_tpu_torch.geometry.pose_cov import (  # noqa: F401
    PoseWithCovariance,
    compose_pose_with_covariance,
)
from libwave_tpu_torch.geometry.se3 import SE3  # noqa: F401
