"""Rotation algebra (port of ``libwave_tpu.geometry``)."""

from libwave_tpu_torch.geometry import euler, se3, so3  # noqa: F401
from libwave_tpu_torch.geometry.se3 import SE3  # noqa: F401
