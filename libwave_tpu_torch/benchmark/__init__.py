"""Trajectory metrics (port of ``libwave_tpu.benchmark``)."""

from libwave_tpu_torch.benchmark.trajectory import (  # noqa: F401
    Trajectory,
    absolute_trajectory_error,
    align_trajectories_umeyama,
    interpolate_at,
    pose_error,
    relative_pose_error,
    trajectory_error,
    write_error_csv,
)
