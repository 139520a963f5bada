"""Dataset loaders (port of ``libwave_tpu.datasets``: the EuRoC ASL reader
and the KITTI odometry loaders)."""

from libwave_tpu_torch.datasets.euroc import (  # noqa: F401
    EUROC_CAM0_K,
    EurocGroundTruth,
    EurocImu,
    load_euroc_camera_index,
    load_euroc_ground_truth,
    load_euroc_imu,
    load_euroc_tracks,
)
from libwave_tpu_torch.datasets.kitti import (  # noqa: F401
    load_kitti_poses,
    load_kitti_times,
    load_kitti_velodyne,
)
