"""Dataset loaders (port of ``libwave_tpu.datasets``' EuRoC ASL reader)."""

from libwave_tpu_torch.datasets.euroc import (  # noqa: F401
    EUROC_CAM0_K,
    EurocGroundTruth,
    EurocImu,
    load_euroc_camera_index,
    load_euroc_ground_truth,
    load_euroc_imu,
    load_euroc_tracks,
)
