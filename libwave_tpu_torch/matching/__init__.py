"""Lidar scan registration (port of ``libwave_tpu.matching``).

ICP/GICP/NDT with voxel-grid downsampling, multiscale schedules and
LUM/Censi information matrices, and GP-INSAC ground segmentation. Every
matcher takes clouds with a leading batch dimension (``(B, N, 3)`` points,
``(B, N)`` masks) or without one, and returns results with the same.
"""

from libwave_tpu_torch.matching.pointcloud import (  # noqa: F401
    PointCloud,
    make_cloud,
    transform_cloud,
    voxel_downsample,
    synthetic_scan,
)
from libwave_tpu_torch.matching.knn import nearest_neighbor, knn  # noqa: F401
from libwave_tpu_torch.matching.icp import (  # noqa: F401
    ICPParams,
    ICPResult,
    icp_match,
    estimate_info_lum,
    estimate_info_censi,
)
from libwave_tpu_torch.matching.gicp import GICPParams, gicp_match  # noqa: F401
from libwave_tpu_torch.matching.ndt import NDTParams, ndt_match  # noqa: F401
from libwave_tpu_torch.matching.multi import (  # noqa: F401
    multi_match,
    multi_match_sharded,
)
from libwave_tpu_torch.matching.ground_segmentation import (  # noqa: F401
    GROUND,
    OBSTACLE,
    DRIVABLE,
    UNLABELED,
    GroundSegmentationParams,
    segment_ground,
)
