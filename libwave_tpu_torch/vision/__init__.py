"""Visual front end (port of ``libwave_tpu.vision``): FAST and ORB
detection, BRISK and rBRIEF description, Hamming matching (exact or LSH)
with the ratio test and RANSAC, float-descriptor matching (exact L2,
kd-forest, k-means, composite), two-view epipolar geometry, the
fixed-capacity feature tracker, the pinhole camera and PNG image
sequences."""

from libwave_tpu_torch.vision.camera import (  # noqa: F401
    backproject,
    focal_length,
    in_image,
    pinhole_project,
    pinhole_project_frames,
)
from libwave_tpu_torch.vision.descriptor import (  # noqa: F401
    BRISKParams,
    ORBDescriptorParams,
    brisk_describe,
    orb_describe,
    orb_describe_pyramid,
)
from libwave_tpu_torch.vision.detector import (  # noqa: F401
    FASTParams,
    ORBDetectorParams,
    build_pyramid,
    detect_fast,
    detect_orb,
    detect_orb_pyramid,
    fast_score,
    harris_score,
    orb_orientation,
)
from libwave_tpu_torch.vision.epipolar import (  # noqa: F401
    decompose_essential,
    essential_from_fundamental,
    recover_pose,
    triangulate,
)
from libwave_tpu_torch.vision.flann import (  # noqa: F401
    FLANNParams,
    LSHIndex,
    build_lsh_index,
    lsh_match,
)
from libwave_tpu_torch.vision.flann_float import (  # noqa: F401
    FloatIndex,
    FloatIndexParams,
    build_float_index,
    exact_l2_top2,
    float_match,
)
from libwave_tpu_torch.vision.images import (  # noqa: F401
    list_image_sequence,
    load_image,
    read_image_sequence,
    save_png,
)
from libwave_tpu_torch.vision.matcher import (  # noqa: F401
    MatcherParams,
    find_fundamental_ransac,
    hamming_distance_matrix,
    match_descriptors,
    match_ratio_test,
)
from libwave_tpu_torch.vision.tracker import (  # noqa: F401
    TrackerParams,
    TrackerState,
    add_image_features,
    offline_tracker,
    tracker_init,
)
