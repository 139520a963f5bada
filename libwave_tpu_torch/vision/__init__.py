"""Visual front end (port of ``libwave_tpu.vision``'s FAST/BRISK/matcher/
tracker path): FAST detection, BRISK description, Hamming matching with the
ratio test and RANSAC, and the fixed-capacity feature tracker."""

from libwave_tpu_torch.vision.descriptor import (  # noqa: F401
    BRISKParams,
    ORBDescriptorParams,
    brisk_describe,
)
from libwave_tpu_torch.vision.detector import (  # noqa: F401
    FASTParams,
    ORBDetectorParams,
    detect_fast,
    fast_score,
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
