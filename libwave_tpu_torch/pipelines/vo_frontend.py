"""Two-frame visual-odometry front end: detect -> describe -> match -> pose
(port of ``libwave_tpu.pipelines.vo_frontend``; BASELINE.md measurement
config (1), "two-frame FAST+BRISK match + essential pose").

    detect_fast (dense FAST, NMS, top-N; vision.detector)
      -> brisk_describe (vision.descriptor)
      -> match_descriptors (the top-2 kernel on the card + ratio test)
      -> find_fundamental_ransac -> essential_from_fundamental
      -> recover_pose (vision.epipolar)

RANSAC draws its samples from a ``torch.Generator`` where the reference
takes a ``key``; the matcher's and the epipolar stage's draws come from the
same generator, one after the other.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.vision.descriptor import BRISKParams, brisk_describe
from libwave_tpu_torch.vision.detector import FASTParams, detect_fast
from libwave_tpu_torch.vision.epipolar import (
    essential_from_fundamental,
    recover_pose,
)
from libwave_tpu_torch.vision.matcher import (
    MatcherParams,
    find_fundamental_ransac,
    match_descriptors,
)

__all__ = ["VOFrontendConfig", "TwoFrameResult", "two_frame_pose"]


@dataclass(frozen=True)
class VOFrontendConfig:
    fast: FASTParams = field(default_factory=FASTParams)
    brisk: BRISKParams = field(default_factory=BRISKParams)
    matcher: MatcherParams = field(
        # RANSAC runs once on the epipolar stage below; skip the matcher's
        # built-in outlier pass so the fundamental matrix is estimated from
        # ratio-test survivors exactly once.
        default_factory=lambda: MatcherParams(auto_remove_outliers=False)
    )
    ransac_reproj_px: float = 2.0
    ransac_hypotheses: int = 512


class TwoFrameResult(NamedTuple):
    T_21: SE3                 # camera-1 -> camera-2, ‖t‖ = 1
    xy1: torch.Tensor         # (N, 2) keypoints in frame 1
    xy2: torch.Tensor         # (N, 2) matched points in frame 2
    inliers: torch.Tensor     # (N,) final epipolar+cheirality inliers
    E: torch.Tensor           # (3, 3) essential matrix
    diagnostics: dict         # raw/filtered/good match counts, votes


def two_frame_pose(
    img1: torch.Tensor,
    img2: torch.Tensor,
    K: torch.Tensor,
    generator: torch.Generator | None = None,
    config: VOFrontendConfig = VOFrontendConfig(),
) -> TwoFrameResult:
    """Relative camera pose between two grayscale frames (float or uint8
    images on one device; ``K`` (3, 3)). Returns motion up to monocular
    scale: X_cam2 = R X_cam1 + t, ‖t‖ = 1."""
    img1 = img1.to(torch.float32)
    img2 = img2.to(torch.float32)
    xy1, _, m1 = detect_fast(img1, config.fast)
    xy2, _, m2 = detect_fast(img2, config.fast)
    d1, m1 = brisk_describe(img1, xy1, m1, config.brisk)
    d2, m2 = brisk_describe(img2, xy2, m2, config.brisk)

    idx2, valid, diag = match_descriptors(
        d1, d2, xy1, xy2, m1, m2, generator, config.matcher
    )
    p1 = xy1.to(torch.float32)
    p2 = xy2[idx2].to(torch.float32)

    F, inl = find_fundamental_ransac(
        p1, p2, valid, generator,
        reproj_px=config.ransac_reproj_px,
        num_hypotheses=config.ransac_hypotheses,
    )
    K = torch.as_tensor(K, dtype=torch.float32, device=p1.device)
    E = essential_from_fundamental(F, K)
    T_21, cheir, votes = recover_pose(E, p1, p2, K, inl)
    diag = dict(diag)
    diag["num_epipolar_inliers"] = torch.sum(inl)
    diag["cheirality_votes"] = votes
    return TwoFrameResult(
        T_21=T_21, xy1=p1, xy2=p2, inliers=inl & cheir, E=E,
        diagnostics=diag,
    )
