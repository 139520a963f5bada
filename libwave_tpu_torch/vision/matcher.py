"""Descriptor matching: Hamming brute force, ratio/distance filters, RANSAC
(port of ``libwave_tpu.vision.matcher``).

The knn ratio test takes the per-row top-2 of the Hamming distances. With
``use_fused_top2=None`` the choice follows the tensors' device, the split the
reference makes between its TPU and its CPU: CUDA tensors go through the
fused top-2 kernel (``ops.hamming.hamming_top2``, no (N1, N2) table), CPU
tensors through the distance matrix. The distance heuristic needs the whole
matrix (for the cross check), which on CUDA is the table kernel
(``ops.hamming.hamming_distance``) with the masks applied after.

RANSAC is batched-hypothesis as in the reference: all hypotheses' 8-point
samples are solved in one batched ``eigh``/``svd``, scored by Sampson
distance, and the winner is refined on its inliers. Samples are drawn from a
``torch.Generator`` (gumbel-max over the valid rows); the reference draws
from ``jax.random`` keys, so the bits differ, and ``sample_idx`` lets a
caller hand both the same (H, 8) samples. ``method="lsh"`` generates the
candidates with the multi-table LSH index of ``vision.flann`` instead.

``match_descriptors`` and ``find_fundamental_ransac`` also take banks with a
leading batch dimension (B sequences' frames, ``track_sequences_batched``):
the ratio test runs on the whole batch, the top-2 kernel (or the LSH index)
and RANSAC once per sequence, each with its own generator.
"""

from __future__ import annotations

import dataclasses

import torch

from libwave_tpu_torch.ops import hamming
from libwave_tpu_torch.utils.config import ConfigError
from libwave_tpu_torch.utils.precision import f32_matmuls, per_item
from libwave_tpu_torch.vision.detector import top_k_stable
from libwave_tpu_torch.vision.flann import (
    FLANNParams,
    build_lsh_index,
    lsh_match,
)

_BIG = hamming.BIG


@dataclasses.dataclass(frozen=True)
class MatcherParams:
    """brute_force_matcher.hpp:20-145 parameter parity."""

    use_knn: bool = True
    ratio_threshold: float = 0.8
    distance_threshold: float = 5.0
    cross_check: bool = False  # used with the distance heuristic (OpenCV BF)
    auto_remove_outliers: bool = True
    fm_method: str = "ransac"  # "ransac" | "8point" | "lmeds"
    ransac_reproj_px: float = 3.0
    ransac_hypotheses: int = 256
    # None = by device: the fused top-2 kernel for CUDA tensors, the matrix
    # path for CPU tensors; False forces the matrix path
    use_fused_top2: bool = None
    # "exact" = full Hamming; "lsh" = the multi-table LSH index
    # (vision.flann), sub-linear candidates
    method: str = "exact"
    flann: object = None  # FLANNParams override, for method="lsh"

    def validate(self):
        if not 0 < self.ratio_threshold <= 1:
            raise ConfigError("ratio_threshold must be in (0, 1]")
        if self.distance_threshold < 0:
            raise ConfigError("distance_threshold is a negative value!")
        if self.fm_method not in ("ransac", "8point", "lmeds"):
            raise ConfigError("fm_method is not an acceptable value!")
        if self.method not in ("exact", "lsh"):
            raise ConfigError("method must be exact | lsh")


def hamming_distance_matrix(d1: torch.Tensor, d2: torch.Tensor, mask1=None,
                            mask2=None) -> torch.Tensor:
    """(N1, W) x (N2, W) int32 descriptor words -> (N1, N2) int32 Hamming
    distances; masked rows/cols get the sentinel ``1 << 24``."""
    dist = hamming.hamming_distance(d1, d2)
    big = torch.full((), _BIG, dtype=torch.int32, device=dist.device)
    if mask1 is not None:
        dist = torch.where(mask1[:, None], dist, big)
    if mask2 is not None:
        dist = torch.where(mask2[None, :], dist, big)
    return dist


def match_ratio_test(dist: torch.Tensor, ratio: float = 0.8):
    """Lowe ratio test on a distance matrix (knnMatch k=2 + filterMatches,
    brute_force_matcher.cpp:106-119).

    Returns (idx2 (N1,), valid (N1,)): best match per row (first occurrence
    among ties), accepted when best <= ratio * second.
    """
    neg = -dist.to(torch.float32)
    top2, idx = top_k_stable(neg, 2)
    best = -top2[..., 0]
    second = -top2[..., 1]
    valid = (best <= ratio * second) & (best < float(_BIG))
    return idx[..., 0], valid


def match_distance_heuristic(dist: torch.Tensor, threshold: float,
                             cross_check: bool = False):
    """Distance-heuristic filter (brute_force_matcher.cpp:87-101): keep the
    best match per row when d <= threshold * min_d over all matches;
    optional cross-check (mutual best)."""
    idx2 = torch.argmin(dist, dim=-1)
    best = torch.min(dist, dim=-1)[0]
    present = best < _BIG
    big = torch.full_like(best, _BIG)
    min_d = torch.amin(torch.where(present, best, big), dim=-1, keepdim=True)
    valid = present & (best <= threshold * torch.clamp(min_d, min=1))
    if cross_check:
        idx1_of_2 = torch.argmin(dist, dim=-2)  # best row per column
        rows = torch.arange(dist.shape[-2], device=dist.device)
        valid = valid & (torch.gather(idx1_of_2, -1, idx2) == rows)
    return idx2, valid


# ---------------------------------------------------------------------------
# Epipolar outlier rejection (cv::findFundamentalMat replacement)
# ---------------------------------------------------------------------------


def _normalize_points(pts: torch.Tensor, w: torch.Tensor):
    """Hartley normalization over weighted points (..., N, 2) with weights
    (..., N): zero mean, sqrt(2) RMS. Returns (normalized points, T)."""
    wsum = torch.sum(w, dim=-1) + 1e-9
    mean = torch.sum(pts * w[..., None], dim=-2) / wsum[..., None]
    d = torch.sqrt(torch.sum((pts - mean[..., None, :]) ** 2, dim=-1))
    scale = 2.0 ** 0.5 / (torch.sum(d * w, dim=-1) / wsum + 1e-9)
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    T = torch.stack(
        [
            torch.stack([scale, zero, -scale * mean[..., 0]], dim=-1),
            torch.stack([zero, scale, -scale * mean[..., 1]], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
    pn = (pts - mean[..., None, :]) * scale[..., None, None]
    return pn, T


def _eight_point(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor):
    """Weighted 8-point fundamental matrix from (..., N, 2) + (..., N, 2)
    with weights (..., N); any leading batch dimensions.

    The eigenvector of A^T W A with the smallest eigenvalue, then rank 2
    enforced. Returns (..., 3, 3) F with p2h^T F p1h = 0.
    """
    p1n, T1 = _normalize_points(p1, w)
    p2n, T2 = _normalize_points(p2, w)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    ones = torch.ones_like(x1)
    A = torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], dim=-1
    )
    AtA = (A * w[..., None]).transpose(-1, -2) @ A
    # symmetrized first, as jnp.linalg.eigh does
    _, vecs = torch.linalg.eigh((AtA + AtA.transpose(-1, -2)) / 2)
    F = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    # rank-2 enforcement
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    F = (U * S[..., None, :]) @ Vt
    return T2.transpose(-1, -2) @ F @ T1


def _sampson_distance(F: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """Squared Sampson distance (px^2) of every correspondence (N,) under
    each F (..., 3, 3): shape (..., N)."""
    ones = torch.ones(p1.shape[:-1] + (1,), dtype=p1.dtype, device=p1.device)
    x1 = torch.cat([p1, ones], dim=-1)
    x2 = torch.cat([p2, ones], dim=-1)
    Fx1 = x1 @ F.transpose(-1, -2)  # (..., N, 3) = F @ x1
    Ftx2 = x2 @ F  # (..., N, 3) = F^T @ x2
    num = torch.sum(x2 * Fx1, dim=-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / (den + 1e-12)


def _nanmedian_midpoint(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis ignoring NaNs, with numpy's rule (the mean
    of the two middle values when the count is even; NaN when no value):
    ``torch.nanmedian`` returns the lower middle value instead."""
    s = torch.sort(x, dim=-1)[0]  # NaNs sort last
    n = torch.sum(~torch.isnan(x), dim=-1, keepdim=True)
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), min=0)
    low = torch.gather(s, -1, lo)[..., 0]
    high = torch.gather(s, -1, hi)[..., 0]
    return (low + high) * 0.5


def ransac_samples(valid: torch.Tensor, num_hypotheses: int,
                   generator: torch.Generator | None, dtype=torch.float32):
    """(H, 8) row indices per hypothesis, biased to valid rows by gumbel-max:
    the 8 largest of a gumbel draw per row, invalid rows at -inf (ties in
    ascending index order)."""
    N = valid.shape[0]
    u = torch.rand((num_hypotheses, N), generator=generator, dtype=dtype,
                   device=valid.device)
    tiny = torch.finfo(dtype).tiny
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    scores = torch.where(valid[None, :], g, torch.full_like(g, -float("inf")))
    return top_k_stable(scores, 8)[1]


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, :]`` per batch: x (..., N, D), idx (..., *) -> (..., *, D)."""
    lead = x.shape[:-2]
    flat = idx.reshape(lead + (-1, 1)).expand(lead + (-1, x.shape[-1]))
    return torch.gather(x, -2, flat).reshape(idx.shape + x.shape[-1:])


@f32_matmuls
def find_fundamental_ransac(
    p1: torch.Tensor,
    p2: torch.Tensor,
    valid: torch.Tensor,
    generator=None,
    reproj_px: float = 3.0,
    num_hypotheses: int = 256,
    lmeds: bool = False,
    sample_idx: torch.Tensor | None = None,
):
    """Batched-hypothesis RANSAC (or LMedS) fundamental-matrix estimation.

    Every hypothesis solves the 8-point problem on 8 valid correspondences
    (drawn from ``generator``, or given as ``sample_idx`` (H, 8)), all in
    one batched eigendecomposition; all are scored at once and the winner is
    refined by a weighted 8-point solve on its inliers. Replaces
    cv::findFundamentalMat(FM_RANSAC, 3.0, 0.99) at
    brute_force_matcher.cpp:147. No index is read on the host.

    ``p1``, ``p2`` (B, N, 2) and ``valid`` (B, N) of B sequences take a
    list of B generators (and ``sample_idx`` (B, H, 8)): each sequence runs
    alone, as it would unbatched. cuSOLVER picks another eigensolver for a
    batch of matrices than for one, and cuBLAS may pick another GEMM, so a
    batched refinement would part from the sequence's own in the last bits.

    Returns (F (3, 3), inlier_mask (N,)), or (B, 3, 3) and (B, N).
    """
    if p1.dim() == 3:
        return per_item(
            lambda a, b, v, g, s: find_fundamental_ransac(
                a, b, v, g, reproj_px, num_hypotheses, lmeds, s),
            p1, p2, valid, generator, sample_idx)
    w = valid.to(p1.dtype)
    idx = sample_idx
    if idx is None:
        idx = ransac_samples(valid, num_hypotheses, generator, p1.dtype)
    idx = idx.to(device=p1.device, dtype=torch.int64)

    ww = torch.ones(idx.shape, dtype=p1.dtype, device=p1.device)
    Fs = _eight_point(p1[idx], p2[idx], ww)  # (H, 3, 3)
    d2 = _sampson_distance(Fs, p1, p2)  # (H, N)
    thresh = reproj_px * reproj_px
    if lmeds:
        # median of squared distances over valid correspondences
        ok = valid[None, :] & torch.isfinite(d2)
        med = _nanmedian_midpoint(
            torch.where(ok, d2, torch.full_like(d2, float("nan"))))
        best = torch.argmin(med).reshape(1)
        # LMedS inliers: within 2.5 * robust sigma
        sigma2 = 2.1981 * med[best]
        inliers = valid & (d2[best][0] < 6.25 * sigma2)
    else:
        inl = (d2 < thresh) & valid[None, :]
        counts = torch.sum(inl, dim=1)
        # a 1-element index tensor: a 0-d one would be read on the host
        best = torch.argmax(counts).reshape(1)
        inliers = inl[best][0]

    # refine on inliers with weighted 8-point
    F = _eight_point(p1, p2, inliers.to(p1.dtype))
    final_inliers = valid & (_sampson_distance(F, p1, p2) < thresh)
    return F, final_inliers


def match_descriptors(
    desc1, desc2, xy1, xy2, mask1, mask2, generator=None,
    params: MatcherParams = MatcherParams(), sample_idx=None,
):
    """Full matching pipeline (matchDescriptors,
    brute_force_matcher.cpp:160-207): Hamming distances (or LSH candidates)
    -> knn-ratio or distance filter -> optional epipolar outlier rejection.

    Returns (idx2 (N1,), valid (N1,), diagnostics dict). Row i of image-1
    keypoints matches xy2[idx2[i]] where valid. ``sample_idx`` (H, 8) fixes
    the RANSAC samples (see :func:`find_fundamental_ransac`). Banks with a
    leading batch dimension (B, N, W) take a list of B generators and give
    (B, N1) outputs and per-sequence counts, each sequence as it would
    alone.
    """
    fused = (
        params.use_fused_top2
        if params.use_fused_top2 is not None
        else desc1.device.type == "cuda"
    )
    batched = desc1.dim() == 3
    if params.method == "lsh":
        if params.flann is not None:
            # a user-supplied FLANNParams is authoritative, its
            # ratio_threshold included
            fp = params.flann
        else:
            fp = dataclasses.replace(
                FLANNParams(), ratio_threshold=params.ratio_threshold
            )

        def lsh(d1, d2, m1, m2):
            idx2, valid, diag = lsh_match(d1, m1, build_lsh_index(d2, m2, fp),
                                          fp)
            return idx2.to(torch.int64), valid, diag["num_candidates"]

        if batched:
            idx2, valid, num_candidates = per_item(
                lsh, desc1, desc2, mask1, mask2)
        else:
            idx2, valid, num_candidates = lsh(desc1, desc2, mask1, mask2)
    elif params.use_knn and fused:
        if batched:
            best, second, idx2 = per_item(hamming.hamming_top2, desc1,
                                               desc2, mask2)
        else:
            best, second, idx2 = hamming.hamming_top2(desc1, desc2, mask2)
        valid = (
            (best.to(torch.float32)
             <= params.ratio_threshold * second.to(torch.float32))
            & (best < _BIG)
        )
        idx2 = idx2.to(torch.int64)
    else:
        if batched:
            dist = per_item(hamming_distance_matrix,
                            desc1, desc2, mask1, mask2)
        else:
            dist = hamming_distance_matrix(desc1, desc2, mask1, mask2)
        if params.use_knn:
            idx2, valid = match_ratio_test(dist, params.ratio_threshold)
        else:
            idx2, valid = match_distance_heuristic(
                dist, params.distance_threshold, params.cross_check
            )
    valid = valid & mask1
    num_filtered = torch.sum(valid, dim=-1)

    if params.auto_remove_outliers:
        _, inliers = find_fundamental_ransac(
            xy1, _rows(xy2, idx2), valid, generator,
            reproj_px=params.ransac_reproj_px,
            num_hypotheses=params.ransac_hypotheses,
            lmeds=params.fm_method == "lmeds",
            sample_idx=sample_idx,
        )
        valid = valid & inliers

    diagnostics = {
        "num_raw_matches": torch.sum(mask1, dim=-1),
        "num_filtered_matches": num_filtered,
        "num_good_matches": torch.sum(valid, dim=-1),
    }
    if params.method == "lsh":
        # candidate-budget evidence (sub-linear generation) rides along
        diagnostics["num_candidates"] = num_candidates
    return idx2, valid, diagnostics
