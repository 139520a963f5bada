"""Gaussian-process INSAC ground segmentation.

Port of ``libwave_tpu.matching.ground_segmentation``: the cloud's points
go into polar bins (``num_bins_a`` sectors x ``num_bins_l`` range bins),
each bin keeps its lowest point and mean range, and every sector grows its
ground model by a fixed number of masked GP regressions. The sectors are
one batch of ``(L, L)`` systems solved with ``solve_ex`` (no host check of
the factorization). Clouds may carry leading batch dimensions.

The per-bin range sums run over the bin-sorted order with fixed-order
segment sums (:func:`~libwave_tpu_torch.matching.pointcloud.
sorted_segment_sum`), so two runs label the same.

The masked GP takes the model mask as a select: a bin outside the model
contributes 0 to the right-hand side and to the weights. That is what the
JAX package computes inside its compiled INSAC loop and under ``jax.jit``;
called without ``jit``, its final prediction multiplies an empty bin's
``inf`` height by 0 and turns every sector with an empty bin to NaN
(ROADMAP.md §C).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from libwave_tpu_torch.matching.pointcloud import (
    PointCloud,
    div,
    sorted_segment_sum,
)
from libwave_tpu_torch.utils.config import ConfigError
from libwave_tpu_torch.utils.precision import f32_matmuls

_BIG = 1e8

# point labels
GROUND = 0
OBSTACLE = 1
DRIVABLE = 2
UNLABELED = -1


@dataclasses.dataclass(frozen=True)
class GroundSegmentationParams:
    """ground_segmentation_params.hpp:9-60 parity."""

    rmax: float = 100.0
    max_bin_points: int = 200
    num_seed_points: int = 10
    p_l: float = 4.0
    p_sf: float = 1.0
    p_sn: float = 0.3
    p_tmodel: float = 5.0
    p_tdata: float = 5.0
    p_tg: float = 0.3
    robot_height: float = 1.2
    max_seed_range: float = 50.0
    max_seed_height: float = 15.0
    num_bins_a: int = 72
    num_bins_l: int = 200
    insac_iterations: int = 10  # fixed INSAC growth rounds (converges fast)
    min_bin_points: int = 5  # reference requires > 5 points per signal bin

    def validate(self):
        if self.num_bins_a <= 0 or self.num_bins_l <= 0:
            raise ConfigError("bin counts must be positive")
        if self.rmax <= 0:
            raise ConfigError("rmax must be positive")


class GroundSegmentationResult(NamedTuple):
    labels: torch.Tensor  # (..., N) int32: GROUND/OBSTACLE/DRIVABLE/UNLABELED
    ground_mask: torch.Tensor  # (..., N)
    obstacle_mask: torch.Tensor  # (..., N)
    drivable_mask: torch.Tensor  # (..., N)


def _sq_exp(r1, r2, p_sf, p_l):
    d = r1[..., :, None] - r2[..., None, :]
    return p_sf * torch.exp(div(-(d * d), 2.0 * p_l * p_l))


def _bin_signals(cloud: PointCloud, params: GroundSegmentationParams):
    """Each point's polar bin (A * L for points out of range) and each
    bin's lowest z, mean range and point count, (B, A * L + 1) each."""
    pts = cloud.points.reshape(-1, cloud.capacity, 3)
    mask = cloud.mask.reshape(-1, cloud.capacity)
    A, L = params.num_bins_a, params.num_bins_l
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    rng = torch.sqrt(x * x + y * y)
    ang = torch.atan2(y, x)  # [-pi, pi)
    in_range = mask & (rng < params.rmax)
    sector = torch.clamp(
        (div(ang + math.pi, 2 * math.pi) * A).to(torch.int32), 0, A - 1)
    lin = torch.clamp((div(rng, params.rmax) * L).to(torch.int32), 0, L - 1)
    bin_id = torch.where(in_range, sector * L + lin, A * L).to(torch.int64)

    nb = A * L + 1
    # prototype per bin: the lowest-z point (reference range_height_signal)
    bin_min_z = torch.full(bin_id.shape[:-1] + (nb,), math.inf,
                           dtype=pts.dtype, device=pts.device)
    bin_min_z = bin_min_z.scatter_reduce(
        -1, bin_id, torch.where(in_range, z, math.inf), "amin",
        include_self=False)
    # counts and range sums over the bin-sorted order
    sorted_bin, order = torch.sort(bin_id, dim=-1, stable=True)
    inr = torch.take_along_dim(in_range, order, dim=-1)
    sums = sorted_segment_sum(torch.stack(
        [inr.to(pts.dtype),
         torch.take_along_dim(torch.where(in_range, rng, 0.0), order, -1)],
        dim=-1), sorted_bin, nb)
    bin_count = sums[..., 0]
    # prototype range: mean range per bin (bins are narrow; the reference
    # uses the lowest point's range — the difference is < rmax/L)
    bin_rng = sums[..., 1] / torch.clamp(bin_count, min=1.0)
    return bin_id, in_range, z, bin_min_z, bin_count, bin_rng


def _gp_predict(h, r, model, params):
    """Masked GP regression of every sector, (S, L) each: prediction and
    predictive variance at every bin from the model bins."""
    m = model.to(h.dtype)
    K = _sq_exp(r, r, params.p_sf, params.p_l)
    A_mat = K * (m[..., :, None] * m[..., None, :]) + torch.diag_embed(
        params.p_sn + _BIG * (1.0 - m))
    rhs = torch.stack([torch.where(model, h, 0.0)], dim=-1)
    alpha = torch.linalg.solve_ex(A_mat, rhs).result[..., 0]
    f = (K @ (alpha * m)[..., None])[..., 0]
    # predictive variance diag: p_sf - diag(K_sm A^-1 K_ms), one multi-RHS
    # solve instead of L separate solves
    X = torch.linalg.solve_ex(A_mat, K * m[..., :, None]).result
    vf = params.p_sf - torch.sum((K * m[..., None, :]) * X.transpose(-1, -2),
                                 dim=-1)
    return f, vf


def _sector_insac(h, r, valid, params):
    """Every sector at once: (model (S, L), f_s (S, L), model_ok (S,))."""
    # seeds: the num_seed_points lowest valid signal points within
    # seeding bounds (impl:150-180)
    seedable = valid & (r < params.max_seed_range) \
        & (torch.abs(h) < params.max_seed_height)
    order = torch.argsort(torch.where(seedable, h, math.inf), dim=-1,
                          stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    model = seedable & (rank < params.num_seed_points)
    model_ok = torch.sum(model.to(torch.int32), dim=-1) >= 2
    for _ in range(params.insac_iterations):
        f, vf = _gp_predict(h, r, model, params)
        met = (h - f) / torch.sqrt(params.p_sn + vf * vf)
        inlier = valid & ~model & (vf < params.p_tmodel) \
            & (torch.abs(met) < params.p_tdata)
        model = model | inlier
    f_s, _ = _gp_predict(h, r, model, params)
    return model, f_s, model_ok


@f32_matmuls
def segment_ground(cloud: PointCloud,
                   params: GroundSegmentationParams = GroundSegmentationParams()
                   ) -> GroundSegmentationResult:
    """Label every point ground / obstacle / drivable-overhanging."""
    A, L = params.num_bins_a, params.num_bins_l
    bin_id, in_range, z, bin_min_z, bin_count, bin_rng = _bin_signals(
        cloud, params)
    sig_h = bin_min_z[..., : A * L].reshape(-1, L)
    sig_r = bin_rng[..., : A * L].reshape(-1, L)
    sig_valid = (bin_count[..., : A * L] > params.min_bin_points).reshape(-1, L)
    model, f_s, model_ok = _sector_insac(sig_h, sig_r, sig_valid, params)

    # classify every point from its bin's status (impl:292-355)
    B = bin_id.shape[0]
    flat_model = model.reshape(B, A * L)
    flat_f = f_s.reshape(B, A * L)
    flat_h = sig_h.reshape(B, A * L)
    flat_ok = model_ok.reshape(B, A).repeat_interleave(L, dim=-1)

    safe_bin = torch.clamp(bin_id, 0, A * L - 1)

    def at(v):
        return torch.take_along_dim(v, safe_bin, dim=-1)

    p_in_model = at(flat_model) & in_range
    p_ok = at(flat_ok)
    # model bins compare to prototype height, others to GP prediction
    ref_height = torch.where(p_in_model, at(flat_h), at(flat_f))
    dh = torch.abs(z - ref_height)

    is_ground = p_in_model & (dh < params.p_tg)
    is_drv = ~is_ground & (dh > params.robot_height) & in_range & p_ok
    is_obs = ~is_ground & ~is_drv & in_range & p_ok
    labels = torch.where(
        is_ground, GROUND,
        torch.where(is_drv, DRIVABLE, torch.where(is_obs, OBSTACLE,
                                                  UNLABELED)),
    ).to(torch.int32)
    shape = cloud.mask.shape
    return GroundSegmentationResult(
        labels=labels.reshape(shape),
        ground_mask=is_ground.reshape(shape),
        obstacle_mask=is_obs.reshape(shape),
        drivable_mask=is_drv.reshape(shape),
    )
