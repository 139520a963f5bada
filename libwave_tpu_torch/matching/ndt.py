"""NDT (Normal Distributions Transform) scan registration.

Port of ``libwave_tpu.matching.ndt``, batched over leading dimensions as
:mod:`~libwave_tpu_torch.matching.icp` is. The target's voxel Gaussians
(mean and eigenvalue-floored covariance per cell) come from the same
stable sort and fixed-order segment sums as the voxel filter, so two runs
give the same bits; each Gauss-Newton trip looks every moved point's cell
up in the sorted key table (``torch.searchsorted``), reduces a 6x6 normal
system, and takes the best of three step lengths, chosen with
``torch.where`` on the device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.matching.icp import initial_transform
from libwave_tpu_torch.matching.loop import converged_scan, select
from libwave_tpu_torch.matching.pointcloud import (
    INT32_MAX,
    PointCloud,
    _voxel_hash,
    eigh3,
    gather_points,
    sort_segments,
    sorted_segment_sum,
)
from libwave_tpu_torch.utils.config import ConfigError
from libwave_tpu_torch.utils.precision import f32_matmuls

_MIN_RES = 0.05  # ndt.hpp floor
_EMPTY = INT32_MAX


@dataclasses.dataclass(frozen=True)
class NDTParams:
    step_size: float = 3.0
    res: float = 5.0
    max_iter: int = 100
    t_eps: float = 1e-8
    min_points_per_cell: int = 5

    def validate(self):
        if self.res < _MIN_RES:
            raise ConfigError(f"NDT resolution must be >= {_MIN_RES}")
        if self.max_iter <= 0:
            raise ConfigError("max_iter must be positive")


class NDTGrid(NamedTuple):
    """Voxel Gaussian table, keys sorted for ``searchsorted``."""

    keys: torch.Tensor  # (..., V) int32 voxel hash (sentinel for empty)
    means: torch.Tensor  # (..., V, 3)
    inv_covs: torch.Tensor  # (..., V, 3, 3)
    valid: torch.Tensor  # (..., V)


def build_ndt_grid(cloud: PointCloud, res: float,
                   min_points: int = 5) -> NDTGrid:
    """Per-voxel mean + covariance via sort/segment reductions; covariance
    eigenvalues floored at 1e-2 * max-eig (Magnusson regularization)."""
    N = cloud.capacity
    dtype = cloud.points.dtype
    key = torch.where(cloud.mask, _voxel_hash(cloud.points, res), _EMPTY)
    order, hs, vs, first, seg = sort_segments(key, cloud.mask)
    ps = torch.take_along_dim(cloud.points, order[..., None], dim=-2)
    w = vs.to(dtype)
    outer = (ps[..., :, None] * ps[..., None, :]).flatten(-2)
    sums = sorted_segment_sum(
        torch.cat([w[..., None], ps * w[..., None], outer * w[..., None]],
                  dim=-1), seg, N)
    cnt = torch.clamp(sums[..., 0], min=1.0)
    mean = sums[..., 1:4] / cnt[..., None]
    cov = sums[..., 4:].unflatten(-1, (3, 3)) / cnt[..., None, None] \
        - mean[..., :, None] * mean[..., None, :]
    vals, vecs = eigh3(cov)
    floor = 1e-2 * torch.clamp(vals[..., 2:3], min=1e-6)
    vals = torch.maximum(vals, floor)
    inv_cov = (vecs * (1.0 / vals)[..., None, :]) @ vecs.transpose(-1, -2)

    # each segment's key is its first element's hash: exact in int64
    cell_key = sorted_segment_sum(
        torch.where(first, hs, 0).to(torch.int64)[..., None], seg, N)[..., 0]
    in_range = torch.arange(N, device=seg.device) \
        < first.to(torch.int64).sum(-1, keepdim=True)
    # keys stay ascending for searchsorted; under-populated cells keep
    # their key and are rejected through ``valid`` at lookup
    return NDTGrid(
        keys=torch.where(in_range, cell_key, _EMPTY).to(torch.int32),
        means=mean,
        inv_covs=inv_cov,
        valid=in_range & (sums[..., 0] >= min_points),
    )


def _lookup(grid: NDTGrid, pts: torch.Tensor, res: float):
    """Each point's cell, by searching the sorted key table."""
    h = _voxel_hash(pts, res)
    idx = torch.searchsorted(grid.keys, h)
    idx = torch.clamp(idx, 0, grid.keys.shape[-1] - 1)
    hit = (torch.take_along_dim(grid.keys, idx, dim=-1) == h) \
        & torch.take_along_dim(grid.valid, idx, dim=-1)
    return idx, hit


class NDTResult(NamedTuple):
    transform: SE3
    converged: torch.Tensor
    iterations: torch.Tensor
    information: torch.Tensor  # (..., 6, 6) — identity, ndt.hpp default


@f32_matmuls
def ndt_match(ref: PointCloud, target: PointCloud,
              params: NDTParams = NDTParams(),
              init: SE3 | None = None) -> NDTResult:
    """Register ref onto target: GN on the point-to-distribution Mahalanobis
    cost over the target's NDT grid."""
    dtype = ref.points.dtype
    grid = build_ndt_grid(target, params.res, params.min_points_per_cell)
    T0 = initial_transform(ref, init)
    eye3 = torch.eye(3, dtype=dtype, device=ref.points.device)
    eye6 = torch.eye(6, dtype=dtype, device=ref.points.device)
    cap = params.step_size

    def score_terms(T):
        """Per-point residual, inverse covariance and Gaussian score
        weight (Magnusson: the NDT objective saturates)."""
        R = T.rotation()[..., None, :, :]
        moved = (R @ ref.points[..., None])[..., 0] + T.t[..., None, :]
        idx, hit = _lookup(grid, moved, params.res)
        w = (ref.mask & hit).to(dtype)
        r = moved - gather_points(grid.means, idx)
        Wm = gather_points(grid.inv_covs.flatten(-2), idx).unflatten(-1,
                                                                     (3, 3))
        m2 = torch.einsum("...ni,...nij,...nj->...n", r, Wm, r)
        score_w = torch.exp(-0.5 * torch.clamp(m2, max=40.0))
        return moved, r, Wm, w * score_w

    def cost_of(T):
        # NDT score: sum of -exp(-m2/2) over in-grid points
        return -torch.sum(score_terms(T)[3], dim=-1)

    def body(T):
        moved, r, Wm, w = score_terms(T)
        J = torch.cat([-so3.hat(moved), eye3.expand(moved.shape + (3,))],
                      dim=-1)  # (..., N, 3, 6); moved' = exp(w)^ moved + v
        JtW = J.transpose(-1, -2) @ Wm
        H = torch.einsum("...njk,...nkl,...n->...jl", JtW, J, w)
        g = torch.einsum("...njk,...nk,...n->...j", JtW, r, w)
        dx = torch.linalg.solve_ex(H + 1e-6 * eye6,
                                   -g[..., None]).result[..., 0]
        norm = torch.linalg.vector_norm(dx, dim=-1, keepdim=True)
        dx = dx * torch.clamp(cap / torch.clamp(norm, min=1e-12), max=1.0)

        # backtracking line search on the NDT score (More-Thuente
        # stand-in): the best of three steps, kept only if it improves
        c0 = -torch.sum(w, dim=-1)
        cands = []
        for alpha in (1.0, 0.5, 0.25):
            d = alpha * dx
            Tn = SE3(q=so3.exp_quat(d[..., 0:3]), t=d[..., 3:6]) \
                .compose(T).normalize()
            cands.append((Tn, cost_of(Tn)))
        costs = torch.stack([c for _, c in cands], dim=-1)
        best = torch.argmin(costs, dim=-1)
        improved = torch.take_along_dim(costs, best[..., None], dim=-1)[
            ..., 0] < c0
        Tn = select(best == 0, cands[0][0],
                    select(best == 1, cands[1][0], cands[2][0]))
        step = torch.where(improved, torch.sum(dx * dx, dim=-1), 0.0)
        return select(improved, Tn, T), step

    live = torch.ones(T0.t.shape[:-1], dtype=torch.bool,
                      device=ref.points.device)
    T, iters = converged_scan(body, T0, params.max_iter, params.t_eps, live)
    return NDTResult(
        transform=T,
        converged=iters < params.max_iter,
        iterations=iters,
        information=eye6.expand(iters.shape + (6, 6)),
    )
