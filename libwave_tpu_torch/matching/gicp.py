"""Generalized ICP (plane-to-plane).

Port of ``libwave_tpu.matching.gicp``, batched over leading dimensions as
:mod:`~libwave_tpu_torch.matching.icp` is. Per-point covariances come from
k-NN neighbourhoods regularized to the GICP (eps, 1, 1) plane model, once
per cloud; each trip is a Gauss-Newton step on the Mahalanobis cost
``r_k = q_k - T p_k``, ``W_k = (C_q + R C_p R^T)^-1``. The per-point 3x3
inverses and the 6x6 solve go through ``inv_ex`` and ``solve_ex``, which
check nothing on the host, so the trips never wait for the card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.matching.icp import initial_transform
from libwave_tpu_torch.matching.knn import knn, nearest_neighbor
from libwave_tpu_torch.matching.loop import converged_scan
from libwave_tpu_torch.matching.pointcloud import (
    PointCloud,
    eigh3,
    gather_points,
    voxel_downsample,
)
from libwave_tpu_torch.utils.config import ConfigError
from libwave_tpu_torch.utils.precision import f32_matmuls


@dataclasses.dataclass(frozen=True)
class GICPParams:
    max_corr: float = 3.0
    max_iter: int = 50
    t_eps: float = 1e-8
    k_neighbors: int = 10  # corr_rand parity: neighborhood size
    plane_eps: float = 1e-3  # GICP epsilon along the normal
    res: float = 0.1

    def validate(self):
        if self.k_neighbors < 3:
            raise ConfigError("k_neighbors must be >= 3")
        if self.max_iter <= 0:
            raise ConfigError("max_iter must be positive")


def _point_covariances(cloud: PointCloud, k: int, eps: float):
    """GICP-regularized neighbourhood covariances: eigen-decompose the k-NN
    scatter and clamp its eigenvalues to (eps, 1, 1), smallest first."""
    idx, d2 = knn(cloud.points, cloud.mask, cloud.points, cloud.mask, k)
    nbrs = gather_points(cloud.points, idx)  # (..., N, k, 3)
    w = torch.isfinite(d2).to(cloud.points.dtype)
    cnt = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    mean = torch.sum(nbrs * w[..., None], dim=-2, keepdim=True) \
        / cnt[..., None]
    d = (nbrs - mean) * w[..., None]
    C = d.transpose(-1, -2) @ d / cnt[..., None]
    _, vecs = eigh3(C)
    # smallest eigenvalue -> eps (normal direction), the others -> 1
    clamped = torch.where(torch.arange(3, device=C.device) == 0, eps,
                          torch.ones(3, dtype=C.dtype, device=C.device))
    return (vecs * clamped) @ vecs.transpose(-1, -2)


class GICPResult(NamedTuple):
    transform: SE3
    converged: torch.Tensor
    iterations: torch.Tensor


@f32_matmuls
def gicp_match(ref: PointCloud, target: PointCloud,
               params: GICPParams = GICPParams(),
               init: SE3 | None = None) -> GICPResult:
    dtype = ref.points.dtype
    if params.res > 0:
        ref = voxel_downsample(ref, params.res)
        target = voxel_downsample(target, params.res)
    Cp = _point_covariances(ref, params.k_neighbors, params.plane_eps)
    Cq = _point_covariances(target, params.k_neighbors, params.plane_eps)
    max_corr2 = params.max_corr * params.max_corr
    T0 = initial_transform(ref, init)
    eye3 = torch.eye(3, dtype=dtype, device=ref.points.device)
    eye6 = torch.eye(6, dtype=dtype, device=ref.points.device)

    def body(T):
        R = T.rotation()[..., None, :, :]  # (..., 1, 3, 3)
        moved = (R @ ref.points[..., None])[..., 0] + T.t[..., None, :]
        idx, d2 = nearest_neighbor(moved, ref.mask, target.points,
                                   target.mask)
        w = (ref.mask & (d2 <= max_corr2)).to(dtype)
        q = gather_points(target.points, idx)
        W = torch.linalg.inv_ex(
            gather_points(Cq.flatten(-2), idx).unflatten(-1, (3, 3))
            + R @ Cp @ R.transpose(-1, -2) + 1e-9 * eye3
        ).inverse  # (..., N, 3, 3)
        r = q - moved
        # moved' = exp(w)^ (R p + t) + v => dr/dw = hat(moved), dr/dv = -I
        Hm = so3.hat(moved)
        J = torch.cat([Hm, -eye3.expand(Hm.shape)], dim=-1)  # (..., N, 3, 6)
        JtW = J.transpose(-1, -2) @ W  # (..., N, 6, 3)
        H = torch.einsum("...njk,...nkl,...n->...jl", JtW, J, w)
        b = -torch.einsum("...njk,...nk,...n->...j", JtW, r, w)
        dx = torch.linalg.solve_ex(H + 1e-9 * eye6, b[..., None]).result[..., 0]
        dT = SE3(q=so3.exp_quat(dx[..., 0:3]), t=dx[..., 3:6])
        return dT.compose(T).normalize(), torch.sum(dx * dx, dim=-1)

    live = torch.ones(T0.t.shape[:-1], dtype=torch.bool,
                      device=ref.points.device)
    T, iters = converged_scan(body, T0, params.max_iter, params.t_eps, live)
    return GICPResult(transform=T, converged=iters < params.max_iter,
                      iterations=iters)
