"""Epipolar geometry: essential matrix, pose recovery, triangulation (port of
``libwave_tpu.vision.epipolar``).

- ``essential_from_fundamental``: E = K2ᵀ F K1, projected onto the
  essential manifold.
- ``decompose_essential``: SVD -> the four (R, t) candidates.
- ``triangulate``: linear (DLT) triangulation, one batched 4x4 SVD.
- ``recover_pose``: cheirality vote over the four candidates (the
  cv::recoverPose contract): all four triangulate every correspondence in one
  batched SVD, the winner has the most valid points in front of both
  cameras, and it is picked on the device (no index read on the host).

Convention: x2ᵀ E x1 = 0 with x = K⁻¹ [u v 1]ᵀ; the recovered (R, t) maps
camera-1 coordinates into camera-2 (X2 = R X1 + t), ‖t‖ = 1. Every product
runs in full f32 (or the input's f64) under ``f32_matmuls``, as the
reference pins it. ``torch.linalg.svd`` synchronizes with the card; the
reference's SVD signs may differ from LAPACK's here, which permutes the four
candidates but not the winner.
"""

from __future__ import annotations

import functools

import torch

from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.utils.precision import f32_matmuls

__all__ = [
    "essential_from_fundamental",
    "decompose_essential",
    "triangulate",
    "recover_pose",
]


@f32_matmuls
def essential_from_fundamental(F, K1, K2=None):
    """E = K2ᵀ F K1, projected onto the essential manifold (two equal
    singular values, third zero)."""
    if K2 is None:
        K2 = K1
    E = K2.to(F.dtype).T @ F @ K1.to(F.dtype)
    U, s, Vt = torch.linalg.svd(E)
    sbar = 0.5 * (s[..., 0] + s[..., 1])
    diag = torch.stack([sbar, sbar, torch.zeros_like(sbar)], dim=-1)
    return (U * diag[..., None, :]) @ Vt


def _det3(M):
    """Determinant of (..., 3, 3) matrices by the rule of Sarrus (no LU)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


@functools.lru_cache(maxsize=8)
def _w_matrix(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Hartley-Zisserman's W, made once per dtype and device (a host copy
    in every call would synchronize)."""
    return torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=dtype,
                        device=device)


@f32_matmuls
def decompose_essential(E):
    """The four relative-pose candidates of an essential matrix.

    Returns (Rs (4, 3, 3), ts (4, 3)): (R1, t), (R1, -t), (R2, t), (R2, -t),
    with det(R) = +1 enforced.
    """
    U, _, Vt = torch.linalg.svd(E)
    # keep rotations proper
    U = U * torch.sign(_det3(U))
    Vt = Vt * torch.sign(_det3(Vt))
    W = _w_matrix(E.dtype, E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


@f32_matmuls
def triangulate(R, t, x1, x2):
    """Linear triangulation in normalized coordinates.

    Camera 1 at identity, camera 2 at [R | t]; ``R`` (..., 3, 3), ``t``
    (..., 3) with any leading candidate dimensions, ``x1``/``x2`` (N, 2)
    normalized image points. Returns (X (..., N, 3) in camera-1 frame,
    depth1 (..., N), depth2 (..., N)).
    """
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    P1 = torch.cat([eye, torch.zeros_like(t)[..., None]], dim=-1)
    P2 = torch.cat([R, t[..., None]], dim=-1)  # (..., 3, 4)
    P1, P2 = P1[..., None, :, :], P2[..., None, :, :]  # against N points
    u1, u2 = x1[..., None], x2[..., None]  # (N, 2, 1)
    A = torch.stack([
        u1[..., 0, :] * P1[..., 2, :] - P1[..., 0, :],
        u1[..., 1, :] * P1[..., 2, :] - P1[..., 1, :],
        u2[..., 0, :] * P2[..., 2, :] - P2[..., 0, :],
        u2[..., 1, :] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)  # (..., N, 4, 4)
    # smallest right singular vector of A
    Xh = torch.linalg.svd(A)[2][..., -1, :]
    w = torch.where(torch.abs(Xh[..., 3]) < 1e-12,
                    torch.full_like(Xh[..., 3], 1e-12), Xh[..., 3])
    X = Xh[..., :3] / w[..., None]
    z2 = torch.sum(R[..., None, 2, :] * X, dim=-1) + t[..., None, 2]
    return X, X[..., 2], z2


@f32_matmuls
def recover_pose(E, p1, p2, K, valid):
    """Select the cheirality-consistent (R, t) from an essential matrix.

    All four candidates triangulate every correspondence in one batch; the
    winner maximizes the count of valid points with positive depth in both
    cameras (the first of equal counts). Returns (SE3 T_21 with unit
    translation, cheirality_inliers (N,), votes (4,)).
    """
    K = K.to(p1.dtype)
    Kinv = torch.linalg.inv_ex(K)[0]
    ones = torch.ones(p1.shape[:-1] + (1,), dtype=p1.dtype, device=p1.device)
    x1 = (torch.cat([p1, ones], -1) @ Kinv.T)[..., :2]
    x2 = (torch.cat([p2, ones], -1) @ Kinv.T)[..., :2]

    Rs, ts = decompose_essential(E)
    _, z1, z2 = triangulate(Rs, ts, x1, x2)  # (4, N)
    goods = (z1 > 0) & (z2 > 0) & valid
    votes = torch.sum(goods, dim=-1)
    best = torch.argmax(votes).reshape(1)
    R = torch.index_select(Rs, 0, best)[0]
    t = torch.index_select(ts, 0, best)[0]
    good = torch.index_select(goods, 0, best)[0]
    return SE3.from_rot_trans(R, t), good, votes
