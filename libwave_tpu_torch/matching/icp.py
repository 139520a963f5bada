"""Point-to-point ICP with multiscale schedule and LUM/Censi information.

Port of ``libwave_tpu.matching.icp``, batched: the clouds carry leading
dimensions (``(N, 3)`` or ``(B, N, 3)`` points with ``(N,)`` or ``(B, N)``
masks) and every result carries the same. Each trip of a scale's loop
finds the nearest neighbours by chunked full-f32 products
(:mod:`~libwave_tpu_torch.matching.knn`) and takes a masked Umeyama step
(the 3x3 SVD, batched over pairs); the loop is ``max_iter`` trips with the
reference's t_eps rule applied by masking
(:mod:`~libwave_tpu_torch.matching.loop`), so no trip reads a value on the
host. The Censi estimate takes its second derivatives of the same cost with
``torch.func`` (forward over reverse), batched over pairs and
correspondences.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.func import grad, jvp, vmap

from libwave_tpu_torch.geometry import euler as euler_mod
from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.matching.knn import nearest_neighbor
from libwave_tpu_torch.matching.loop import converged_scan
from libwave_tpu_torch.matching.pointcloud import (
    PointCloud,
    apply_points,
    gather_points,
    voxel_downsample,
)
from libwave_tpu_torch.utils.config import ConfigError
from libwave_tpu_torch.utils.precision import f32_matmuls


@dataclasses.dataclass(frozen=True)
class ICPParams:
    """icp.hpp:30-65 parameter parity."""

    max_corr: float = 3.0
    max_iter: int = 100
    t_eps: float = 1e-8
    fit_eps: float = 1e-2
    lidar_ang_covar: float = 7.78e-9
    lidar_lin_covar: float = 2.5e-4
    multiscale_steps: int = 3
    res: float = 0.1
    covar_estimator: str = "LUM"  # LUM | CENSI | LUMold

    def validate(self):
        if self.max_iter <= 0:
            raise ConfigError("max_iter must be positive")
        if self.covar_estimator not in ("LUM", "CENSI", "LUMold"):
            raise ConfigError("invalid covariance estimate method")


class ICPResult(NamedTuple):
    transform: SE3  # maps ref -> target frame
    converged: torch.Tensor  # (...) bool
    iterations: torch.Tensor  # (...) int32
    correspondences: torch.Tensor  # (..., N) target index per ref point
    corr_valid: torch.Tensor  # (..., N) bool
    ref_ds: PointCloud  # downsampled ref used at the finest scale
    target_ds: PointCloud  # downsampled target used at the finest scale


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices by cofactors: exact arithmetic
    on the entries, no solver launch."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def _umeyama_step(p, q, w):
    """Weighted rigid alignment p -> q (the SVD update inside each ICP
    iteration), over leading batch dimensions. Returns SE3."""
    wsum = torch.sum(w, dim=-1, keepdim=True) + 1e-12
    cp = torch.sum(p * w[..., None], dim=-2) / wsum
    cq = torch.sum(q * w[..., None], dim=-2) / wsum
    pc = p - cp[..., None, :]
    qc = q - cq[..., None, :]
    H = (pc * w[..., None]).transpose(-1, -2) @ qc  # (..., 3, 3)
    U, _, Vh = torch.linalg.svd(H)
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(det3(V @ Ut))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = (V * D[..., None, :]) @ Ut
    t = cq - (R @ cp[..., None])[..., 0]
    return SE3(q=so3.rot_to_quat(R), t=t)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _icp_single_scale(ref: PointCloud, target: PointCloud, T0: SE3,
                      max_corr: float, max_iter: int, t_eps: float):
    """Fixed-scale ICP loop over the batch. Returns (T, iters, idx,
    valid)."""
    dtype = ref.points.dtype
    max_corr2 = max_corr * max_corr
    eye4 = _eye(4, ref.points)

    def corr_at(T):
        moved = apply_points(T, ref.points)
        idx, d2 = nearest_neighbor(moved, ref.mask, target.points,
                                   target.mask)
        valid = ref.mask & (d2 <= max_corr2)
        return idx, valid, moved

    def body(T):
        idx, valid, moved = corr_at(T)
        dT = _umeyama_step(moved, gather_points(target.points, idx),
                           valid.to(dtype))
        T_new = dT.compose(T).normalize()
        delta = torch.sum((dT.matrix() - eye4) ** 2, dim=(-2, -1))
        return T_new, delta

    live = torch.ones(T0.t.shape[:-1], dtype=torch.bool,
                      device=ref.points.device)
    T, iters = converged_scan(body, T0, max_iter, t_eps, live)
    idx, valid, _ = corr_at(T)
    return T, iters, idx, valid


def initial_transform(ref: PointCloud, init: SE3 | None) -> SE3:
    """``init`` (or the identity) broadcast to the batch of ``ref``."""
    batch = ref.points.shape[:-2]
    if init is None:
        return SE3.identity(batch, dtype=ref.points.dtype,
                            device=ref.points.device)
    return SE3(q=init.q.expand(batch + (4,)), t=init.t.expand(batch + (3,)))


@f32_matmuls
def icp_match(ref: PointCloud, target: PointCloud,
              params: ICPParams = ICPParams(),
              init: SE3 | None = None) -> ICPResult:
    """Full reference match flow (icp.cpp:75-133): optional multiscale
    voxel pyramid composing a running transform, else single-scale."""
    T = initial_transform(ref, init)
    if params.res > 0 and params.multiscale_steps > 0:
        total_iters = 0
        for i in range(params.multiscale_steps, -1, -1):
            leaf = (2.0**i) * params.res
            r = voxel_downsample(ref, leaf)
            t = voxel_downsample(target, leaf)
            T, iters, idx, valid = _icp_single_scale(
                r, t, T, (2.0**i) * params.max_corr, params.max_iter,
                params.t_eps,
            )
            total_iters = total_iters + iters
        ref_ds, target_ds = r, t
    else:
        if params.res > 0:
            ref_ds = voxel_downsample(ref, params.res)
            target_ds = voxel_downsample(target, params.res)
        else:
            ref_ds, target_ds = ref, target
        T, total_iters, idx, valid = _icp_single_scale(
            ref_ds, target_ds, T, params.max_corr, params.max_iter,
            params.t_eps,
        )
    return ICPResult(
        transform=T,
        converged=torch.sum(valid.to(torch.int32), dim=-1) >= 3,
        iterations=total_iters,
        correspondences=idx,
        corr_valid=valid,
        ref_ds=ref_ds,
        target_ds=target_ds,
    )


# ---------------------------------------------------------------------------
# Information-matrix estimation
# ---------------------------------------------------------------------------

# (row, col, term) of the upper triangle of the LUM M'M; the terms are
# correspondence sums of the midpoints' coordinates
_LUM_TERMS = (
    (0, 0, "n"), (1, 1, "n"), (2, 2, "n"),
    (0, 4, "-y"), (0, 5, "z"), (1, 3, "-z"), (1, 4, "x"),
    (2, 3, "y"), (2, 5, "-x"),
    (3, 4, "-xz"), (3, 5, "-xy"), (4, 5, "-yz"),
    (3, 3, "yy+zz"), (4, 4, "xx+yy"), (5, 5, "xx+zz"),
)


@f32_matmuls
def estimate_info_lum(result: ICPResult) -> torch.Tensor:
    """Lu-Milios edge information from final correspondences
    (estimateLUM, icp_pcl_functions.cpp:182): M'M assembled from
    correspondence midpoints, scaled by mean squared error / (2n - 3).

    Order of the 6 DOF: [x, y, z, rotx, roty, rotz] as in PCL's LUM.
    Returns (..., 6, 6)."""
    res = result
    aligned = apply_points(res.transform, res.ref_ds.points)
    tgt = gather_points(res.target_ds.points, res.correspondences)
    w = res.corr_valid.to(aligned.dtype)
    aver = 0.5 * (aligned + tgt)
    diff = aligned - tgt

    x, y, z = aver[..., 0], aver[..., 1], aver[..., 2]
    n = torch.sum(w, dim=-1)

    def s(v):
        return torch.sum(v * w, dim=-1)

    terms = {"n": n, "x": s(x), "y": s(y), "z": s(z), "xz": s(x * z),
             "xy": s(x * y), "yz": s(y * z), "yy+zz": s(y * y + z * z),
             "xx+yy": s(x * x + y * y), "xx+zz": s(x * x + z * z)}
    MM = aligned.new_zeros(n.shape + (6, 6))
    for r, c, term in _LUM_TERMS:
        v = -terms[term[1:]] if term.startswith("-") else terms[term]
        MM[..., r, c] = v
        MM[..., c, r] = v

    ss = torch.sum(torch.sum(diff * diff, dim=-1) * w, dim=-1)
    denom = torch.clamp(2.0 * n - 3.0, min=1.0)
    ss = torch.clamp(ss / denom, min=1e-12)
    info = MM / ss[..., None, None]
    # degenerate guard (reference falls back to identity, icp_pcl:170-173)
    ok = (torch.isfinite(ss) & (ss > 1e-13))[..., None, None]
    return torch.where(ok, info, _eye(6, aligned))


def _censi_moved(x6, ref_pts):
    """``R(rpy) ref + t`` for x = [tx, ty, tz, roll, pitch, yaw] (321
    sequence), one x per point or one per batch element."""
    R = euler_mod.euler2rot(x6[..., 3:6], 321)
    return (R @ ref_pts[..., None])[..., 0] + x6[..., 0:3]


def _spherical_jacobian(p):
    """d cartesian / d (range, bearing, azimuth) at point p — the sensor
    noise model mapping (icp.cpp:225-250)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rg = torch.sqrt(x * x + y * y + z * z)
    br = torch.atan2(y, x)
    azp = torch.acos(torch.clamp(z / torch.clamp(rg, min=1e-12), -1.0, 1.0))
    cb, sb = torch.cos(br), torch.sin(br)
    ca, sa = torch.cos(azp), torch.sin(azp)
    return torch.stack(
        [
            torch.stack([cb * sa, -rg * sb * sa, rg * cb * ca], dim=-1),
            torch.stack([sb * sa, rg * cb * sa, rg * ca * sb], dim=-1),
            torch.stack([ca, torch.zeros_like(ca), -rg * sa], dim=-1),
        ],
        dim=-2,
    )


def _directions(shape, like):
    """The 6 unit tangents of a (..., 6) argument, stacked: (6, ..., 6)."""
    e = _eye(6, like)
    return e.reshape((6,) + (1,) * (len(shape) - 1) + (6,)).expand(
        (6,) + tuple(shape))


@f32_matmuls
def estimate_info_censi(result: ICPResult, params: ICPParams) -> torch.Tensor:
    """Censi/Haralick ICP covariance (estimateCensi, icp.cpp:167-396):

        cov(x) ~ A^-1 B cov(z) B^T A^-1,   A = d2J/dx2, B = d2J/dzdx

    with both second derivatives of the same cost taken by ``torch.func``
    (a ``jvp`` of the gradient per tangent direction, the directions under
    ``vmap``), batched over pairs and correspondences. Every tensor keeps
    a batch dimension inside the transforms (forward AD on 0-d float32
    tensors gives float64 tangents, ROADMAP C.2). Returns the information
    matrix (cov^-1), (..., 6, 6)."""
    dtype = result.ref_ds.points.dtype
    batch = result.ref_ds.points.shape[:-2]
    T = result.transform
    x0 = torch.cat([T.t, euler_mod.quat2euler(T.q, 321)], dim=-1).to(dtype)
    p_ref = gather_points(result.target_ds.points, result.correspondences)
    q_tgt = result.ref_ds.points
    w = result.corr_valid.to(dtype)
    N = q_tgt.shape[-2]
    x0, p_ref, q_tgt, w = (a.reshape((-1,) + a.shape[len(batch):])
                           for a in (x0, p_ref, q_tgt, w))
    B = x0.shape[0]

    def total_cost(x):  # x (B, 6): the sum of every pair's weighted cost
        d = _censi_moved(x[:, None, :], q_tgt) - p_ref
        return torch.sum(torch.sum(d * d, dim=-1) * w)

    g_x = grad(total_cost)
    A = vmap(lambda e: jvp(g_x, (x0,), (e,))[1])(
        _directions(x0.shape, x0)).permute(1, 2, 0)  # (B, 6, 6)

    # B_k = d2 J_k / dz dx with z = (p_k, q_k): the gradient of each
    # correspondence's cost in its own copy of x, differentiated along z
    xk = x0[:, None, :].expand(B, N, 6)

    def per_corr_grad(p, q):
        def cost(x):
            d = _censi_moved(x, q) - p
            return torch.sum(d * d)

        return grad(cost)(xk)  # (B, N, 6)

    z = torch.cat([p_ref, q_tgt], dim=-1)
    Bs = vmap(lambda e: jvp(lambda zz: per_corr_grad(zz[..., 0:3],
                                                     zz[..., 3:6]),
                            (z,), (e,))[1])(
        _directions(z.shape, z)).permute(1, 2, 3, 0)  # (B, N, 6 x, 6 z)

    # [lin, ang, ang] for p, then for q
    sd = torch.where(torch.arange(6, device=z.device) % 3 == 0,
                     params.lidar_lin_covar,
                     torch.full((6,), params.lidar_ang_covar, dtype=dtype,
                                device=z.device))
    sphere = torch.diag(sd)
    Jp = _spherical_jacobian(p_ref)
    Jq = _spherical_jacobian(q_tgt)
    Z = torch.zeros_like(Jp)
    Jz = torch.cat([torch.cat([Jp, Z], dim=-1), torch.cat([Z, Jq], dim=-1)],
                   dim=-2)  # (B, N, 6, 6)
    covZ = Jz @ sphere @ Jz.transpose(-1, -2)
    middle = torch.einsum("bnij,bnjk,bnlk,bn->bil", Bs, covZ, Bs, w)
    eye = _eye(6, middle)
    A_inv = torch.linalg.inv_ex(A + 1e-9 * eye).inverse
    cov = A_inv @ middle @ A_inv
    info = torch.linalg.inv_ex(cov + 1e-12 * eye).inverse
    return info.reshape(batch + (6, 6))


def estimate_info(result: ICPResult, params: ICPParams) -> torch.Tensor:
    """Dispatch on covar_estimator (estimateInfo, icp.cpp:135). LUMold maps
    to the same Lu-Milios estimate."""
    if params.covar_estimator == "CENSI":
        return estimate_info_censi(result, params)
    return estimate_info_lum(result)
