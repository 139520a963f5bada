"""Reprojection factor bank: residuals + hand-derived manifold Jacobians.

Port of ``libwave_tpu.optim.reprojection``. The whole bank of observations
linearizes as one closed-form evaluation:

    pc   = R(q)^T (X - p)                 (camera-frame point)
    uv   = [fx pcx/pcz + cx, fy pcy/pcz + cy]
    r    = uv - measurement

Pose tangent is the product-manifold perturbation ``[omega(3), dp(3)]`` with
``q <- q ⊗ exp(omega)`` (right perturbation) and ``p <- p + dp``; the
closed-form blocks are

    d pc/d omega = hat(pc)        d pc/d dp = -R^T       d pc/d X = R^T

chained through the projection Jacobian ``d uv/d pc``. The component-major
(``_cm``) and pose-ELL (``_ell``) forms keep every intermediate a flat
vector per component, the layout the normal-equation build consumes.
"""

from __future__ import annotations

import torch

from libwave_tpu_torch.geometry import so3


def _rot_entries(qw, qx, qy, qz):
    """Rotation-matrix entries R[i][j] from quaternion components (w-first),
    as a 3x3 nested list of component tensors."""
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    return [
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ]


def _project_core(K, qk, pk, Xk, uv_cm):
    """Shared component-major projection core over per-observation views
    qk (4, ...), pk (3, ...), Xk (3, ...), uv_cm (2, ...). Broadcasting
    handles the pose-ELL case where qk/pk are (C, N, 1) against
    (C, N, Pmax) landmarks."""
    R = _rot_entries(qk[0], qk[1], qk[2], qk[3])
    d = [Xk[i] - pk[i] for i in range(3)]
    # pc = R^T d (camera-frame point)
    pc = [sum(R[j][i] * d[j] for j in range(3)) for i in range(3)]
    x, y, z = pc
    valid = z > 1e-6
    zs = torch.where(valid, z, 1.0)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    inv_z = 1.0 / zs
    r0 = fx * x * inv_z + cx - uv_cm[0]
    r1 = fy * y * inv_z + cy - uv_cm[1]
    vf = valid.to(uv_cm.dtype)
    r = torch.stack([r0 * vf, r1 * vf])
    return r, valid, R, pc, (fx, fy, inv_z)


def _views_flat(q, p, lm, pose_idx, lm_idx):
    """Per-observation component views for a flat observation bank."""
    qk = q.T[:, pose_idx]  # (4, K)
    pk = p.T[:, pose_idx]  # (3, K)
    Xk = lm.T[:, lm_idx]  # (3, K)
    return qk, pk, Xk


def _views_ell(q, p, lm, lm_slot):
    """Per-observation views for the pose-ELL bank: pose state broadcasts
    as (C, N, 1) against the (C, N, Pmax) landmark gather."""
    qk = q.T[:, :, None]  # (4, N, 1)
    pk = p.T[:, :, None]  # (3, N, 1)
    Xk = lm.T[:, lm_slot]  # (3, N, Pmax)
    return qk, pk, Xk


def reprojection_residual_cm(K, q, p, lm, pose_idx, lm_idx, uv_cm):
    """Component-major residual bank: state tensors + index vectors in,
    (r (2, K), valid (K,)) out. ``uv_cm`` is (2, K)."""
    qk, pk, Xk = _views_flat(q, p, lm, pose_idx, lm_idx)
    r, valid, _, _, _ = _project_core(K, qk, pk, Xk, uv_cm)
    return r, valid


def reprojection_residual_ell(K, q, p, lm, lm_slot, uv_ell):
    """Pose-ELL residual bank: lm_slot (N, Pmax), uv_ell (2, N, Pmax) ->
    (r (2, N, Pmax), valid (N, Pmax))."""
    qk, pk, Xk = _views_ell(q, p, lm, lm_slot)
    r, valid, _, _, _ = _project_core(K, qk, pk, Xk, uv_ell)
    return r, valid


def linearize_reprojection_cm(K, q, p, lm, pose_idx, lm_idx, uv_cm):
    """Component-major linearization of the reprojection bank (flat order).

    Takes the state (q (N, 4), p (N, 3), lm (M, 3)) plus index vectors and
    returns r (2, K), J_pose (2, 6, K) in [omega, dp] order, J_lm (2, 3, K),
    valid (K,).
    """
    qk, pk, Xk = _views_flat(q, p, lm, pose_idx, lm_idx)
    return _linearize_core(K, qk, pk, Xk, uv_cm)


def linearize_reprojection_ell(K, q, p, lm, lm_slot, uv_ell):
    """Pose-ELL linearization: returns r (2, N, Pmax), J_pose
    (2, 6, N, Pmax), J_lm (2, 3, N, Pmax), valid (N, Pmax)."""
    qk, pk, Xk = _views_ell(q, p, lm, lm_slot)
    return _linearize_core(K, qk, pk, Xk, uv_ell)


def _linearize_core(K, qk, pk, Xk, uv_cm):
    r, valid, R, pc, (fx, fy, inv_z) = _project_core(K, qk, pk, Xk, uv_cm)
    x, y, _ = pc
    vf = valid.to(uv_cm.dtype)

    # J_proj (2x3): [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]]
    a0 = fx * inv_z * vf
    a2 = -fx * x * inv_z * inv_z * vf
    b1 = fy * inv_z * vf
    b2 = -fy * y * inv_z * inv_z * vf

    # J_omega = J_proj @ hat(pc); hat = [[0,-z,y],[z,0,-x],[-y,x,0]]
    px, py, pz = pc
    Jw = [
        [a2 * -py, a0 * -pz + a2 * px, a0 * py],
        [b1 * pz + b2 * -py, b2 * px, b1 * -px],
    ]
    # J_lm = J_proj @ R^T (row a, col c: sum_b J_proj[a][b] R[c][b]);
    # J_dp = -J_lm
    Jl = [
        [a0 * R[c][0] + a2 * R[c][2] for c in range(3)],
        [b1 * R[c][1] + b2 * R[c][2] for c in range(3)],
    ]
    J_pose = torch.stack(
        [torch.stack(Jw[a] + [-Jl[a][c] for c in range(3)]) for a in range(2)]
    )  # (2, 6, ...)
    J_lm = torch.stack([torch.stack(Jl[a]) for a in range(2)])  # (2, 3, ...)
    return r, J_pose, J_lm, valid


def _camera_point(q_GC, p_GC, X):
    """World point -> camera frame."""
    return so3.quat_rotate(so3.quat_inverse(q_GC), X - p_GC)


def reprojection_residual(K, q_GC, p_GC, X, uv_meas):
    """Residual r = project(X) - uv_meas. Broadcasts over leading dims.

    Returns (r, valid) where valid is the cheirality flag (z > eps); invalid
    observations carry a zero residual.
    """
    pc = _camera_point(q_GC, p_GC, X)
    z = pc[..., 2]
    valid = z > 1e-6
    safe_z = torch.where(valid, z, 1.0)
    fx = K[0, 0]
    fy = K[1, 1]
    cx = K[0, 2]
    cy = K[1, 2]
    u = fx * pc[..., 0] / safe_z + cx
    v = fy * pc[..., 1] / safe_z + cy
    r = torch.stack([u, v], dim=-1) - uv_meas
    return torch.where(valid[..., None], r, 0.0), valid


def linearize_reprojection(K, q_GC, p_GC, X, uv_meas):
    """Residual and Jacobian blocks for a bank of observations.

    All inputs broadcast over a leading observation axis:
      q_GC (K_,4), p_GC (K_,3), X (K_,3), uv_meas (K_,2)

    Returns (r (K_,2), J_pose (K_,2,6) in [omega, dp] order, J_lm (K_,2,3),
    valid (K_,)).
    """
    Rt = so3.quat_to_rot(so3.quat_inverse(q_GC))  # R^T, rotates world->camera
    pc = torch.einsum("...ij,...j->...i", Rt, X - p_GC)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    valid = z > 1e-6
    zs = torch.where(valid, z, 1.0)

    fx = K[0, 0]
    fy = K[1, 1]
    u = fx * x / zs + K[0, 2]
    v = fy * y / zs + K[1, 2]
    r = torch.stack([u, v], dim=-1) - uv_meas
    r = torch.where(valid[..., None], r, 0.0)

    # d uv / d pc : (K_, 2, 3)
    zero = torch.zeros_like(x)
    inv_z = 1.0 / zs
    J_proj = torch.stack(
        [
            torch.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], dim=-1),
            torch.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], dim=-1),
        ],
        dim=-2,
    )
    # d pc / d omega = hat(pc);  d pc / d dp = -R^T;  d pc / d X = R^T
    J_omega = J_proj @ so3.hat(pc)
    J_dp = -(J_proj @ Rt)
    J_lm = J_proj @ Rt
    J_pose = torch.cat([J_omega, J_dp], dim=-1)  # (K_, 2, 6)

    mask = valid[..., None, None]
    return (
        r,
        torch.where(mask, J_pose, 0.0),
        torch.where(mask, J_lm, 0.0),
        valid,
    )
