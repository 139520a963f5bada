"""Batched SO(3): quaternions, rotation matrices, exp/log maps.

Port of ``libwave_tpu.geometry.so3``. All functions broadcast over leading
batch dimensions. Small-angle singularities use Taylor-series branches
selected with ``torch.where`` on safe operands, so no branch ever evaluates
a 0/0 and autograd stays finite.

Conventions:
- quaternion ``q = [w, x, y, z]``, Hamilton product, unit norm, rotates vectors
  by ``R(q) @ v``;
- tangent vectors (rotation vectors) ``phi`` in R^3 with ``R = exp(hat(phi))``;
- right-handed frames throughout.
"""

from __future__ import annotations

import torch

# Small-angle cutoff: below this, use Taylor expansions. sqrt(eps) for f32.
_SMALL = 1e-6


def _stack_last(parts):
    return torch.stack(parts, dim=-1)


def _eye_like(M: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape)


# ---------------------------------------------------------------------------
# hat / vee
# ---------------------------------------------------------------------------


def hat(phi: torch.Tensor) -> torch.Tensor:
    """Map R^3 -> so(3): the skew-symmetric cross-product matrix.

    ``hat(a) @ b == cross(a, b)``. Shape (..., 3) -> (..., 3, 3).
    """
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    rows = [
        _stack_last([zero, -z, y]),
        _stack_last([z, zero, -x]),
        _stack_last([-y, x, zero]),
    ]
    return torch.stack(rows, dim=-2)


def vee(Phi: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`. Shape (..., 3, 3) -> (..., 3)."""
    return _stack_last([Phi[..., 2, 1], Phi[..., 0, 2], Phi[..., 1, 0]])


# ---------------------------------------------------------------------------
# quaternion algebra
# ---------------------------------------------------------------------------


def quat_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity quaternion(s) of shape ``shape + (4,)``."""
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b; composition of rotations R(a)R(b)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return _stack_last(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (= inverse for unit quaternions)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    return quat_conjugate(q)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize to unit quaternion, canonicalized to w >= 0."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q: ``R(q) @ v``.

    Uses the 2-cross-product expansion (no 3x3 matrix materialized).
    """
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation matrix. (..., 4) -> (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rows = [
        _stack_last([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)]),
        _stack_last([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)]),
        _stack_last([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)]),
    ]
    return torch.stack(rows, dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w >= 0), branch-free.

    Computes all four Shepperd candidates and selects the best-conditioned
    one (largest pivot, first on ties) with a gather.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    one = torch.ones_like(tr)

    # Four candidate (unnormalized) quaternions, each scaled by 4*component^2.
    qw = _stack_last([one + tr, m21 - m12, m02 - m20, m10 - m01])
    qx = _stack_last([m21 - m12, one + m00 - m11 - m22, m01 + m10, m02 + m20])
    qy = _stack_last([m02 - m20, m01 + m10, one - m00 + m11 - m22, m12 + m21])
    qz = _stack_last([m10 - m01, m02 + m20, m12 + m21, one - m00 - m11 + m22])

    pivots = torch.stack(
        [one + tr, one + m00 - m11 - m22, one - m00 + m11 - m22,
         one - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    index = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, index)[..., 0, :]
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# exp / log
# ---------------------------------------------------------------------------


def _safe_theta(phi):
    """(theta2, safe_theta, small): ``safe_theta`` equals |phi| off the
    small-angle branch and 1.0 on it, with sqrt evaluated away from 0 so
    gradients stay finite (the where-guard must protect the sqrt *input*)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < _SMALL * _SMALL
    safe = torch.sqrt(torch.where(small, 1.0, theta2))
    return theta2, safe, small


def exp(phi: torch.Tensor) -> torch.Tensor:
    """so(3) -> SO(3) as rotation matrix (Rodrigues). (..., 3) -> (..., 3, 3)."""
    theta2, theta, small = _safe_theta(phi)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta * theta)
    )
    Phi = hat(phi)
    return _eye_like(Phi) + a[..., None, None] * Phi + b[..., None, None] * (
        Phi @ Phi
    )


def exp_quat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) -> unit quaternion. (..., 3) -> (..., 4)."""
    theta2, theta, small = _safe_theta(phi)
    half = 0.5 * theta
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    return torch.cat([w[..., None], k[..., None] * phi], dim=-1)


def log(R: torch.Tensor) -> torch.Tensor:
    """SO(3) -> so(3) from rotation matrix. (..., 3, 3) -> (..., 3).

    Goes through the quaternion for a numerically robust inverse near pi.
    """
    return log_quat(rot_to_quat(R))


def log_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector. (..., 4) -> (..., 3)."""
    q = torch.where(q[..., :1] < 0, -q, q)  # w >= 0 => theta in [0, pi]
    w = torch.clip(q[..., 0], -1.0, 1.0)
    vn2 = torch.sum(q[..., 1:4] * q[..., 1:4], dim=-1)
    small = vn2 < _SMALL * _SMALL
    vn = torch.sqrt(torch.where(small, 1.0, vn2))
    theta = 2.0 * torch.atan2(vn, w)
    # theta/vn -> 2/w - 2 vn^2 / (3 w^3) as vn -> 0 (w ~ 1 here since w >= 0).
    safe_w = torch.clamp(w, min=_SMALL)
    k = torch.where(
        small, 2.0 / safe_w - 2.0 * vn2 / (3.0 * safe_w**3), theta / vn
    )
    return k[..., None] * q[..., 1:4]


def left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3): d exp(phi+d) ≈ exp(J_l d) exp(phi)."""
    theta2, theta, small = _safe_theta(phi)
    safe2 = theta * theta
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe2)
    b = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (safe2 * theta),
    )
    Phi = hat(phi)
    return _eye_like(Phi) + a[..., None, None] * Phi + b[..., None, None] * (
        Phi @ Phi
    )


def left_jacobian_inverse(phi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3)."""
    theta2, theta, small = _safe_theta(phi)
    half = 0.5 * theta
    cot = torch.cos(half) / torch.sin(half)
    k = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - half * cot) / (theta * theta)
    )
    Phi = hat(phi)
    return _eye_like(Phi) - 0.5 * Phi + k[..., None, None] * (Phi @ Phi)


# ---------------------------------------------------------------------------
# boxplus / boxminus on the quaternion chart (right perturbation)
# ---------------------------------------------------------------------------


def quat_boxplus(q: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Retract: q ⊞ phi = q ⊗ exp(phi). Right (body-frame) perturbation."""
    return quat_multiply(q, exp_quat(phi))


def quat_boxminus(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Local coordinates: q1 ⊟ q2 = log(q2⁻¹ ⊗ q1), inverse of boxplus."""
    return log_quat(quat_multiply(quat_inverse(q2), q1))


def rotation_distance(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between two rotations, in radians."""
    return torch.linalg.norm(quat_boxminus(q1, q2), dim=-1)
