"""Batched SE(3) rigid transforms as (quaternion, translation) pairs.

Port of ``libwave_tpu.geometry.se3``. An :class:`SE3` holds ``q`` (..., 4)
Hamilton [w, x, y, z] and ``t`` (..., 3) and broadcasts over leading batch
dimensions. Twists are ordered ``xi = [omega, v]``, rotation first.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libwave_tpu_torch.geometry import so3


class SE3(NamedTuple):
    """Rigid transform: ``x_out = R(q) @ x_in + t``."""

    q: torch.Tensor  # (..., 4) unit quaternion [w, x, y, z]
    t: torch.Tensor  # (..., 3)

    @staticmethod
    def identity(shape=(), dtype=torch.float32, device=None) -> "SE3":
        q = so3.quat_identity(shape, dtype, device)
        return SE3(q=q, t=q.new_zeros(tuple(shape) + (3,)))

    @staticmethod
    def from_rot_trans(R: torch.Tensor, t: torch.Tensor) -> "SE3":
        return SE3(q=so3.rot_to_quat(R), t=t)

    @staticmethod
    def from_matrix(T: torch.Tensor) -> "SE3":
        """From (..., 4, 4) homogeneous matrices."""
        return SE3(q=so3.rot_to_quat(T[..., :3, :3]), t=T[..., :3, 3])

    def rotation(self) -> torch.Tensor:
        return so3.quat_to_rot(self.q)

    def matrix(self) -> torch.Tensor:
        """As (..., 4, 4) homogeneous matrices (no host scalar written into
        a tensor, which would synchronize with the card)."""
        R = self.rotation()
        top = torch.cat([R, self.t[..., :, None]], dim=-1)
        bottom = torch.zeros_like(top[..., :1, :])
        bottom = torch.cat([bottom[..., :3], torch.ones_like(bottom[..., 3:])],
                           dim=-1)
        return torch.cat([top, bottom], dim=-2)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Transform points: (..., 3) -> (..., 3)."""
        return so3.quat_rotate(self.q, x) + self.t

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other (apply ``other`` first)."""
        return SE3(
            q=so3.quat_multiply(self.q, other.q),
            t=so3.quat_rotate(self.q, other.t) + self.t,
        )

    def inverse(self) -> "SE3":
        qi = so3.quat_inverse(self.q)
        return SE3(q=qi, t=-so3.quat_rotate(qi, self.t))

    def normalize(self) -> "SE3":
        return SE3(q=so3.quat_normalize(self.q), t=self.t)


def exp(xi: torch.Tensor) -> SE3:
    """se(3) -> SE(3). ``xi = [omega, v]`` shape (..., 6)."""
    omega, v = xi[..., 0:3], xi[..., 3:6]
    V = so3.left_jacobian(omega)
    return SE3(q=so3.exp_quat(omega),
               t=torch.einsum("...ij,...j->...i", V, v))


def log(T: SE3) -> torch.Tensor:
    """SE(3) -> se(3) twist ``[omega, v]`` of shape (..., 6)."""
    omega = so3.log_quat(T.q)
    Vinv = so3.left_jacobian_inverse(omega)
    v = torch.einsum("...ij,...j->...i", Vinv, T.t)
    return torch.cat([omega, v], dim=-1)


def boxplus(T: SE3, xi: torch.Tensor) -> SE3:
    """Right retraction: T ⊞ xi = T ∘ exp(xi)."""
    return T.compose(exp(xi))


def boxminus(T1: SE3, T2: SE3) -> torch.Tensor:
    """Local coordinates: log(T2⁻¹ ∘ T1); inverse of :func:`boxplus`."""
    return log(T2.inverse().compose(T1))


def adjoint(T: SE3) -> torch.Tensor:
    """6x6 adjoint with twist order [omega, v]:
    Ad = [[R, 0], [hat(t) R, R]]."""
    R = T.rotation()
    A = R.new_zeros(R.shape[:-2] + (6, 6))
    A[..., 0:3, 0:3] = R
    A[..., 3:6, 3:6] = R
    A[..., 3:6, 0:3] = so3.hat(T.t) @ R
    return A


def interpolate(T1: SE3, T2: SE3, alpha) -> SE3:
    """Geodesic interpolation T1 ∘ exp(alpha * log(T1⁻¹ T2))."""
    alpha = torch.as_tensor(alpha, dtype=T1.t.dtype, device=T1.t.device)
    return boxplus(T1, alpha[..., None] * boxminus(T2, T1))
