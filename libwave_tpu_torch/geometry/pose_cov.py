"""SE(3) pose composition with 6x6 covariance propagation (port of
``libwave_tpu.geometry.pose_cov``).

The reference's ``PoseWithCovariance`` / ``composePose``
(wave_utils/include/wave/utils/pose_cov_comp.hpp:62,
wave_utils/src/pose_cov_comp.cpp:104) chains eight hand-written p7/p6
Jacobians over a [x, y, z, yaw, pitch, roll] parameterization. Here, as in
the JAX package, the covariance lives on the se(3) tangent space at the
pose (right perturbation, twist order [omega, v]), where composition
Jacobians are exact and closed-form:

    T = T1 ∘ T2,  Sigma = Ad(T2⁻¹) Sigma1 Ad(T2⁻¹)ᵀ + Sigma2

The products run with TF32 off (:func:`~libwave_tpu_torch.utils.precision.
f32_matmuls`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libwave_tpu_torch.geometry import se3, so3
from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.utils.precision import f32_matmuls


class PoseWithCovariance(NamedTuple):
    """Pose with 6x6 tangent-space covariance (right perturbation)."""

    pose: SE3
    cov: torch.Tensor  # (..., 6, 6), twist order [omega(3), v(3)]

    @staticmethod
    def certain(pose: SE3) -> "PoseWithCovariance":
        batch = pose.t.shape[:-1]
        return PoseWithCovariance(
            pose=pose, cov=pose.t.new_zeros(batch + (6, 6))
        )


@f32_matmuls
def compose_pose_with_covariance(
    p1: PoseWithCovariance, p2: PoseWithCovariance
) -> PoseWithCovariance:
    """Compose two uncertain poses: result = p1.pose ∘ p2.pose with
    propagated covariance. Batched over leading dims; cross-covariance
    assumed zero, as in the reference (pose_cov_comp.cpp:104
    composePose)."""
    T = p1.pose.compose(p2.pose)
    A = se3.adjoint(p2.pose.inverse())  # (..., 6, 6)
    cov = A @ p1.cov @ A.transpose(-1, -2) + p2.cov
    return PoseWithCovariance(pose=T, cov=cov)


@f32_matmuls
def transform_point_with_covariance(
    p: PoseWithCovariance, x: torch.Tensor, x_cov: torch.Tensor | None = None
):
    """Transform a point and propagate covariance through the uncertain
    pose.

    y = R x + t;  J wrt twist [omega, v] is [-R hat(x), R] (right
    perturbation); J wrt x is R.

    Returns (y, y_cov) with y_cov shape (..., 3, 3).
    """
    R = p.pose.rotation()
    y = p.pose.apply(x)
    J_omega = -R @ so3.hat(x)
    J = torch.cat([J_omega, R], dim=-1)  # (..., 3, 6)
    y_cov = J @ p.cov @ J.transpose(-1, -2)
    if x_cov is not None:
        y_cov = y_cov + R @ x_cov @ R.transpose(-1, -2)
    return y, y_cov
