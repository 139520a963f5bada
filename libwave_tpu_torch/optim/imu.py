"""IMU preintegration: on-manifold integration, bias Jacobians, covariance.

Port of ``libwave_tpu.optim.imu`` (the reference's
``PreintegratedImuFactor``, Forster et al., RSS 2015): integrate gyro and
accelerometer samples between two keyframes into rotation, velocity and
position deltas with first-order bias Jacobians and the 9x9 [dtheta, dv,
dp] covariance, and form the 9-dim preintegration residual.

The reference's ``lax.scan`` over the IMU window is a Python loop over the
samples here, batched over any leading dimensions: ``vio_from_sim``
preintegrates all keyframe intervals (equal-length windows) in one call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.utils.precision import f32_matmuls

GRAVITY = (0.0, 0.0, -9.81)


class PreintegratedImu(NamedTuple):
    """Preintegrated deltas between two keyframes + bias sensitivities.
    Every field may carry leading batch dimensions (one per window)."""

    dq: torch.Tensor  # (..., 4) ΔR as quaternion (body_i <- body_j)
    dv: torch.Tensor  # (..., 3)
    dp: torch.Tensor  # (..., 3)
    dt_total: torch.Tensor  # (...)
    J_q_bg: torch.Tensor  # (..., 3, 3) d log(ΔR) / d bg
    J_v_bg: torch.Tensor  # (..., 3, 3)
    J_v_ba: torch.Tensor  # (..., 3, 3)
    J_p_bg: torch.Tensor  # (..., 3, 3)
    J_p_ba: torch.Tensor  # (..., 3, 3)
    cov: torch.Tensor  # (..., 9, 9) [dtheta, dv, dp]
    bg_ref: torch.Tensor  # (..., 3) gyro bias used during integration
    ba_ref: torch.Tensor  # (..., 3) accel bias used during integration


def vec3(values, like: torch.Tensor) -> torch.Tensor:
    """A constant 3-vector (e.g. gravity) in ``like``'s dtype and device,
    built from fills: no host-to-device copy."""
    return torch.stack([like.new_full((), float(v)) for v in values])


def _mv(A, x):
    """Batched matrix-vector product (..., n, k) @ (..., k) -> (..., n)."""
    return (A @ x[..., None])[..., 0]


@f32_matmuls
def preintegrate_imu(
    gyro: torch.Tensor,  # (..., N, 3) rad/s
    accel: torch.Tensor,  # (..., N, 3) m/s^2 (body frame, includes -gravity)
    dt,  # scalar, or sample periods broadcastable to (..., N)
    bg: torch.Tensor,  # (..., 3)
    ba: torch.Tensor,  # (..., 3)
    gyro_noise_density: float = 1.7e-4,
    accel_noise_density: float = 2.0e-3,
) -> PreintegratedImu:
    """Integrate IMU windows sample by sample, all windows at once."""
    dtype, dev = gyro.dtype, gyro.device
    batch = gyro.shape[:-2]
    N = gyro.shape[-2]
    dts = torch.as_tensor(dt, dtype=dtype, device=dev).expand(batch + (N,))
    sg2 = gyro_noise_density**2
    sa2 = accel_noise_density**2
    I3 = torch.eye(3, dtype=dtype, device=dev).expand(batch + (3, 3))

    dq = so3.quat_identity(batch, dtype, dev)
    dv = gyro.new_zeros(batch + (3,))
    dp = gyro.new_zeros(batch + (3,))
    Jqbg, Jvbg, Jvba, Jpbg, Jpba = (gyro.new_zeros(batch + (3, 3))
                                    for _ in range(5))
    P = gyro.new_zeros(batch + (9, 9))
    for n in range(N):
        h = dts[..., n]
        h1 = h[..., None]
        h2 = h[..., None, None]
        wc = gyro[..., n, :] - bg
        ac = accel[..., n, :] - ba
        R = so3.quat_to_rot(dq)
        dR_inc = so3.exp_quat(wc * h1)
        Jr = so3.left_jacobian(-wc * h1)  # right Jacobian of exp(wc*h)
        Ra = R @ so3.hat(ac)
        Rac = _mv(R, ac)

        new_dp = dp + dv * h1 + 0.5 * Rac * h1 * h1
        new_dv = dv + Rac * h1
        new_dq = so3.quat_multiply(dq, dR_inc)

        # bias Jacobians (Forster eq. 69-70 discrete forms)
        Rinc_T = so3.quat_to_rot(dR_inc).mT
        new_Jpba = Jpba + Jvba * h2 - 0.5 * R * h2 * h2
        new_Jpbg = Jpbg + Jvbg * h2 - 0.5 * Ra @ Jqbg * h2 * h2
        new_Jvba = Jvba - R * h2
        new_Jvbg = Jvbg - Ra @ Jqbg * h2
        new_Jqbg = Rinc_T @ Jqbg - Jr * h2

        # covariance propagation, state [dtheta, dv, dp]
        Z = torch.zeros_like(R)
        A = torch.cat([
            torch.cat([Rinc_T, Z, Z], dim=-1),
            torch.cat([-Ra * h2, I3, Z], dim=-1),
            torch.cat([-0.5 * Ra * h2 * h2, I3 * h2, I3], dim=-1),
        ], dim=-2)
        B = torch.cat([
            torch.cat([Jr * h2, Z], dim=-1),
            torch.cat([Z, R * h2], dim=-1),
            torch.cat([Z, 0.5 * R * h2 * h2], dim=-1),
        ], dim=-2)
        hq = torch.clamp(h, min=1e-9)[..., None]
        q_diag = torch.cat([(sg2 / hq).expand(batch + (3,)),
                            (sa2 / hq).expand(batch + (3,))], dim=-1)
        Q = torch.diag_embed(q_diag)
        P = A @ P @ A.mT + B @ Q @ B.mT
        dq, dv, dp = new_dq, new_dv, new_dp
        Jqbg, Jvbg, Jvba, Jpbg, Jpba = (new_Jqbg, new_Jvbg, new_Jvba,
                                        new_Jpbg, new_Jpba)
    eye9 = torch.eye(9, dtype=dtype, device=dev)
    return PreintegratedImu(
        dq=dq, dv=dv, dp=dp, dt_total=torch.sum(dts, dim=-1),
        J_q_bg=Jqbg, J_v_bg=Jvbg, J_v_ba=Jvba, J_p_bg=Jpbg, J_p_ba=Jpba,
        cov=P + 1e-12 * eye9,
        bg_ref=bg.expand(batch + (3,)), ba_ref=ba.expand(batch + (3,)),
    )


def imu_residual(pim: PreintegratedImu, q_i, p_i, v_i, q_j, p_j, v_j,
                 bg_i, ba_i, gravity=GRAVITY):
    """9-dim preintegration residual [r_R, r_v, r_p] (unwhitened), with
    first-order bias corrections:

      ΔR' = ΔR exp(J_q_bg (bg_i - bg_ref))
      Δv' = Δv + J_v_bg dbg + J_v_ba dba     (and similarly Δp')
      r_R = log(ΔR'⁻¹ R_i⁻¹ R_j)
      r_v = R_i⁻¹ (v_j − v_i − g Δt) − Δv'
      r_p = R_i⁻¹ (p_j − p_i − v_i Δt − ½ g Δt²) − Δp'

    ``gravity`` is a 3-sequence or a (3,) tensor."""
    g = gravity if isinstance(gravity, torch.Tensor) else vec3(gravity, p_i)
    dbg = bg_i - pim.bg_ref
    dba = ba_i - pim.ba_ref
    dt = pim.dt_total[..., None]

    dq_corr = so3.quat_multiply(pim.dq, so3.exp_quat(_mv(pim.J_q_bg, dbg)))
    dv_corr = pim.dv + _mv(pim.J_v_bg, dbg) + _mv(pim.J_v_ba, dba)
    dp_corr = pim.dp + _mv(pim.J_p_bg, dbg) + _mv(pim.J_p_ba, dba)

    qi_inv = so3.quat_inverse(q_i)
    r_R = so3.log_quat(
        so3.quat_multiply(so3.quat_inverse(dq_corr),
                          so3.quat_multiply(qi_inv, q_j))
    )
    r_v = so3.quat_rotate(qi_inv, v_j - v_i - g * dt) - dv_corr
    r_p = (
        so3.quat_rotate(qi_inv, p_j - p_i - v_i * dt - 0.5 * g * dt * dt)
        - dp_corr
    )
    return torch.cat([r_R, r_v, r_p], dim=-1)


@f32_matmuls
def imu_sqrt_info(pim: PreintegratedImu) -> torch.Tensor:
    """Whitening matrix: the inverse Cholesky factor of the preintegration
    covariance (L^-1 with cov = L L^T), so r_white = sqrt_info @ r."""
    L = torch.linalg.cholesky(pim.cov)
    eye = torch.eye(9, dtype=L.dtype, device=L.device).expand(L.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def simulate_imu(q_traj, p_traj, v_traj, dt, bg=None, ba=None,
                 gravity=GRAVITY, generator: torch.Generator | None = None,
                 gyro_sigma=0.0, accel_sigma=0.0):
    """Consistent IMU samples from a smooth trajectory: body rates from
    consecutive orientations, specific force from acceleration minus
    gravity; Gaussian noise drawn from ``generator`` when one is given."""
    g = vec3(gravity, p_traj)
    dq = so3.quat_multiply(so3.quat_inverse(q_traj[:-1]), q_traj[1:])
    gyro = so3.log_quat(dq) / dt
    a_world = (v_traj[1:] - v_traj[:-1]) / dt
    accel = so3.quat_rotate(so3.quat_inverse(q_traj[:-1]), a_world - g)
    if bg is not None:
        gyro = gyro + bg
    if ba is not None:
        accel = accel + ba
    if generator is not None:
        gyro = gyro + gyro_sigma * torch.randn(
            gyro.shape, generator=generator, dtype=gyro.dtype,
            device=gyro.device)
        accel = accel + accel_sigma * torch.randn(
            accel.shape, generator=generator, dtype=accel.dtype,
            device=accel.device)
    return gyro, accel
