"""2-axis gimbal dynamics with PID attitude tracking (port of
``libwave_tpu.kinematics.gimbal``).

The reference's ``Gimbal2AxisModel`` / ``Gimbal2AxisController``
(wave_kinematics/include/wave/kinematics/gimbal.hpp:24,66; src/gimbal.cpp):
4-state [roll, roll_vel, pitch, pitch_vel] double-integrator joints, joint
setpoints tracking a world-frame target attitude compensated by the frame
(mount) orientation, and target-in-body-frame geometry for pointing the
camera at a 3D target (gimbal.cpp getTargetInBF/getTargetInBPF/
trackTarget). The controller's rate limit is a ``torch.where`` on the
accumulated time, over every field of its PID states.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libwave_tpu_torch.controls.pid import (
    PIDGains,
    PIDState,
    pid_init,
    pid_update,
    select,
)
from libwave_tpu_torch.geometry import euler as euler_mod
from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.utils.device import resolve


class GimbalParams(NamedTuple):
    Ix: float = 0.01
    camera_offset_rpy: tuple = (0.0, 0.0, 0.0)  # mount rotation (321 euler)
    camera_offset_pos: tuple = (0.0, 0.0, 0.0)


class GimbalState(NamedTuple):
    states: torch.Tensor  # (4,) [roll, roll_vel, pitch, pitch_vel]
    joint_orientation: torch.Tensor  # (4,) quaternion of joint angles
    frame_orientation: torch.Tensor  # (4,) quaternion of mount frame
    target_attitude_if: torch.Tensor  # (2,) [roll, pitch] target, inertial
    joint_setpoints: torch.Tensor  # (2,)
    pids: PIDState  # (2,) roll/pitch joint PIDs
    ctrl_dt: torch.Tensor  # () accumulated controller time
    ctrl_outputs: torch.Tensor  # (2,) held outputs


# The reference package's gains, chosen for discrete stability at dt = 1 ms
# (the derivative term acts through a one-step delay).
JOINT_GAINS = PIDGains(k_p=150.0, k_i=0.0, k_d=2.0)


def gimbal_init(dtype=torch.float32, device=None) -> GimbalState:
    device = resolve(device)
    q = so3.quat_identity((), dtype, device)
    z2 = torch.zeros(2, dtype=dtype, device=device)
    return GimbalState(
        states=torch.zeros(4, dtype=dtype, device=device),
        joint_orientation=q,
        frame_orientation=q,
        target_attitude_if=z2,
        joint_setpoints=z2,
        pids=pid_init((2,), dtype, device),
        ctrl_dt=torch.zeros((), dtype=dtype, device=device),
        ctrl_outputs=z2,
    )


def gimbal_set_frame_orientation(s: GimbalState, q_frame) -> GimbalState:
    """Set mount orientation, discarding yaw (gimbal.cpp
    setFrameOrientation)."""
    e = euler_mod.quat2euler(q_frame, 321)
    e = torch.cat([e[..., :2], torch.zeros_like(e[..., 2:])], dim=-1)
    return s._replace(frame_orientation=euler_mod.euler2quat(e, 321))


def gimbal_step(p: GimbalParams, s: GimbalState, motor_inputs,
                dt) -> GimbalState:
    """Integrate joint double-integrators and refresh joint orientation and
    setpoints (gimbal.cpp Gimbal2AxisModel::update)."""
    ph, phv, th, thv = s.states[0], s.states[1], s.states[2], s.states[3]
    states = torch.stack(
        [
            ph + phv * dt,
            phv + motor_inputs[0] / p.Ix * dt,
            th + thv * dt,
            thv + motor_inputs[1] / p.Ix * dt,
        ]
    )
    joint_q = euler_mod.euler2quat(
        torch.stack([states[0], states[2], torch.zeros_like(states[0])]), 321
    )
    frame_euler = euler_mod.quat2euler(s.frame_orientation, 321)
    setpoints = s.target_attitude_if - frame_euler[:2]
    return s._replace(
        states=states, joint_orientation=joint_q, joint_setpoints=setpoints
    )


def gimbal_attitude_control(s: GimbalState, dt):
    """Joint PIDs -> motor inputs, rate-limited to 1 kHz
    (gimbal.cpp Gimbal2AxisController::update)."""
    acc = s.ctrl_dt + dt
    ready = acc >= 0.001
    actual = torch.stack([s.states[0], s.states[2]])
    out, new_pids = pid_update(JOINT_GAINS, s.pids, s.joint_setpoints,
                               actual, dt)
    outputs = torch.where(ready, out, s.ctrl_outputs)
    return outputs, s._replace(
        pids=select(ready, new_pids, s.pids),
        ctrl_dt=torch.where(ready, 0.0, acc),
        ctrl_outputs=outputs,
    )


def target_in_body_frame(p: GimbalParams,
                         target_cf: torch.Tensor) -> torch.Tensor:
    """Camera-frame (EDN) target -> gimbal body frame via the mount offset
    (gimbal.cpp getTargetInBF)."""
    # camera frame (x-right, y-down, z-forward) -> NWU
    target_nwu = torch.stack(
        [target_cf[..., 2], -target_cf[..., 0], -target_cf[..., 1]], dim=-1
    )
    like = dict(dtype=target_cf.dtype, device=target_cf.device)
    R = euler_mod.euler2rot(torch.tensor(p.camera_offset_rpy, **like), 321)
    t = torch.tensor(p.camera_offset_pos, **like)
    return torch.einsum("ij,...j->...i", R, target_nwu) + t


def gimbal_track_target(p: GimbalParams, s: GimbalState,
                        target_cf) -> GimbalState:
    """Update the target attitude so the camera points at a camera-frame
    target (gimbal.cpp trackTarget): into the body planar frame, then
    roll = asin(y/d), pitch = -asin(x/d)."""
    tb = target_in_body_frame(p, target_cf)
    R_body = so3.quat_to_rot(s.frame_orientation)
    R_joint = so3.quat_to_rot(s.joint_orientation)
    tbpf = R_body @ (R_joint @ tb)
    dist = torch.linalg.vector_norm(tbpf)
    target_att = torch.stack(
        [torch.arcsin(tbpf[1] / dist), -torch.arcsin(tbpf[0] / dist)]
    )
    return s._replace(target_attitude_if=target_att)
