"""12-state quadrotor dynamics with cascaded PID control (port of
``libwave_tpu.kinematics.quadrotor``).

The reference's ``QuadrotorModel`` + ``AttitudeController`` +
``PositionController`` (wave_kinematics/include/wave/kinematics/
quadrotor.hpp:18,41,63; src/quadrotor.cpp):

- Euler-integrated rigid-body dynamics: 321-euler attitude kinematics,
  gyroscopic + rotational-drag torques, thrust mapped through the attitude
  into world-frame acceleration with translational drag and gravity
  (quadrotor.cpp ``QuadrotorModel::update``).
- Motor mixing ``tau = A @ motors`` with the plus-configuration
  allocation matrix (arm length ``l``, drag coefficient ``d``;
  :func:`mixing_matrix`), computed row by row.
- Attitude controller: 3 PIDs (roll/pitch/yaw) + relative thrust scaled to
  ``max_thrust``, mixed to 4 motor commands clipped to [0, max_thrust],
  yaw error wrapped to ±180° (quadrotor.cpp AttitudeController::update).
- Position controller: world-frame position error rotated into the
  body-yaw frame, x/y/z PIDs producing [roll, pitch, yaw, thrust]
  setpoints with ±30° roll/pitch limits, thrust base 0.5, "yaw-first"
  gating when the yaw error exceeds 2° (PositionController::update).

The rate limits (attitude 1 kHz, position 100 Hz) are accumulated-time
tests that select, field by field with ``torch.where``, between the new
and the held controller state.
"""

from __future__ import annotations

import math
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
from libwave_tpu_torch.utils.device import resolve


class QuadrotorParams(NamedTuple):
    Ix: float = 0.0963
    Iy: float = 0.0963
    Iz: float = 0.1927
    kr: float = 0.1  # rotational drag
    kt: float = 0.2  # translational drag
    l: float = 0.9  # arm length
    d: float = 1.0  # drag torque coefficient
    m: float = 1.0
    g: float = 10.0
    max_thrust: float = 5.0


class QuadrotorState(NamedTuple):
    attitude: torch.Tensor  # (3,) [roll, pitch, yaw]
    angular_velocity: torch.Tensor  # (3,) body rates [p, q, r]
    position: torch.Tensor  # (3,)
    linear_velocity: torch.Tensor  # (3,)
    # controller internal state
    att_pids: PIDState  # (3,) roll/pitch/yaw
    pos_pids: PIDState  # (3,) x/y/z
    att_dt: torch.Tensor  # () time since the last attitude update
    pos_dt: torch.Tensor  # ()
    att_outputs: torch.Tensor  # (4,) last motor outputs (rate-held)
    pos_outputs: torch.Tensor  # (4,) last [r, p, y, t] setpoints (held)


ATT_GAINS = PIDGains(k_p=200.0, k_i=0.5, k_d=10.0)
POS_GAINS_XY = PIDGains(k_p=0.5, k_i=0.0, k_d=0.035)
POS_GAINS_Z = PIDGains(k_p=0.5, k_i=0.0, k_d=0.018)


def quadrotor_init(pose=None, dtype=torch.float32,
                   device=None) -> QuadrotorState:
    """Rest state; ``pose`` = [x, y, z, roll, pitch, yaw] if given."""
    device = resolve(device)
    z3 = torch.zeros(3, dtype=dtype, device=device)
    if pose is not None:
        pose = torch.as_tensor(pose, dtype=dtype, device=device)
    att = z3 if pose is None else pose[3:6]
    pos = z3 if pose is None else pose[0:3]
    z = torch.zeros((), dtype=dtype, device=device)
    z4 = torch.zeros(4, dtype=dtype, device=device)
    return QuadrotorState(
        attitude=att,
        angular_velocity=z3,
        position=pos,
        linear_velocity=z3,
        att_pids=pid_init((3,), dtype, device),
        pos_pids=pid_init((3,), dtype, device),
        att_dt=z,
        pos_dt=z,
        att_outputs=z4,
        pos_outputs=z4,
    )


def mixing_matrix(p: QuadrotorParams, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Motor -> generalized-force allocation (quadrotor.cpp update A
    matrix)."""
    return torch.tensor(
        [
            [1.0, 1.0, 1.0, 1.0],
            [0.0, -p.l, 0.0, p.l],
            [-p.l, 0.0, p.l, 0.0],
            [-p.d, p.d, -p.d, p.d],
        ],
        dtype=dtype,
        device=resolve(device),
    )


def quadrotor_dynamics(
    p: QuadrotorParams, s: QuadrotorState, motors: torch.Tensor, dt
) -> QuadrotorState:
    """Euler-integrate the 12-state rigid body under 4 motor thrusts."""
    ph, th, ps = s.attitude[0], s.attitude[1], s.attitude[2]
    w = s.angular_velocity
    pq, qq, rq = w[0], w[1], w[2]

    # tau = mixing_matrix(p) @ motors, row by row: no host matrix is
    # copied to the device on every step
    m1, m2, m3, m4 = motors[0], motors[1], motors[2], motors[3]
    tauf = m1 + m2 + m3 + m4
    taup = p.l * (m4 - m2)
    tauq = p.l * (m3 - m1)
    taur = p.d * (m2 + m4 - m1 - m3)

    sph, cph, tth = torch.sin(ph), torch.cos(ph), torch.tan(th)
    att_dot = torch.stack(
        [
            pq + qq * sph * tth + rq * cph * tth,
            qq * cph - rq * sph,
            (qq * sph + rq * cph) / torch.cos(th),
        ]
    )
    w_dot = torch.stack(
        [
            -((p.Iz - p.Iy) / p.Ix) * qq * rq - p.kr * pq / p.Ix + taup / p.Ix,
            -((p.Ix - p.Iz) / p.Iy) * pq * rq - p.kr * qq / p.Iy + tauq / p.Iy,
            -((p.Iy - p.Ix) / p.Iz) * pq * qq - p.kr * rq / p.Iz + taur / p.Iz,
        ]
    )
    v = s.linear_velocity
    thrust_dir = torch.stack(
        [
            cph * torch.sin(th) * torch.cos(ps) + sph * torch.sin(ps),
            cph * torch.sin(th) * torch.sin(ps) - sph * torch.cos(ps),
            cph * torch.cos(th),
        ]
    )
    gravity = torch.cat([torch.zeros_like(v[:2]), torch.full_like(v[2:], p.g)])
    v_dot = -p.kt * v / p.m + thrust_dir * tauf / p.m - gravity

    attitude = s.attitude + att_dot * dt
    attitude = torch.cat([attitude[:2], euler_mod.wrap_to_pi(attitude[2:])])
    return s._replace(
        attitude=attitude,
        angular_velocity=w + w_dot * dt,
        position=s.position + v * dt,
        linear_velocity=v + v_dot * dt,
    )


def quadrotor_attitude_control(
    p: QuadrotorParams, s: QuadrotorState, setpoints: torch.Tensor, dt
):
    """Attitude PID cascade -> 4 motor outputs, rate-limited to 1 kHz.

    ``setpoints`` = [roll, pitch, yaw, relative_thrust in [0,1]].
    Returns (motors, new_state).
    """
    acc = s.att_dt + dt
    ready = acc >= 0.001

    err_yaw = euler_mod.wrap_to_pi(setpoints[2] - s.attitude[2])
    sp = torch.stack([setpoints[0], setpoints[1], err_yaw])
    actual = torch.stack([s.attitude[0], s.attitude[1],
                          torch.zeros_like(err_yaw)])
    out, new_pids = pid_update(ATT_GAINS, s.att_pids, sp, actual, acc)
    r, pch, y = out[0], out[1], out[2]
    t = torch.clip(p.max_thrust * setpoints[3], 0.0, p.max_thrust)
    motors = torch.stack([-pch - y + t, -r + y + t, pch - y + t, r + y + t])
    motors = torch.clip(motors, 0.0, p.max_thrust)

    motors_out = torch.where(ready, motors, s.att_outputs)
    new_state = s._replace(
        att_pids=select(ready, new_pids, s.att_pids),
        att_dt=torch.where(ready, 0.0, acc),
        att_outputs=motors_out,
    )
    return motors_out, new_state


_MAX_TILT = math.radians(30.0)
_YAW_FIRST = math.radians(2.0)


def quadrotor_position_control(
    p: QuadrotorParams, s: QuadrotorState, setpoints: torch.Tensor, yaw, dt
):
    """Position PID cascade -> [roll, pitch, yaw, thrust] attitude
    setpoints, rate-limited to 100 Hz. ``setpoints`` = world [x, y, z]."""
    acc = s.pos_dt + dt
    ready = acc >= 0.01

    err_world = setpoints - s.position
    # the error in the yaw-aligned (body planar) frame: Rz(yaw)^T
    cz, sz = torch.cos(s.attitude[2]), torch.sin(s.attitude[2])
    err = torch.stack(
        [
            cz * err_world[0] + sz * err_world[1],
            -sz * err_world[0] + cz * err_world[1],
            err_world[2],
        ]
    )
    pids = s.pos_pids
    outs, new = zip(*(
        pid_update(gains, PIDState(pids.error_prev[k], pids.error_sum[k]),
                   err[k], 0.0, dt)
        for k, gains in enumerate((POS_GAINS_XY, POS_GAINS_XY, POS_GAINS_Z))))
    out_x, out_y, out_z = outs
    roll = torch.clip(-out_y, -_MAX_TILT, _MAX_TILT)
    pitch = torch.clip(out_x, -_MAX_TILT, _MAX_TILT)
    thrust = torch.clip(0.5 + out_z, 0.0, 1.0)
    # yaw-first gating: level the craft until the yaw error is small
    yaw = torch.as_tensor(yaw, dtype=roll.dtype, device=roll.device)
    yaw_far = torch.abs(yaw - s.attitude[2]) > _YAW_FIRST
    roll = torch.where(yaw_far, 0.0, roll)
    pitch = torch.where(yaw_far, 0.0, pitch)
    outputs = torch.stack([roll, pitch, yaw, thrust])

    outputs_held = torch.where(ready, outputs, s.pos_outputs)
    new_pids = PIDState(
        error_prev=torch.stack([n.error_prev for n in new]),
        error_sum=torch.stack([n.error_sum for n in new]),
    )
    new_state = s._replace(
        pos_pids=select(ready, new_pids, s.pos_pids),
        pos_dt=torch.where(ready, 0.0, acc),
        pos_outputs=outputs_held,
    )
    return outputs_held, new_state


def quadrotor_step(
    p: QuadrotorParams, s: QuadrotorState, pos_setpoint: torch.Tensor, yaw,
    dt
) -> QuadrotorState:
    """One closed-loop step: position control -> attitude control ->
    dynamics (the reference tests' hover/waypoint stack)."""
    att_sp, s = quadrotor_position_control(p, s, pos_setpoint, yaw, dt)
    motors, s = quadrotor_attitude_control(p, s, att_sp, dt)
    return quadrotor_dynamics(p, s, motors, dt)
