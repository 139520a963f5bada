"""Parity of libwave_tpu_torch.{controls,kinematics} with libwave_tpu's:
PID, two-wheel, gimbal and quadrotor roll-outs of 200 steps at f64 on the
same inputs, every state within 1e-9 of the JAX package's (its roll-outs
under ``lax.scan``); and every case of tests/test_kinematics.py on the
port.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.controls import pid as jpid
from libwave_tpu.kinematics import gimbal as jg
from libwave_tpu.kinematics import pose as jpose
from libwave_tpu.kinematics import quadrotor as jq
from libwave_tpu.kinematics import two_wheel as jtw
from libwave_tpu_torch import interop
from libwave_tpu_torch.controls import pid as tpid
from libwave_tpu_torch.kinematics import gimbal as tg
from libwave_tpu_torch.kinematics import pose as tpose
from libwave_tpu_torch.kinematics import quadrotor as tq
from libwave_tpu_torch.kinematics import two_wheel as ttw

STEPS = 200
F64 = torch.float64


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def close_tree(t, j, atol=1e-9):
    for a, b in zip(jax.tree.leaves(j), torch.utils._pytree.tree_leaves(t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=atol)


# -------------------------------------------------------------------------
# 200-step roll-outs against the JAX package
# -------------------------------------------------------------------------


def test_pid_rollout_matches_jax(rng):
    sp = rng.normal(size=(STEPS, 3))
    act = rng.normal(size=(STEPS, 3))
    gj = jpid.PIDGains(*(jnp.asarray(g) for g in ([1.5, 0.7, 2.0],
                                                    [0.1, 0.0, 0.3],
                                                    [0.05, 0.2, 0.0])))
    gt = tpid.PIDGains(*(t64(np.asarray(g)) for g in gj))

    def step(s, x):
        out, s = jpid.pid_update(gj, s, x[0], x[1], 0.01)
        return s, out

    sj, outs_j = jax.lax.scan(step, jpid.pid_init((3,), jnp.float64),
                              jnp.stack([jnp.asarray(sp), jnp.asarray(act)],
                                        axis=1))
    st = tpid.pid_init((3,), F64, device="cpu")
    outs_t = []
    for k in range(STEPS):
        out, st = tpid.pid_update(gt, st, t64(sp[k]), t64(act[k]), 0.01)
        outs_t.append(out)
    close_tree(torch.stack(outs_t), outs_j)
    close_tree(st, sj)


def test_two_wheel_rollout_matches_jax(rng):
    u = np.stack([rng.uniform(0.5, 1.5, STEPS), rng.normal(0, 0.5, STEPS)],
                 axis=-1)
    pose0 = np.array([0.3, -0.2, 0.1])
    tj = jtw.simulate_two_wheel(jnp.asarray(pose0), jnp.asarray(u), 0.01)
    tt = ttw.simulate_two_wheel(t64(pose0), t64(u), 0.01)
    assert tt.shape == (STEPS, 3)
    close_tree(tt, tj)


def test_gimbal_rollout_matches_jax(rng):
    p = jg.GimbalParams(camera_offset_rpy=(0.05, -0.02, 0.1),
                        camera_offset_pos=(0.01, 0.0, -0.02))
    pt = tg.GimbalParams(*p)
    targets = rng.normal(size=(STEPS, 3)) + np.array([0.0, 2.0, 1.0])
    q_frame = np.array([0.99, 0.05, -0.08, 0.03])
    q_frame /= np.linalg.norm(q_frame)

    def step(s, target):
        s = jg.gimbal_track_target(p, s, target)
        motors, s = jg.gimbal_attitude_control(s, 0.001)
        return jg.gimbal_step(p, s, motors, 0.001), s.states

    s0j = jg.gimbal_set_frame_orientation(jg.gimbal_init(jnp.float64),
                                          jnp.asarray(q_frame))
    sj, hist_j = jax.jit(lambda s, x: jax.lax.scan(step, s, x))(
        s0j, jnp.asarray(targets))
    st = tg.gimbal_set_frame_orientation(tg.gimbal_init(F64, device="cpu"),
                                         t64(q_frame))
    hist_t = []
    for k in range(STEPS):
        st = tg.gimbal_track_target(pt, st, t64(targets[k]))
        motors, st = tg.gimbal_attitude_control(st, 0.001)
        hist_t.append(st.states)
        st = tg.gimbal_step(pt, st, motors, 0.001)
    close_tree(torch.stack(hist_t), hist_j)
    close_tree(st, sj)


def test_quadrotor_rollout_matches_jax():
    p = jq.QuadrotorParams()
    pose0 = np.array([0.1, -0.2, 0.5, 0.02, -0.01, 0.3])
    target = np.array([1.0, 0.5, 2.0])
    dt = 0.001  # the JAX test's step, and chip_smoke.py's leaves phase's

    def step(s, _):
        s = jq.quadrotor_step(p, s, jnp.asarray(target), 0.2, dt)
        return s, s.position

    sj, hist_j = jax.jit(lambda s: jax.lax.scan(step, s, None, STEPS))(
        jq.quadrotor_init(jnp.asarray(pose0), jnp.float64))
    st = tq.quadrotor_init(pose0, F64, device="cpu")
    hist_t = []
    for _ in range(STEPS):
        st = tq.quadrotor_step(p, st, t64(target), 0.2, dt)
        hist_t.append(st.position)
    close_tree(torch.stack(hist_t), hist_j)
    close_tree(st, sj)
    np.testing.assert_array_equal(tq.mixing_matrix(p, F64, "cpu").numpy(),
                                  np.asarray(jq.mixing_matrix(p,
                                                              jnp.float64)))


def test_states_carried_across():
    sj = jq.quadrotor_init(jnp.arange(6.0), jnp.float64)
    st = interop.quadrotor_state_from_jax_numpy(jax.tree.map(np.asarray, sj),
                                                device="cpu")
    close_tree(st, sj, atol=0.0)
    gj = jg.gimbal_init(jnp.float64)
    close_tree(interop.gimbal_state_from_jax_numpy(
        jax.tree.map(np.asarray, gj), device="cpu"), gj, atol=0.0)
    pj = jpid.pid_init((2,), jnp.float64)
    close_tree(interop.pid_state_from_jax_numpy(
        jax.tree.map(np.asarray, pj), device="cpu"), pj, atol=0.0)


def test_pose_record():
    pj = jpose.Pose.identity((2,), jnp.float64)
    pt = tpose.Pose.identity((2,), F64, device="cpu")
    close_tree(pt, pj, atol=0.0)
    close_tree(pt.rotation_matrix(), pj.rotation_matrix(), atol=0.0)


# -------------------------------------------------------------------------
# tests/test_kinematics.py on the port
# -------------------------------------------------------------------------


def gains(kp, ki, kd):
    return tpid.PIDGains(k_p=t64(kp), k_i=t64(ki), k_d=t64(kd))


def test_pid_terms():
    out, _ = tpid.pid_update(gains(2.0, 0.0, 0.0),
                             tpid.pid_init(device="cpu"), 1.0, 0.0, 0.1)
    assert abs(float(out) - 2.0) < 1e-6
    st = tpid.pid_init(device="cpu")
    out1, st = tpid.pid_update(gains(0.0, 1.0, 0.0), st, 1.0, 0.0, 0.5)
    out2, st = tpid.pid_update(gains(0.0, 1.0, 0.0), st, 1.0, 0.0, 0.5)
    assert abs(float(out1) - 0.5) < 1e-6 and abs(float(out2) - 1.0) < 1e-6
    st = tpid.pid_init(device="cpu")
    out1, st = tpid.pid_update(gains(0.0, 0.0, 1.0), st, 1.0, 0.0, 0.1)
    out2, st = tpid.pid_update(gains(0.0, 0.0, 1.0), st, 1.0, 0.0, 0.1)
    assert abs(float(out1) - 10.0) < 1e-5 and abs(float(out2)) < 1e-6


def test_two_wheel_straight_line_and_circle():
    pose = torch.zeros(3, dtype=F64)
    for _ in range(100):
        pose = ttw.two_wheel_step(pose, t64([1.0, 0.0]), 0.01)
    np.testing.assert_allclose(pose.numpy(), [1.0, 0.0, 0.0], atol=1e-9)
    r, v, dt, steps = 0.5, 1.0, 0.01, 300
    w = v / r
    traj = ttw.simulate_two_wheel(torch.zeros(3, dtype=F64),
                                  t64([v, w]).expand(steps, 2), dt)
    np.testing.assert_allclose(float(traj[-1, 2]), w * steps * dt, atol=1e-9)
    radii = torch.linalg.vector_norm(traj[:, :2] - t64([0.0, r]), dim=-1)
    assert float(torch.max(torch.abs(radii - r))) < 0.02


def test_quadrotor_hover_thrust_equilibrium():
    p = tq.QuadrotorParams()
    s = tq.quadrotor_init(dtype=F64, device="cpu")
    motors = torch.full((4,), p.m * p.g / 4.0, dtype=F64)
    for _ in range(50):
        s = tq.quadrotor_dynamics(p, s, motors, 0.001)
    np.testing.assert_allclose(s.position.numpy(), 0.0, atol=1e-9)
    np.testing.assert_allclose(s.attitude.numpy(), 0.0, atol=1e-9)


def test_quadrotor_closed_loop_hover_converges():
    """After 6 simulated seconds at 1 kHz the craft is near the commanded
    hover point (the reference quadrotor_test's behaviour)."""
    p = tq.QuadrotorParams()
    s = tq.quadrotor_init(dtype=F64, device="cpu")
    target = t64([1.0, 0.0, 2.0])
    for _ in range(6000):
        s = tq.quadrotor_step(p, s, target, 0.0, 0.001)
    assert float(torch.linalg.vector_norm(s.position - target)) < 0.3


def test_gimbal_tracks_attitude():
    p = tg.GimbalParams()
    s = tg.gimbal_init(F64, device="cpu")._replace(
        target_attitude_if=t64([0.2, -0.1]))
    for _ in range(4000):
        motors, s = tg.gimbal_attitude_control(s, 0.001)
        s = tg.gimbal_step(p, s, motors, 0.001)
    assert abs(float(s.states[0]) - 0.2) < 0.01
    assert abs(float(s.states[2]) + 0.1) < 0.01


def test_gimbal_track_target_geometry():
    p = tg.GimbalParams()
    s = tg.gimbal_track_target(p, tg.gimbal_init(F64, device="cpu"),
                               t64([0.0, 1.0, 0.0]))
    np.testing.assert_allclose(s.target_attitude_if.numpy(), [0.0, 0.0],
                               atol=1e-12)
    s = tg.gimbal_track_target(p, tg.gimbal_init(F64, device="cpu"),
                               t64([0.0, 1.0, 1.0]))
    np.testing.assert_allclose(s.target_attitude_if.numpy(),
                               [0.0, -math.asin(1.0 / math.sqrt(2.0))],
                               atol=1e-12)
