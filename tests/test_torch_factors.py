"""Parity of libwave_tpu_torch.optim.{states,factors} with libwave_tpu's:
every case of tests/test_factors.py on the port, each held against the JAX
package on the same numpy inputs at f64; every residual bank within 1e-12,
the Jacobian of the stacked residual (forward mode on both sides) within
1e-10, and ``solve_trajectory_gn``'s whole cost trace within rtol 1e-9 and
its final states within 1e-9 (costs that reach rounding level, where the
optimum's residual is zero, within 1e-20 of the initial cost): on the
priors problem, the JAX test's GPS-with-bias problem and the smoother of
``chip_smoke.py``'s gps_trajectory phase cut to 12 states
(``bench_trajectory``: LLH fixes through ``world_frame``, a
``MeasurementBuffer`` and the factor banks; see that test for how the
conversion's rounding is held apart). A
solve whose damped system fails rejects the step in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajectory_anchors
from libwave_tpu.geometry import se3 as jse3
from libwave_tpu.geometry import so3 as jso3
from libwave_tpu.geometry.se3 import SE3 as JSE3
from libwave_tpu.optim import factors as jf
from libwave_tpu.optim import states as jst
from libwave_tpu_torch import bench_trajectory as bt
from libwave_tpu_torch import interop
from libwave_tpu_torch.geometry import se3, so3
from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.optim import factors as tf
from libwave_tpu_torch.optim import states as tst

STATES = ("PoseVelState", "PoseVelBiasState", "PoseVelAccBiasState")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def close(t, j, rtol=0.0, atol=1e-12):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


def rand_state(rng, name, T):
    q = rng.normal(size=(T, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q *= np.sign(q[:, :1])
    fields = {"q": q, "p": rng.normal(size=(T, 3)),
              "vel": rng.normal(size=(T, 6))}
    cls = getattr(jst, name)
    if "accel" in cls._fields:
        fields["accel"] = rng.normal(size=(T, 6))
    if "bias" in cls._fields:
        fields["bias"] = rng.normal(size=(T, 3))
    js = cls(**{k: jnp.asarray(v) for k, v in fields.items()})
    return js, interop.trajectory_state_from_jax_numpy(
        jax.tree.map(np.asarray, js), device="cpu")


def rand_se3(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(size=(n, 3))
    return JSE3(q=jnp.asarray(q), t=jnp.asarray(t)), SE3(q=t64(q), t=t64(t))


# -------------------------------------------------------------------------
# states
# -------------------------------------------------------------------------


@pytest.mark.parametrize("name", STATES)
def test_retract_local_match_jax(rng, name):
    js, ts = rand_state(rng, name, 5)
    dx = 0.3 * rng.normal(size=(5, js.DIM))
    jr, tr = js.retract(jnp.asarray(dx)), ts.retract(t64(dx))
    assert type(tr).__name__ == name and tr.DIM == js.DIM
    for a, b in zip(jr, tr):
        close(b, a)
    close(ts.local(tr), js.local(jr))
    close(ts.local(tr), dx, atol=1e-9)  # the round trip


@pytest.mark.parametrize("name", STATES)
def test_identity(name):
    ts = getattr(tst, name).identity(3, device="cpu")
    js = getattr(jst, name).identity(3)
    for a, b in zip(js, ts):
        close(b, a, atol=0.0)
    assert ts.p.dtype == torch.float64


def test_posevel_roundtrip(rng):
    """tests/test_factors.py TestStates.test_posevel_dim."""
    st = tst.PoseVelState.identity(3, device="cpu")
    dx = t64(0.2 * rng.normal(size=(3, 12)))
    close(st.local(st.retract(dx)), dx, atol=1e-9)


# -------------------------------------------------------------------------
# residual banks
# -------------------------------------------------------------------------


def _banks(js, ts, rng, T):
    """(name, jax residual, port residual) for every bank at vectorized
    indices, on the same numpy data."""
    i = np.array([0, 2, 3, 1])
    j = np.array([1, 3, 4, 4])
    dt = rng.uniform(0.05, 0.5, len(i))
    (jm, tm) = rand_se3(rng, len(i))
    (jp, tp) = rand_se3(rng, len(i))
    pv = rng.normal(size=(len(i), 6))
    pb = rng.normal(size=(len(i), 3))
    w = rng.uniform(0.5, 2.0)
    ji, jj, ti, tj = jnp.asarray(i), jnp.asarray(j), torch.as_tensor(i), \
        torch.as_tensor(j)
    out = [
        ("motion", jf.motion_residual(js, ji, jj, jnp.asarray(dt), w),
         tf.motion_residual(ts, ti, tj, t64(dt), w)),
        ("pose_prior", jf.pose_prior_residual(js, ji, jp, w),
         tf.pose_prior_residual(ts, ti, tp, w)),
        ("twist_prior", jf.twist_prior_residual(js, ji, jnp.asarray(pv), w),
         tf.twist_prior_residual(ts, ti, t64(pv), w)),
    ]
    if hasattr(js, "bias"):
        out += [
            ("gps", jf.gps_residual(js, ji, jm, w),
             tf.gps_residual(ts, ti, tm, w)),
            ("decaying_bias",
             jf.decaying_bias_residual(js, ji, jj, jnp.asarray(dt), 3.0, w),
             tf.decaying_bias_residual(ts, ti, tj, t64(dt), 3.0, w)),
            ("bias_prior", jf.bias_prior_residual(js, ji, jnp.asarray(pb), w),
             tf.bias_prior_residual(ts, ti, t64(pb), w)),
        ]
    return out


@pytest.mark.parametrize("name", STATES)
def test_residual_banks_match_jax(rng, name):
    js, ts = rand_state(rng, name, 5)
    for what, a, b in _banks(js, ts, rng, 5):
        assert b.shape == a.shape, what
        close(b, a, atol=1e-12)


def test_hand_eye_bank_matches_jax(rng):
    (j1, t1), (j2, t2), (j3, t3) = (rand_se3(rng, 6) for _ in range(3))
    b = rng.normal(size=(6, 3))
    close(tf.hand_eye_residual(t1, t2, t64(b), t3, 2.0),
          jf.hand_eye_residual(j1, j2, jnp.asarray(b), j3, 2.0))


@pytest.mark.parametrize("name", STATES)
def test_stacked_jacobian_matches_jax(rng, name):
    """The Jacobian solve_trajectory_gn builds: every bank stacked, through
    the retraction at dx = 0 (each side's forward mode)."""
    T = 5
    js, ts = rand_state(rng, name, T)

    def jax_stacked(d):
        st = js.retract(d.reshape(T, js.DIM))
        return jnp.concatenate(
            [r for _, r, _ in _banks(st, ts, np.random.default_rng(3), T)])

    def port_stacked(d):
        st = ts.retract(d.reshape(T, ts.DIM))
        return torch.cat(
            [r for _, _, r in _banks(js, st, np.random.default_rng(3), T)])

    Jj = jax.jit(jax.jacfwd(jax_stacked))(jnp.zeros(T * js.DIM))
    Jt = torch.func.jacfwd(port_stacked)(
        torch.zeros(T * ts.DIM, dtype=torch.float64))
    assert Jt.shape == Jj.shape
    close(Jt, Jj, atol=1e-10)


# -------------------------------------------------------------------------
# tests/test_factors.py's cases on the port
# -------------------------------------------------------------------------


def _constant_twist(T, dt, vel):
    poses = [SE3.identity(dtype=torch.float64, device="cpu")]
    for _ in range(T - 1):
        poses.append(se3.boxplus(poses[-1], vel * dt))
    return poses


def test_motion_zero_residual_constant_velocity():
    T, dt = 5, 0.1
    vel = t64([0.0, 0.0, 0.2, 1.0, 0.0, 0.0])
    poses = _constant_twist(T, dt, vel)
    st = tst.PoseVelBiasState(
        q=torch.stack([P.q for P in poses]), p=torch.stack([P.t for P in poses]),
        vel=vel.expand(T, 6), bias=torch.zeros(T, 3, dtype=torch.float64))
    i = torch.arange(T - 1)
    close(tf.motion_residual(st, i, i + 1, dt), 0.0, atol=1e-9)


def test_motion_jacobian_matches_reference_structure():
    """H2 = -I and H1 = I + dt coupling (motion_factor_impl.hpp:16-35) at
    identity relative pose, as in the JAX test."""
    dt = 0.25
    st = tst.PoseVelBiasState.identity(2, device="cpu")

    def res(dx):
        return tf.motion_residual(st.retract(dx.reshape(2, 15)),
                                  torch.tensor([0]), torch.tensor([1]), dt)

    J = torch.func.jacfwd(res)(torch.zeros(30, dtype=torch.float64))
    J = J.reshape(15, 2, 15)
    close(J[:, 1, :], -np.eye(15), atol=1e-6)
    expect = np.eye(15)
    expect[0:6, 6:12] = dt * np.eye(6)
    close(J[:, 0, :], expect, atol=1e-6)


def test_gps_zero_residual_at_measurement():
    (jP, tP) = rand_se3(np.random.default_rng(5), 1)
    st = tst.PoseVelBiasState(q=tP.q, p=tP.t,
                              vel=torch.zeros(1, 6, dtype=torch.float64),
                              bias=torch.zeros(1, 3, dtype=torch.float64))
    close(tf.gps_residual(st, torch.tensor([0]), tP), 0.0, atol=1e-9)


def test_gps_bias_shifts_translation():
    st = tst.PoseVelBiasState.identity(1, device="cpu")
    st = st._replace(bias=t64([[0.5, -0.2, 0.1]]))
    meas = SE3.identity((1,), dtype=torch.float64, device="cpu")
    r = tf.gps_residual(st, torch.tensor([0]), meas)
    close(r[0:3], 0.0, atol=1e-12)
    close(r[3:6], [0.5, -0.2, 0.1], atol=1e-9)


def test_hand_eye_zero_and_bias():
    r1 = np.random.default_rng(11)
    (_, A), (_, B) = rand_se3(r1, 1), rand_se3(r1, 1)
    close(tf.hand_eye_residual(A.compose(B), B,
                               torch.zeros(3, dtype=torch.float64), A),
          0.0, atol=1e-9)
    I = SE3.identity(dtype=torch.float64, device="cpu")
    b = t64([0.1, 0.0, 0.0])
    close(tf.hand_eye_residual(SE3(q=I.q, t=b), I, b, I), 0.0, atol=1e-9)


def test_decaying_bias_exact_decay_zero_residual():
    b0 = t64([1.0, -2.0, 0.5])
    tau, dt = 3.0, 0.7
    st = tst.PoseVelBiasState.identity(2, device="cpu")._replace(
        bias=torch.stack([b0, b0 * np.exp(-dt / tau)]))
    close(tf.decaying_bias_residual(st, torch.tensor([0]), torch.tensor([1]),
                                    t64([dt]), tau), 0.0, atol=1e-9)


# -------------------------------------------------------------------------
# solve_trajectory_gn: whole cost traces against the JAX package
# -------------------------------------------------------------------------


def _held(out_t, info_t, out_j, info_j):
    close(info_t["initial_cost"], info_j["initial_cost"], rtol=1e-9, atol=0)
    # costs that reach rounding level (a problem whose optimum has zero
    # residual) differ there: atol 1e-20 of the initial cost
    floor = 1e-20 * float(info_j["initial_cost"])
    close(info_t["costs"], info_j["costs"], rtol=1e-9, atol=floor)
    close(info_t["final_cost"], info_j["final_cost"], rtol=1e-9, atol=floor)
    for a, b in zip(out_j, out_t):
        close(b, a, atol=1e-9)


def test_priors_pull_state():
    """prior_tests.cpp pattern (tests/test_factors.py TestPriors)."""
    r1 = np.random.default_rng(1)
    q = r1.normal(size=4)
    q /= np.linalg.norm(q)
    q *= np.sign(q[0])
    t = r1.normal(size=3)
    target_vel = np.random.default_rng(2).normal(size=6)
    target_bias = np.array([0.1, -0.2, 0.3])
    jprior, tprior = (JSE3(q=jnp.asarray(q), t=jnp.asarray(t)),
                      SE3(q=t64(q), t=t64(t)))
    zero_j, zero_t = jnp.asarray([0]), torch.tensor([0])
    out_j, info_j = jf.solve_trajectory_gn(jst.PoseVelBiasState.identity(1), [
        lambda s: jf.pose_prior_residual(s, zero_j, jprior),
        lambda s: jf.twist_prior_residual(s, zero_j, jnp.asarray(target_vel)),
        lambda s: jf.bias_prior_residual(s, zero_j, jnp.asarray(target_bias)),
    ], num_iters=15)
    out_t, info_t = tf.solve_trajectory_gn(
        tst.PoseVelBiasState.identity(1, device="cpu"), [
            lambda s: tf.pose_prior_residual(s, zero_t, tprior),
            lambda s: tf.twist_prior_residual(s, zero_t, t64(target_vel)),
            lambda s: tf.bias_prior_residual(s, zero_t, t64(target_bias)),
        ], num_iters=15)
    _held(out_t, info_t, out_j, info_j)
    close(out_t.p[0], t, atol=1e-6)
    close(so3.rotation_distance(out_t.q[0], t64(q)), 0.0, atol=1e-6)
    close(out_t.vel[0], target_vel, atol=1e-6)
    close(out_t.bias[0], target_bias, atol=1e-6)
    assert info_t["costs"].shape == (15,)


def test_gps_with_bias_recovery():
    """tests/test_factors.py's GPS-with-bias case, one closure per factor
    as the JAX test builds it, in both packages."""
    T = 6
    step = np.array([0, 0, 0.1, 1.0, 0, 0.0]) * 0.5
    poses_j = [JSE3.identity(dtype=jnp.float64)]
    for _ in range(T - 1):
        poses_j.append(jse3.boxplus(poses_j[-1], jnp.asarray(step)))
    q = np.stack([np.asarray(P.q) for P in poses_j])
    p = np.stack([np.asarray(P.t) for P in poses_j])
    true_bias = np.array([0.3, -0.1, 0.0])

    def problem(mod, states, SE3c, arr, idx):
        st = states.PoseVelBiasState(q=arr(q), p=arr(p + 0.1),
                                     vel=arr(np.zeros((T, 6))),
                                     bias=arr(np.zeros((T, 3))))
        fns = []
        for i in range(T):
            Ti = SE3c(q=arr(q[i:i + 1]), t=arr(p[i:i + 1] + true_bias))
            fns.append(lambda s, i=i, Ti=Ti: mod.gps_residual(s, idx(i), Ti))
        for i in range(T - 1):
            fns.append(lambda s, i=i: mod.decaying_bias_residual(
                s, idx(i), idx(i + 1), arr([0.5]), tau=1e9, sqrt_info=100.0))
        return mod.solve_trajectory_gn(st, fns, num_iters=25)

    out_j, info_j = problem(jf, jst, JSE3, jnp.asarray,
                            lambda i: jnp.asarray([i]))
    out_t, info_t = problem(tf, tst, SE3, t64, lambda i: torch.tensor([i]))
    _held(out_t, info_t, out_j, info_j)
    close(out_t.bias + out_t.p, p + true_bias, atol=1e-6)


def test_gps_smoother_matches_jax():
    """chip_smoke.py's gps_trajectory path at 12 states: LLH fixes ->
    world_frame -> MeasurementBuffer -> factor banks -> LM, in both
    packages from the same numpy arrays. The fixes' ENU agree within 1e-8
    m (the conversion cancels ECEF coordinates of ~6.4e6 m), so the LM is
    held at rtol 1e-9 on the same fixes (the port's); chip_smoke.py holds
    the card's final cost to the JAX package's whole path at 200 states
    (tests/trajectory_anchors.py)."""
    truth = bt.gps_truth(12)
    llh = bt.gps_fixes(truth)
    state_j, fns_j, ok_j = trajectory_anchors.jax_gps_problem(
        truth, trajectory_anchors.jax_gps_enu(llh))
    enu = bt.gps_fixes_enu(llh, "cpu")
    state_t, fns_t, ok_t = bt.gps_problem(truth, enu)
    assert np.array_equal(ok_t.numpy(), np.asarray(ok_j)) and ok_t.all()
    for a, b in zip(state_j, state_t):
        close(b, a, atol=1e-12)
    close(fns_t[0](state_t), fns_j[0](state_j), atol=1e-8)
    state_s, fns_s, _ = trajectory_anchors.jax_gps_problem(truth,
                                                           enu.numpy())
    for fj, ft in zip(fns_s, fns_t):
        close(ft(state_t), fj(state_s), atol=1e-12)
    out_s, info_s = jf.solve_trajectory_gn(state_s, fns_s,
                                           num_iters=bt.GPS_ITERS)
    out_t, info_t = tf.solve_trajectory_gn(state_t, fns_t,
                                           num_iters=bt.GPS_ITERS)
    _held(out_t, info_t, out_s, info_s)
    assert float(info_t["final_cost"]) < float(info_t["initial_cost"])
    err = bt.gps_errors(out_t, truth)
    assert err["bias_m"] < 0.1 and err["position_m"] < 0.1


def test_failed_solve_rejects_step():
    """A bank whose Jacobian squares past f64's range makes the damped
    system inf, the solve NaN and the step's cost NaN: both packages reject
    every step and keep the start."""
    b0 = np.array([[1e-160, 0.0, 0.0]])

    def run(mod, st, arr, idx):
        st = st._replace(bias=arr(b0))
        return mod.solve_trajectory_gn(st, [
            lambda s: mod.bias_prior_residual(s, idx, arr(np.zeros(3)),
                                              sqrt_info=1e155)], num_iters=4)

    out_j, info_j = run(jf, jst.PoseVelBiasState.identity(1), jnp.asarray,
                        jnp.asarray([0]))
    out_t, info_t = run(tf, tst.PoseVelBiasState.identity(1, device="cpu"),
                        t64, torch.tensor([0]))
    _held(out_t, info_t, out_j, info_j)
    close(info_t["costs"], np.full(4, float(info_t["initial_cost"])),
          atol=0.0)
    close(out_t.bias, b0, atol=0.0)
