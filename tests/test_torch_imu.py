"""Parity of libwave_tpu_torch.optim.imu with libwave_tpu.optim.imu at f64,
on random IMU windows made with numpy: preintegration (rtol 1e-12; the
batched form equals each window run alone), the residual, the whitening
and the noise-free IMU simulation (rtol 1e-10). The first-order bias
Jacobians of the preintegration match central differences of the
preintegrated deltas to 1e-3 of their largest entry (BASELINE.md's bound
for Jacobians)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.geometry import so3 as jso3
from libwave_tpu.optim import imu as jimu
from libwave_tpu_torch.geometry import so3 as tso3
from libwave_tpu_torch.optim import imu as timu


def _close(t, j, rtol=1e-12):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol,
                               atol=rtol * max(np.abs(j).max(), 1e-30))


def _window(rng, n=40):
    gyro = rng.normal(size=(n, 3)) * 0.5
    accel = rng.normal(size=(n, 3)) + np.array([0.0, 0.0, 9.81])
    bg = rng.normal(size=3) * 0.01
    ba = rng.normal(size=3) * 0.1
    return gyro, accel, bg, ba


def _pre_jax(gyro, accel, bg, ba, dt=0.005):
    return jimu.preintegrate_imu(jnp.asarray(gyro), jnp.asarray(accel), dt,
                                 jnp.asarray(bg), jnp.asarray(ba),
                                 gyro_noise_density=1e-3,
                                 accel_noise_density=1e-2)


def _pre_port(gyro, accel, bg, ba, dt=0.005):
    t = torch.as_tensor
    return timu.preintegrate_imu(t(gyro), t(accel), dt, t(bg), t(ba),
                                 gyro_noise_density=1e-3,
                                 accel_noise_density=1e-2)


def test_preintegration_matches(rng):
    w = _window(rng)
    pj, pt = _pre_jax(*w), _pre_port(*w)
    for f in jimu.PreintegratedImu._fields:
        _close(getattr(pt, f), getattr(pj, f))
    _close(timu.imu_sqrt_info(pt), jimu.imu_sqrt_info(pj), rtol=1e-10)


def test_batched_windows_equal_single(rng):
    ws = [_window(rng, 25) for _ in range(3)]
    stacked = [np.stack(x) for x in zip(*ws)]
    pb = _pre_port(*stacked)
    for k, w in enumerate(ws):
        one = _pre_port(*w)
        for f in timu.PreintegratedImu._fields:
            _close(getattr(pb, f)[k], getattr(one, f))


def test_residual_matches(rng):
    pj = _pre_jax(*_window(rng))
    pt = timu.PreintegratedImu(*(torch.as_tensor(np.array(x)) for x in pj))
    q = rng.normal(size=(2, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p, v = rng.normal(size=(2, 3)), rng.normal(size=(2, 3))
    bg, ba = rng.normal(size=3) * 0.01, rng.normal(size=3) * 0.1
    args = (q[0], p[0], v[0], q[1], p[1], v[1], bg, ba)
    _close(timu.imu_residual(pt, *map(torch.as_tensor, args)),
           jimu.imu_residual(pj, *map(jnp.asarray, args)), rtol=1e-10)


@pytest.mark.parametrize("which", ["bg", "ba"])
def test_bias_jacobians_match_numerical(which, rng):
    gyro, accel, bg, ba = _window(rng, 30)
    base = _pre_port(gyro, accel, bg, ba)
    eps = 1e-6
    num = {k: np.zeros((3, 3)) for k in ("q", "v", "p")}
    for k in range(3):
        d = np.zeros(3)
        d[k] = eps
        plus = _pre_port(gyro, accel, bg + d, ba) if which == "bg" else \
            _pre_port(gyro, accel, bg, ba + d)
        minus = _pre_port(gyro, accel, bg - d, ba) if which == "bg" else \
            _pre_port(gyro, accel, bg, ba - d)
        dq = tso3.quat_boxminus(plus.dq, minus.dq).numpy()
        num["q"][:, k] = dq / (2 * eps)
        num["v"][:, k] = (plus.dv - minus.dv).numpy() / (2 * eps)
        num["p"][:, k] = (plus.dp - minus.dp).numpy() / (2 * eps)
    analytic = {"q": base.J_q_bg, "v": base.J_v_bg, "p": base.J_p_bg} \
        if which == "bg" else {"q": torch.zeros(3, 3), "v": base.J_v_ba,
                               "p": base.J_p_ba}
    for k, J in analytic.items():
        J = J.numpy()
        # a zero Jacobian (dq by ba) is held to the differences' noise
        scale = max(np.abs(num[k]).max(), np.abs(J).max(), 1e-6)
        assert np.abs(J - num[k]).max() <= 1e-3 * scale, (which, k)


def test_simulate_imu_noise_free(rng):
    T = 50
    phi = np.cumsum(rng.normal(size=(T, 3)) * 0.02, axis=0)
    q = np.asarray(jso3.exp_quat(jnp.asarray(phi)))
    p = np.cumsum(rng.normal(size=(T, 3)) * 0.01, axis=0)
    v = np.gradient(p, 0.01, axis=0)
    gj = jimu.simulate_imu(jnp.asarray(q), jnp.asarray(p), jnp.asarray(v),
                           0.01, bg=jnp.asarray([0.01, 0, 0]))
    q = np.array(q)
    gt = timu.simulate_imu(torch.as_tensor(q), torch.as_tensor(p),
                           torch.as_tensor(v), 0.01,
                           bg=torch.tensor([0.01, 0, 0], dtype=torch.float64))
    for a, b in zip(gt, gj):
        _close(a, b, rtol=1e-10)
    gen = torch.Generator().manual_seed(0)
    noisy = timu.simulate_imu(torch.as_tensor(q), torch.as_tensor(p),
                              torch.as_tensor(v), 0.01, generator=gen,
                              gyro_sigma=1e-3, accel_sigma=1e-2)
    resid = (noisy[1] - gt[1]).numpy()
    assert 0.005 < resid.std() < 0.02
