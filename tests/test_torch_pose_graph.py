"""Parity of libwave_tpu_torch.optim.pose_graph's factor banks with
libwave_tpu's: odometry from a trajectory, between and prior
linearization (forward-mode autodiff on both sides), the pose-graph
cost, and ``solve_pose_graph`` (a noisy odometry circle with a loop
closure, with and without a prior: cost traces within rtol 1e-9 at f64,
poses within 1e-9; at f32 the traces part by 2.0e-6 relative at most,
measured, held to 1e-4). f64 inputs from a numpy seed; tolerance rtol
1e-10 with atol 1e-12 * max|x| for entries that cancel to rounding level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.geometry import so3 as jso3
from libwave_tpu.optim import pose_graph as jpg
from libwave_tpu_torch.optim import pose_graph as tpg


def close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-10,
                               atol=1e-12 * max(np.abs(j).max(), 1.0))


@pytest.fixture
def trajectory(rng):
    n = 9
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q, rng.normal(size=(n, 3))


@pytest.mark.parametrize("stride", [1, 3])
def test_between_from_trajectory(stride, trajectory):
    q, p = trajectory
    bj = jpg.between_from_trajectory(jnp.asarray(q), jnp.asarray(p), 1e-3,
                                     1e-4, stride=stride)
    bt = tpg.between_from_trajectory(torch.as_tensor(q), torch.as_tensor(p),
                                     1e-3, 1e-4, stride=stride)
    for a, b in zip(bj, bt):
        close(b, a)
    assert bt.i.dtype == torch.int32


def test_between_noise_from_generator(trajectory):
    q, p = (torch.as_tensor(x) for x in trajectory)
    clean = tpg.between_from_trajectory(q, p, 1e-2, 1e-3)
    a = tpg.between_from_trajectory(q, p, 1e-2, 1e-3,
                                    generator=torch.Generator().manual_seed(4))
    b = tpg.between_from_trajectory(q, p, 1e-2, 1e-3,
                                    generator=torch.Generator().manual_seed(4))
    assert torch.equal(a.dp, b.dp) and torch.equal(a.dq, b.dq)
    assert not torch.equal(a.dp, clean.dp)


def _perturbed(trajectory, rng):
    q, p = trajectory
    dq = rng.normal(size=q.shape) * 0.05
    q2 = q + dq
    q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
    return q2, p + 0.1 * rng.normal(size=p.shape)


def test_linearize_between_and_prior(trajectory, rng):
    q, p = trajectory
    bank_j = jpg.between_from_trajectory(jnp.asarray(q), jnp.asarray(p),
                                         1e-2, 1e-3)
    bank_t = tpg.between_from_trajectory(torch.as_tensor(q),
                                         torch.as_tensor(p), 1e-2, 1e-3)
    q2, p2 = _perturbed(trajectory, rng)
    for a, b in zip(jax.jit(jpg.linearize_between)(bank_j, jnp.asarray(q2),
                                                   jnp.asarray(p2)),
                    tpg.linearize_between(bank_t, torch.as_tensor(q2),
                                          torch.as_tensor(p2))):
        close(b, a)
    idx = np.array([0, 4, 8], dtype=np.int32)
    si = np.abs(rng.normal(size=(3, 6))) + 0.5
    pj = jpg.PriorBank(i=jnp.asarray(idx), q=jnp.asarray(q[idx]),
                       p=jnp.asarray(p[idx]), sqrt_info=jnp.asarray(si))
    pt = tpg.PriorBank(i=torch.as_tensor(idx), q=torch.as_tensor(q[idx]),
                       p=torch.as_tensor(p[idx]), sqrt_info=torch.as_tensor(si))
    for a, b in zip(jax.jit(jpg.linearize_prior)(pj, jnp.asarray(q2),
                                                 jnp.asarray(p2)),
                    tpg.linearize_prior(pt, torch.as_tensor(q2),
                                        torch.as_tensor(p2))):
        close(b, a)
    close(tpg.pose_graph_cost(torch.as_tensor(q2), torch.as_tensor(p2),
                              bank_t, pt),
          jpg.pose_graph_cost(jnp.asarray(q2), jnp.asarray(p2), bank_j, pj))
    assert float(tpg.pose_graph_cost(torch.as_tensor(q), torch.as_tensor(p),
                                     bank_t, None)) < 1e-20


def test_linearize_in_f32(trajectory, rng):
    """Banks and poses in f32 linearize in f32, as the JAX package's do
    (the windowed BA solves f32 banks on the card). Both sides round
    differently, so the tolerance is f32's: rtol 1e-4, atol 1e-5 *
    max|x| (measured ~1e-6)."""
    q, p = trajectory
    q2, p2 = _perturbed(trajectory, rng)
    f32 = np.float32
    bank_j = jpg.between_from_trajectory(jnp.asarray(q, f32),
                                         jnp.asarray(p, f32), 1e-2, 1e-3)
    bank_t = tpg.between_from_trajectory(torch.as_tensor(q, dtype=torch.float32),
                                         torch.as_tensor(p, dtype=torch.float32),
                                         1e-2, 1e-3)
    idx = np.array([0, 4, 8], dtype=np.int32)
    si = (np.abs(rng.normal(size=(3, 6))) + 0.5).astype(f32)
    pj = jpg.PriorBank(i=jnp.asarray(idx), q=jnp.asarray(q[idx], f32),
                       p=jnp.asarray(p[idx], f32), sqrt_info=jnp.asarray(si))
    pt = tpg.PriorBank(i=torch.as_tensor(idx),
                       q=torch.as_tensor(q[idx], dtype=torch.float32),
                       p=torch.as_tensor(p[idx], dtype=torch.float32),
                       sqrt_info=torch.as_tensor(si))
    qt = torch.as_tensor(q2, dtype=torch.float32)
    pt2 = torch.as_tensor(p2, dtype=torch.float32)
    got = (*tpg.linearize_between(bank_t, qt, pt2),
           *tpg.linearize_prior(pt, qt, pt2))
    ref = (*jpg.linearize_between(bank_j, jnp.asarray(q2, f32),
                                  jnp.asarray(p2, f32)),
           *jpg.linearize_prior(pj, jnp.asarray(q2, f32),
                                jnp.asarray(p2, f32)))
    for b, a in zip(got, ref):
        assert b.dtype == torch.float32
        a = np.asarray(a)
        assert a.dtype == np.float32
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4,
                                   atol=1e-5 * np.abs(a).max())


def _circle(n=12, radius=5.0):
    theta = np.linspace(0, 1.5 * np.pi, n)
    p = np.stack([radius * np.cos(theta), radius * np.sin(theta),
                  np.zeros(n)], -1)
    q = np.stack([np.cos(0.5 * (theta + np.pi / 2)), np.zeros(n),
                  np.zeros(n), np.sin(0.5 * (theta + np.pi / 2))], -1)
    return q, p


def _graph(rng, priors: bool, dtype=np.float64):
    """An odometry circle of 12 poses with a loop closure 0 -> 11, noisy
    measurements (so the optimum's cost stays well above rounding), a
    perturbed start, and one prior on pose 0 or none."""
    q, p = _circle()
    i = np.r_[np.arange(11), 0].astype(np.int32)
    j = np.r_[np.arange(1, 12), 11].astype(np.int32)
    qi_inv = q[i] * np.array([1.0, -1.0, -1.0, -1.0])
    dq = np.asarray(jso3.quat_multiply(jnp.asarray(qi_inv), jnp.asarray(q[j])))
    dq = dq + 0.01 * rng.normal(size=dq.shape)
    dq /= np.linalg.norm(dq, axis=-1, keepdims=True)
    dp = np.asarray(jso3.quat_rotate(jnp.asarray(qi_inv),
                                     jnp.asarray(p[j] - p[i])))
    dp = dp + 0.05 * rng.normal(size=dp.shape)
    si = np.concatenate([np.full((12, 3), 100.0), np.full((12, 3), 20.0)], -1)
    q0 = q + 0.05 * rng.normal(size=q.shape)
    q0 /= np.linalg.norm(q0, axis=-1, keepdims=True)
    p0 = p + 0.3 * rng.normal(size=p.shape)
    fields = dict(i=i, j=j, dq=dq.astype(dtype), dp=dp.astype(dtype),
                  sqrt_info=si.astype(dtype))
    bj = jpg.BetweenBank(**{k: jnp.asarray(v) for k, v in fields.items()})
    bt = tpg.BetweenBank(**{k: torch.as_tensor(v) for k, v in fields.items()})
    pr = pt = None
    if priors:
        fields = dict(i=np.zeros(1, np.int32), q=q[:1].astype(dtype),
                      p=p[:1].astype(dtype),
                      sqrt_info=np.full((1, 6), 1e3, dtype))
        pr = jpg.PriorBank(**{k: jnp.asarray(v) for k, v in fields.items()})
        pt = tpg.PriorBank(**{k: torch.as_tensor(v)
                              for k, v in fields.items()})
    return q0.astype(dtype), p0.astype(dtype), bj, pr, bt, pt


@pytest.mark.parametrize("priors", [True, False])
def test_solve_pose_graph_f64(priors, rng):
    q0, p0, bj, pr, bt, pt = _graph(rng, priors)
    cfg_j = jpg.PoseGraphConfig(max_iterations=6, cg_max_iters=40)
    cfg_t = tpg.PoseGraphConfig(max_iterations=6, cg_max_iters=40)
    qj, pj, ij = jax.jit(lambda q, p: jpg.solve_pose_graph(
        q, p, bj, pr, cfg=cfg_j))(jnp.asarray(q0), jnp.asarray(p0))
    qt, pt_, it = tpg.solve_pose_graph(torch.as_tensor(q0),
                                       torch.as_tensor(p0), bt, pt, cfg=cfg_t)
    np.testing.assert_allclose(it["cost_trace"].numpy(),
                               np.asarray(ij["cost_trace"]), rtol=1e-9)
    assert float(it["final_cost"]) == float(it["cost_trace"][-1])
    np.testing.assert_allclose(pt_.numpy(), np.asarray(pj), atol=1e-9)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-9)
    if not priors:  # pose 0 is the gauge
        np.testing.assert_array_equal(pt_[0].numpy(), p0[0])


def test_solve_pose_graph_f32_and_free_mask(rng):
    q0, p0, bj, pr, bt, pt = _graph(rng, True, np.float32)
    cfg = tpg.PoseGraphConfig(max_iterations=4)
    qt, pt_, it = tpg.solve_pose_graph(torch.as_tensor(q0),
                                       torch.as_tensor(p0), bt, pt, cfg=cfg)
    _, _, ij = jax.jit(lambda q, p: jpg.solve_pose_graph(
        q, p, bj, pr, cfg=jpg.PoseGraphConfig(max_iterations=4)))(
        jnp.asarray(q0), jnp.asarray(p0))
    assert it["cost_trace"].dtype == torch.float32
    # f32: measured 2.0e-6 relative at most
    np.testing.assert_allclose(it["cost_trace"].numpy(),
                               np.asarray(ij["cost_trace"]), rtol=1e-4)
    free = torch.ones(12, dtype=torch.float32)
    free[:2] = 0.0
    _, pf, _ = tpg.solve_pose_graph(torch.as_tensor(q0), torch.as_tensor(p0),
                                    bt, free=free, cfg=cfg)
    np.testing.assert_array_equal(pf[:2].numpy(), p0[:2])
