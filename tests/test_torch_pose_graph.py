"""Parity of libwave_tpu_torch.optim.pose_graph's factor banks with
libwave_tpu's: odometry from a trajectory, between and prior
linearization (forward-mode autodiff on both sides), and the pose-graph
cost. f64 inputs from a numpy seed; tolerance rtol 1e-10 with atol
1e-12 * max|x| for entries that cancel to rounding level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
