"""Parity of libwave_tpu_torch.geometry.so3 with libwave_tpu.geometry.so3.

The same f64 numpy inputs, drawn from a seed, go through both packages.
Tolerance: rtol 1e-10 (elementwise f64 math, only the order of a few
operations differs), with atol 1e-14 for entries that are exactly zero in
one package and rounding-level in the other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.geometry import so3 as jso3
from libwave_tpu_torch.geometry import so3 as tso3

RTOL, ATOL = 1e-10, 1e-14


def _phis(rng):
    """Rotation vectors: generic, near 0 (both sides of the Taylor cutoff)
    and near pi."""
    generic = rng.normal(size=(32, 3))
    axes = rng.normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    mags = np.array([0.0, 1e-9, 5e-7, 9.9e-7, 1.01e-6, 1e-4,
                     np.pi - 1e-9, np.pi - 1e-6, np.pi - 1e-3, np.pi,
                     3.0, 1.0])
    return np.concatenate([generic, axes * mags[:, None]])


def _quats(rng):
    q = rng.normal(size=(40, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    near = np.stack([
        [1.0, 0, 0, 0], [-1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0, 1.0],
        [np.cos(1e-8), np.sin(1e-8), 0, 0],
        [1e-9, np.sqrt(1 - 1e-18), 0, 0],
    ])
    return np.concatenate([q, near])


def _close(j, t):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "name", ["exp", "exp_quat", "left_jacobian", "left_jacobian_inverse",
             "hat"],
)
def test_tangent_maps(name, rng):
    phi = _phis(rng)
    if name == "left_jacobian_inverse":
        phi = phi[np.linalg.norm(phi, axis=-1) < 3.0]  # cot(pi/2 * 2) pole
    _close(getattr(jso3, name)(jnp.asarray(phi)),
           getattr(tso3, name)(torch.as_tensor(phi)))


@pytest.mark.parametrize(
    "name", ["log_quat", "quat_to_rot", "quat_normalize", "quat_conjugate"],
)
def test_quaternion_maps(name, rng):
    q = _quats(rng)
    _close(getattr(jso3, name)(jnp.asarray(q)),
           getattr(tso3, name)(torch.as_tensor(q)))


def test_log_and_rot_to_quat_from_matrices(rng):
    R = np.array(jso3.exp(jnp.asarray(_phis(rng))))
    _close(jso3.rot_to_quat(jnp.asarray(R)),
           tso3.rot_to_quat(torch.as_tensor(R)))
    _close(jso3.log(jnp.asarray(R)), tso3.log(torch.as_tensor(R)))
    _close(jso3.vee(jnp.asarray(R)), tso3.vee(torch.as_tensor(R)))


@pytest.mark.parametrize(
    "name", ["quat_multiply", "quat_boxminus", "rotation_distance"],
)
def test_quaternion_pairs(name, rng):
    a, b = _quats(rng), _quats(rng)[::-1].copy()
    _close(getattr(jso3, name)(jnp.asarray(a), jnp.asarray(b)),
           getattr(tso3, name)(torch.as_tensor(a), torch.as_tensor(b)))


def test_boxplus_and_rotate(rng):
    q = _quats(rng)[: _phis(rng).shape[0]]
    phi = _phis(rng)[: q.shape[0]]
    _close(jso3.quat_boxplus(jnp.asarray(q), jnp.asarray(phi)),
           tso3.quat_boxplus(torch.as_tensor(q), torch.as_tensor(phi)))
    v = rng.normal(size=(q.shape[0], 3))
    _close(jso3.quat_rotate(jnp.asarray(q), jnp.asarray(v)),
           tso3.quat_rotate(torch.as_tensor(q), torch.as_tensor(v)))


def test_identity_and_roundtrip(rng):
    qi = tso3.quat_identity((2, 3), torch.float64, "cpu")
    assert qi.shape == (2, 3, 4)
    _close(jso3.quat_identity((2, 3), jnp.float64), qi)
    q = torch.as_tensor(_quats(rng)[:40])
    phi = torch.as_tensor(_phis(rng)[:40])
    back = tso3.quat_boxminus(tso3.quat_boxplus(q, 0.5 * phi), q)
    np.testing.assert_allclose(back.numpy(), 0.5 * phi.numpy(), atol=1e-9)
