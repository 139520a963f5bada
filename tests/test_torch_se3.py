"""Parity of libwave_tpu_torch.geometry.se3 with libwave_tpu.geometry.se3 on
random f64 transforms and twists made with numpy (rtol 1e-12; the matrix
and adjoint forms and the exp/log round trip likewise)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.geometry import se3 as jse3
from libwave_tpu_torch.geometry import se3 as tse3


def _close(t, j, rtol=1e-12):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol,
                               atol=rtol * max(np.abs(j).max(), 1.0))


def _pair(rng, n):
    xi = rng.normal(size=(n, 6))
    xi[0, :3] = 1e-9  # the small-angle branch
    return (jse3.exp(jnp.asarray(xi)), tse3.exp(torch.as_tensor(xi)), xi)


def test_exp_log_compose_inverse(rng):
    Tj, Tt, xi = _pair(rng, 7)
    _close(Tt.q, Tj.q)
    _close(Tt.t, Tj.t)
    _close(tse3.log(Tt), jse3.log(Tj))
    _close(tse3.log(Tt), xi, rtol=1e-9)
    Uj, Ut, _ = _pair(rng, 7)
    for a, b in zip(Tt.compose(Ut), Tj.compose(Uj)):
        _close(a, b)
    for a, b in zip(Tt.inverse(), Tj.inverse()):
        _close(a, b)
    p = rng.normal(size=(7, 3))
    _close(Tt.apply(torch.as_tensor(p)), Tj.apply(jnp.asarray(p)))
    _close(tse3.boxminus(Tt, Ut), jse3.boxminus(Tj, Uj))
    d = rng.normal(size=(7, 6)) * 0.1
    for a, b in zip(tse3.boxplus(Tt, torch.as_tensor(d)),
                    jse3.boxplus(Tj, jnp.asarray(d))):
        _close(a, b)


def test_matrix_adjoint_identity(rng):
    Tj, Tt, _ = _pair(rng, 5)
    _close(Tt.matrix(), Tj.matrix())
    _close(tse3.adjoint(Tt), jse3.adjoint(Tj))
    back = tse3.SE3.from_matrix(Tt.matrix())
    _close(back.t, Tj.t)
    _close(back.rotation(), Tj.rotation())
    I = tse3.SE3.identity((2,), torch.float64, "cpu")
    Ij = jse3.SE3.identity((2,), jnp.float64)
    _close(I.q, Ij.q)
    _close(I.t, Ij.t)


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_interpolate(alpha, rng):
    Tj, Tt, _ = _pair(rng, 4)
    Uj, Ut, _ = _pair(rng, 4)
    for a, b in zip(tse3.interpolate(Tt, Ut, alpha),
                    jse3.interpolate(Tj, Uj, alpha)):
        _close(a, b, rtol=1e-10)
