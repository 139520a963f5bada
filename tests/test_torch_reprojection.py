"""Parity of libwave_tpu_torch.optim.reprojection with libwave_tpu's.

The same f64 numpy bank (a few cameras, landmarks in front of and behind
them) goes through both packages. Tolerance: rtol 1e-10 on every output
(closed-form f64 elementwise math), atol 1e-12 for entries that are zero
in one package and rounding-level in the other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev

from libwave_tpu.optim import reprojection as jrep
from libwave_tpu_torch.geometry import so3 as tso3
from libwave_tpu_torch.optim import reprojection as trep

RTOL, ATOL = 1e-10, 1e-12


@pytest.fixture
def bank(rng):
    N, M, Pmax = 4, 30, 9
    K = np.array([[400.0, 0, 320], [0, 380.0, 240], [0, 0, 1]])
    q = rng.normal(size=(N, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = rng.normal(size=(N, 3))
    lm = rng.normal(size=(M, 3)) * 4.0  # some behind each camera
    lm_slot = rng.integers(0, M, (N, Pmax)).astype(np.int32)
    pose_idx = np.repeat(np.arange(N, dtype=np.int32), Pmax)
    uv = rng.uniform(0, 640, (2, N, Pmax))
    return dict(K=K, q=q, p=p, lm=lm, lm_slot=lm_slot, pose_idx=pose_idx,
                uv=uv)


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _close_all(js, ts):
    for a, b in zip(js, ts):
        if b.dtype == torch.bool:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("fn", ["reprojection_residual_ell",
                                "linearize_reprojection_ell"])
def test_ell_bank(fn, bank):
    j, t = _j(bank), _t(bank)
    out_j = getattr(jrep, fn)(j["K"], j["q"], j["p"], j["lm"], j["lm_slot"],
                              j["uv"])
    out_t = getattr(trep, fn)(t["K"], t["q"], t["p"], t["lm"], t["lm_slot"],
                              t["uv"])
    valid = out_t[-1].numpy()
    assert valid.any() and not valid.all()  # both branches exercised
    _close_all(out_j, out_t)


@pytest.mark.parametrize("fn", ["reprojection_residual_cm",
                                "linearize_reprojection_cm"])
def test_flat_bank(fn, bank):
    j, t = _j(bank), _t(bank)
    out_j = getattr(jrep, fn)(j["K"], j["q"], j["p"], j["lm"], j["pose_idx"],
                              j["lm_slot"].reshape(-1),
                              j["uv"].reshape(2, -1))
    out_t = getattr(trep, fn)(t["K"], t["q"], t["p"], t["lm"], t["pose_idx"],
                              t["lm_slot"].reshape(-1),
                              t["uv"].reshape(2, -1))
    _close_all(out_j, out_t)


@pytest.mark.parametrize("fn", ["reprojection_residual",
                                "linearize_reprojection"])
def test_block_bank(fn, bank):
    pi = bank["pose_idx"]
    li = bank["lm_slot"].reshape(-1)
    args = (bank["K"], bank["q"][pi], bank["p"][pi], bank["lm"][li],
            bank["uv"].reshape(2, -1).T)
    out_j = getattr(jrep, fn)(*(jnp.asarray(a) for a in args))
    out_t = getattr(trep, fn)(*(torch.as_tensor(a) for a in args))
    _close_all(out_j, out_t)


def test_jacobians_match_autodiff(rng):
    """Closed-form Jacobians against reverse-mode autodiff of the port's
    own residual (the reference's test_ba.py autodiff check)."""
    K = torch.tensor([[500.0, 0, 320], [0, 480.0, 240], [0, 0, 1]],
                     dtype=torch.float64)
    q = tso3.quat_normalize(torch.as_tensor(rng.normal(size=4)))
    p = torch.as_tensor(rng.normal(size=3))
    X = p + tso3.quat_rotate(q, torch.tensor([0.3, -0.2, 4.0],
                                             dtype=torch.float64))
    uv = torch.tensor([300.0, 200.0], dtype=torch.float64)
    r, J_pose, J_lm, valid = trep.linearize_reprojection(
        K, q[None], p[None], X[None], uv[None]
    )
    assert bool(valid[0])

    def res(omega, dp, dX):
        return trep.reprojection_residual(
            K, tso3.quat_boxplus(q, omega), p + dp, X + dX, uv
        )[0]

    z3 = torch.zeros(3, dtype=torch.float64)
    for argnum, J in ((0, J_pose[0, :, 0:3]), (1, J_pose[0, :, 3:6]),
                      (2, J_lm[0])):
        np.testing.assert_allclose(
            J.numpy(), jacrev(res, argnums=argnum)(z3, z3, z3).numpy(),
            atol=1e-7,
        )


def test_behind_camera_masked():
    K = torch.eye(3, dtype=torch.float64)
    r, J_pose, J_lm, valid = trep.linearize_reprojection(
        K,
        tso3.quat_identity((1,), torch.float64, "cpu"),
        torch.zeros((1, 3), dtype=torch.float64),
        torch.tensor([[0.0, 0.0, -2.0]], dtype=torch.float64),
        torch.zeros((1, 2), dtype=torch.float64),
    )
    assert not bool(valid[0])
    assert float(r.abs().max()) == 0.0
    assert float(J_pose.abs().max()) == 0.0
    assert float(J_lm.abs().max()) == 0.0
