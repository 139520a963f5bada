"""Pose-graph factor banks: between (odometry) factors and pose priors.

Port of the factor banks of ``libwave_tpu.optim.pose_graph`` that bundle
adjustment linearizes. Residual conventions (product manifold (q, p), right
perturbation):

  between(i, j; meas):  r = [ log(q_meas⁻¹ ⊗ q_i⁻¹ ⊗ q_j),
                              R_i^T (p_j - p_i) - p_meas ] * sqrt_info
  prior(i; meas):       r = [ log(q_meas⁻¹ ⊗ q_i),  p_i - p_meas ] * sqrt_info

Jacobians come from forward-mode autodiff over the boxplus-perturbed
residual of the whole bank: one ``torch.func.jvp`` per tangent direction,
the directions batched with ``torch.func.vmap``, in the bank's dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap

from libwave_tpu_torch.geometry import so3


class BetweenBank(NamedTuple):
    """F between-factors (i -> j relative pose measurements)."""

    i: torch.Tensor  # (F,) int32
    j: torch.Tensor  # (F,) int32
    dq: torch.Tensor  # (F, 4) measured q_i⁻¹ ⊗ q_j
    dp: torch.Tensor  # (F, 3) measured R_i^T (p_j - p_i)
    sqrt_info: torch.Tensor  # (F, 6) diagonal sqrt information [rot, trans]


class PriorBank(NamedTuple):
    """P unary pose priors."""

    i: torch.Tensor  # (P,) int32
    q: torch.Tensor  # (P, 4)
    p: torch.Tensor  # (P, 3)
    sqrt_info: torch.Tensor  # (P, 6)


def between_from_trajectory(q, p, sigmas_rot, sigmas_trans, stride: int = 1,
                            generator: torch.Generator | None = None):
    """Consecutive-pose odometry measurements from a trajectory. With
    ``generator``, each measurement is perturbed by the factor's own sigmas
    (standard normals drawn from that generator)."""
    i = torch.arange(0, q.shape[0] - stride, dtype=torch.int32, device=q.device)
    j = i + stride
    qi_inv = so3.quat_inverse(q[i])
    dq = so3.quat_multiply(qi_inv, q[j])
    dp = so3.quat_rotate(qi_inv, p[j] - p[i])
    if generator is not None:
        n_rot = torch.randn(
            dq.shape[:-1] + (3,), generator=generator, dtype=p.dtype,
            device=p.device,
        )
        n_trans = torch.randn(
            dp.shape, generator=generator, dtype=p.dtype, device=p.device
        )
        dq = so3.quat_boxplus(dq, sigmas_rot * n_rot)
        dp = dp + sigmas_trans * n_trans
    F = i.shape[0]
    si = torch.cat(
        [
            torch.full((F, 3), 1.0 / sigmas_rot, dtype=p.dtype, device=p.device),
            torch.full((F, 3), 1.0 / sigmas_trans, dtype=p.dtype,
                       device=p.device),
        ],
        dim=-1,
    )
    return BetweenBank(i=i, j=j, dq=dq, dp=dp, sqrt_info=si)


def _between_residual(qi, pi, qj, pj, dq, dp, sqrt_info):
    qi_inv = so3.quat_inverse(qi)
    r_rot = so3.log_quat(
        so3.quat_multiply(so3.quat_inverse(dq), so3.quat_multiply(qi_inv, qj))
    )
    r_pos = so3.quat_rotate(qi_inv, pj - pi) - dp
    return torch.cat([r_rot, r_pos], dim=-1) * sqrt_info


def _prior_residual(qi, pi, q0, p0, sqrt_info):
    r_rot = so3.log_quat(so3.quat_multiply(so3.quat_inverse(q0), qi))
    return torch.cat([r_rot, pi - p0], dim=-1) * sqrt_info


def _bank_jacobians(res, F, n_args, like):
    """A bank residual ``res(*xis)`` (each xi (F, 6)) at zero and its
    Jacobians wrt each argument, (F, 6, 6) apiece: one ``jvp`` of the whole
    bank per tangent direction, the directions under ``vmap`` (as
    ``pipelines.vio._imu_linearize``). Per-factor ``vmap(jacfwd(...))``
    would run the residual on 0-d tensors, where forward AD gives float64
    tangents to float32 operands."""
    n = 6 * n_args
    z = like.new_zeros((F, 6))
    basis = torch.eye(n, dtype=like.dtype, device=like.device)[:, None, :]

    def column(t):
        return torch.func.jvp(
            res, (z,) * n_args,
            tuple(t[:, 6 * a:6 * (a + 1)] for a in range(n_args)))[1]

    J = vmap(column)(basis.expand(n, F, n)).permute(1, 2, 0)  # (F, 6, n)
    return (res(*(z,) * n_args),
            *(J[..., 6 * a:6 * (a + 1)] for a in range(n_args)))


def linearize_between(bank: BetweenBank, q, p):
    """Returns (r (F,6), Ji (F,6,6), Jj (F,6,6)) in [omega, dp] tangent order."""
    i, j = bank.i, bank.j
    qi, pi, qj, pj = q[i], p[i], q[j], p[j]

    def res(xi_i, xi_j):
        return _between_residual(
            so3.quat_boxplus(qi, xi_i[:, 0:3]), pi + xi_i[:, 3:6],
            so3.quat_boxplus(qj, xi_j[:, 0:3]), pj + xi_j[:, 3:6],
            bank.dq, bank.dp, bank.sqrt_info,
        )

    return _bank_jacobians(res, i.shape[0], 2, p)


def linearize_prior(bank: PriorBank, q, p):
    """Returns (r (P,6), J (P,6,6))."""
    i = bank.i
    qi, pi = q[i], p[i]

    def res(xi):
        return _prior_residual(
            so3.quat_boxplus(qi, xi[:, 0:3]), pi + xi[:, 3:6], bank.q,
            bank.p, bank.sqrt_info,
        )

    return _bank_jacobians(res, i.shape[0], 1, p)


def pose_graph_cost(q, p, between: BetweenBank | None,
                    priors: PriorBank | None):
    c = torch.zeros((), dtype=p.dtype, device=p.device)
    if between is not None:
        r = _between_residual(
            q[between.i], p[between.i], q[between.j], p[between.j],
            between.dq, between.dp, between.sqrt_info,
        )
        c = c + 0.5 * torch.sum(r * r)
    if priors is not None:
        r = _prior_residual(
            q[priors.i], p[priors.i], priors.q, priors.p, priors.sqrt_info
        )
        c = c + 0.5 * torch.sum(r * r)
    return c
