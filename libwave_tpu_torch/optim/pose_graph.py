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

:func:`solve_pose_graph` is Gauss-Newton with a matrix-free PCG per step:
the Hessian-vector product is the banks' 6x6 block products and sums over
pose ids, the preconditioner the 6x6 block diagonal (``inv_ex``), and both
loops run their full trip counts with convergence masked on the device
(as ``optim.schur.pcg``), so a solve never waits for a host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap

from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.utils.precision import f32_matmuls, sums


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
                    priors: PriorBank | None, windows: int | None = None):
    """0.5 |r|^2 of both banks. ``windows``: the banks hold that many
    windows of a disjoint union, each with an equal share of the factors,
    window-major; the cost is then (windows,), one sum per window."""
    total = sums(windows)
    c = torch.zeros(() if windows is None else (windows,), dtype=p.dtype,
                    device=p.device)
    if between is not None:
        r = _between_residual(
            q[between.i], p[between.i], q[between.j], p[between.j],
            between.dq, between.dp, between.sqrt_info,
        )
        c = c + 0.5 * total(r * r)
    if priors is not None:
        r = _prior_residual(
            q[priors.i], p[priors.i], priors.q, priors.p, priors.sqrt_info
        )
        c = c + 0.5 * total(r * r)
    return c


class PoseGraphConfig(NamedTuple):
    """Knobs for :func:`solve_pose_graph` (defaults sized for odometry graphs
    with loop closures)."""

    max_iterations: int = 15
    cg_max_iters: int = 60
    cg_tol: float = 1e-8
    damping: float = 1e-8


def _segment_sum(x, ids, n):
    """Rows of ``x`` summed by pose id into (n, ...)."""
    return x.new_zeros((n,) + x.shape[1:]).index_add_(0, ids, x)


def _scatter6(i, j, Ji, Jj, y, n):
    """out[k] = sum_{f: i_f=k} Ji_f^T y_f + sum_{f: j_f=k} Jj_f^T y_f."""
    ti = torch.einsum("fab,fa->fb", Ji, y)
    tj = torch.einsum("fab,fa->fb", Jj, y)
    return _segment_sum(ti, i, n) + _segment_sum(tj, j, n)


def _vdot(a, b):
    return torch.sum(a * b)


@f32_matmuls
def solve_pose_graph(
    q,
    p,
    between: BetweenBank,
    priors: PriorBank | None = None,
    free=None,
    cfg: PoseGraphConfig = PoseGraphConfig(),
):
    """Gauss-Newton pose-graph optimization on the tensors' device.

    Each GN step solves the normal equations matrix-free: the
    Hessian-vector product is two batched 6x6 block products plus sums over
    pose ids, solved by PCG with a block-Jacobi (6x6 block diagonal)
    preconditioner. Both loops run their full trip counts.

    Args:
      q, p: (N, 4) quaternions + (N, 3) positions (initial estimate).
      free: optional (N,) mask, 0 = gauge-fixed pose (default: pose 0
        fixed without priors, every pose free with them).

    Returns (q, p, info dict with the cost after each step).
    """
    n = q.shape[0]
    dtype = p.dtype
    if free is None:
        # gauge: if priors anchor the graph, every pose is free; otherwise
        # fix pose 0
        free = torch.ones((n,), dtype=dtype, device=p.device)
        if priors is None:
            free = torch.where(torch.arange(n, device=p.device) == 0, 0.0,
                               free)
    free = torch.as_tensor(free, dtype=dtype, device=p.device)
    fmask = free[:, None]  # (N, 1)
    eye6 = torch.eye(6, dtype=dtype, device=p.device)
    bi, bj = between.i.to(torch.int64), between.j.to(torch.int64)
    pi = priors.i.to(torch.int64) if priors is not None else None

    def gn_step(q, p):
        r_b, Ji, Jj = linearize_between(between, q, p)
        if priors is not None:
            r_p, Jp = linearize_prior(priors, q, p)

        # gradient and block-diagonal of H
        g = _scatter6(bi, bj, Ji, Jj, r_b, n)
        Dblk = _segment_sum(torch.einsum("fab,fac->fbc", Ji, Ji), bi, n) \
            + _segment_sum(torch.einsum("fab,fac->fbc", Jj, Jj), bj, n)
        if priors is not None:
            g = g + _segment_sum(torch.einsum("fab,fa->fb", Jp, r_p), pi, n)
            Dblk = Dblk + _segment_sum(
                torch.einsum("fab,fac->fbc", Jp, Jp), pi, n)
        Dblk = Dblk + (cfg.damping + 1e-10) * eye6
        # gauge-fixed blocks become identity so the preconditioner is SPD
        Dblk = torch.where((free > 0)[:, None, None], Dblk, eye6)
        Pinv = torch.linalg.inv_ex(Dblk).inverse  # block-Jacobi

        def Hv(v):
            v = v * fmask
            y = torch.einsum("fab,fb->fa", Ji, v[bi]) \
                + torch.einsum("fab,fb->fa", Jj, v[bj])
            out = _scatter6(bi, bj, Ji, Jj, y, n)
            if priors is not None:
                yp = torch.einsum("fab,fb->fa", Jp, v[pi])
                out = out + _segment_sum(
                    torch.einsum("fab,fa->fb", Jp, yp), pi, n)
            return (out + cfg.damping * v) * fmask

        def apply_P(v):
            return torch.einsum("nij,nj->ni", Pinv, v * fmask) * fmask

        # masked-convergence PCG (the pattern of optim.schur.pcg)
        b = -g * fmask
        x = torch.zeros_like(b)
        r = b
        z = apply_P(r)
        pdir = z
        rz = _vdot(r, z)
        rr = _vdot(b, b)
        thresh = (cfg.cg_tol ** 2) * rr
        for _ in range(cfg.cg_max_iters):
            live = rr > thresh
            Hp = Hv(pdir)
            denom = _vdot(pdir, Hp)
            alpha = torch.where(
                live, rz / torch.where(denom == 0, 1.0, denom), 0.0)
            x = x + alpha * pdir
            r = r - alpha * Hp
            z_new = apply_P(r)
            rz_new = _vdot(r, z_new)
            rr = _vdot(r, r)
            beta = torch.where(live, rz_new / torch.where(rz == 0, 1.0, rz),
                               0.0)
            pdir = z_new + beta * pdir
            rz = torch.where(live, rz_new, rz)
        dx = x * fmask
        q_new = so3.quat_boxplus(q, dx[:, 0:3])
        p_new = p + dx[:, 3:6]
        return q_new, p_new, pose_graph_cost(q_new, p_new, between, priors)

    trace = []
    for _ in range(cfg.max_iterations):
        q, p, cost = gn_step(q, p)
        trace.append(cost)
    trace = torch.stack(trace)
    return q, p, {"cost_trace": trace, "final_cost": trace[-1]}
