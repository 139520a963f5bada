"""Visual-inertial odometry: full factor graph with Schur elimination.

Port of ``libwave_tpu.pipelines.vio`` (BASELINE.md config 4: reprojection +
IMU preintegration over keyframe states):

- keyframe states are 15-dim blocks [pose(6), vel(3), bg(3), ba(3)];
- reprojection factors eliminate landmarks through the Schur machinery of
  ``optim.schur`` (3x3 block inverses, the segment kernels for the
  landmark-side crossings), as in pure BA;
- IMU preintegration factors and bias random-walk factors enter as
  pose-pose couplings of the reduced camera system;
- the reduced system is solved densely (the G/A kernel, ``solver="auto"``
  at this scale) or by matrix-free PCG (``solver="pcg"``).

The reference's LM ``lax.scan`` is a fixed-trip Python loop with
``torch.where`` masking: nothing inside it reads a device value on the
host. The IMU Jacobians come from forward-mode AD (``torch.func.jvp``
under ``vmap`` over the tangent directions), as the reference's
``jax.jacfwd``. The cost total accumulates in f64 and behind-camera
observations carry a 1e10 penalty each (BA uses 1e6). The sharded
(``axis_name``) branches are not ported and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.optim import schur
from libwave_tpu_torch.optim.ba import _huber_rho, _use_dense_schur
from libwave_tpu_torch.optim.imu import (
    PreintegratedImu,
    imu_residual,
    imu_sqrt_info,
    preintegrate_imu,
    simulate_imu,
    vec3,
)
from libwave_tpu_torch.optim.reprojection import (
    linearize_reprojection_ell,
    reprojection_residual_ell,
)
from libwave_tpu_torch.utils.device import resolve
from libwave_tpu_torch.utils.precision import f32_matmuls

D = 15  # keyframe tangent dim: [pose(6), vel(3), bg(3), ba(3)]

# Behind-camera penalty per observation: it must dominate any single-step
# decrease of the other factors (see the reference's vio_cost); the cost
# total accumulates in f64 so this magnitude stays resolvable.
_CHEIRALITY_PENALTY = 1e10


class VIOState(NamedTuple):
    """Keyframe states (N keyframes, BODY frame) + landmarks."""

    q: torch.Tensor  # (N, 4) body-to-world orientation
    p: torch.Tensor  # (N, 3)
    v: torch.Tensor  # (N, 3) world-frame linear velocity
    bg: torch.Tensor  # (N, 3) gyro bias
    ba: torch.Tensor  # (N, 3) accel bias
    lm: torch.Tensor  # (M, 3)

    def retract(self, dx: torch.Tensor, dlm: torch.Tensor,
                free) -> "VIOState":
        """Product-manifold retraction [omega, dp_world, dv, dbg, dba]."""
        dx = dx * (free[:, None] if free.dim() == 1 else free)
        return VIOState(
            q=so3.quat_boxplus(self.q, dx[:, 0:3]),
            p=self.p + dx[:, 3:6],
            v=self.v + dx[:, 6:9],
            bg=self.bg + dx[:, 9:12],
            ba=self.ba + dx[:, 12:15],
            lm=self.lm + dlm,
        )


class VIOProblem(NamedTuple):
    K: torch.Tensor  # (3, 3) intrinsics
    # reprojection bank, pose-ELL order (schur.pack_observations)
    pose_idx: torch.Tensor  # (K_,)
    lm_idx: torch.Tensor  # (K_,)
    uv: torch.Tensor  # (K_, 2)
    obs_weight: torch.Tensor  # (K_,) zero on padding slots
    # IMU bank: one preintegrated window per consecutive keyframe pair
    pim: PreintegratedImu  # leading dim F on every field
    imu_i: torch.Tensor  # (F,)
    imu_j: torch.Tensor  # (F,)
    imu_sqrt_info: torch.Tensor  # (F, 9, 9)
    bias_walk_sqrt_info: torch.Tensor  # (6,) per-step [bg, ba]
    free_pose: torch.Tensor  # (N,) or (N, D)
    q_BC: torch.Tensor = None  # (4,) camera-from-body extrinsic rotation
    bias_prior_sqrt_info: torch.Tensor = None  # (6,) or (N, 6) or None
    ell: object = None  # schur.EllLayout (pose-ELL fast path)
    pixel_sigma: float = 1.0
    gravity: tuple = (0.0, 0.0, -9.81)
    # Dense marginal prior on the head O keyframes: cost 0.5 d^T Lambda d -
    # b^T d with d the (O*15,) tangent delta of states [0, O) from the
    # prior mean, in retract() order.
    prior_Lambda: torch.Tensor = None  # (O*15, O*15)
    prior_b: torch.Tensor = None  # (O*15,)
    prior_q: torch.Tensor = None  # (O, 4)
    prior_p: torch.Tensor = None  # (O, 3)
    prior_v: torch.Tensor = None  # (O, 3)
    prior_bg: torch.Tensor = None  # (O, 3)
    prior_ba: torch.Tensor = None  # (O, 3)


@dataclasses.dataclass(frozen=True)
class VIOConfig:
    """LM and solver settings; defaults and meanings as in the reference
    (``libwave_tpu/pipelines/vio.py:114-144``)."""

    max_iterations: int = 15
    cg_max_iters: int = 60
    cg_tol: float = 1e-6
    init_lambda: float = 1e-4
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    huber_delta: float = None  # whitened reprojection norm, None = L2
    solver: str = "auto"  # "auto" | "pcg" | "dense"
    dense_max_pose_dim: int = 4096
    dense_max_g_bytes: float = 1.5e9
    dense_max_landmarks: int = 1500
    # "float64": sum the pose-block normal equations and factorize the
    # reduced system in f64 (dense solver only; ignored by PCG)
    hessian_dtype: str | None = None


def _dtype(name):
    return None if name is None else getattr(torch, name)


def _imu_whitened(problem: VIOProblem, state: VIOState):
    """The IMU bank's whitened residual as a function of the tangent
    perturbations ``(xi_i, xi_j)`` (each (F, 15)) of its two keyframes, in
    the product retraction of :meth:`VIOState.retract`."""
    g = vec3(problem.gravity, state.p)
    i, j = problem.imu_i.long(), problem.imu_j.long()
    qi, pi, vi = state.q[i], state.p[i], state.v[i]
    qj, pj, vj = state.q[j], state.p[j], state.v[j]
    bgi, bai = state.bg[i], state.ba[i]
    S = problem.imu_sqrt_info

    def res(xi_i, xi_j):
        r = imu_residual(
            problem.pim,
            so3.quat_boxplus(qi, xi_i[:, 0:3]), pi + xi_i[:, 3:6],
            vi + xi_i[:, 6:9],
            so3.quat_boxplus(qj, xi_j[:, 0:3]), pj + xi_j[:, 3:6],
            vj + xi_j[:, 6:9],
            bgi + xi_i[:, 9:12], bai + xi_i[:, 12:15],
            gravity=g,
        )
        return (S @ r[..., None])[..., 0]

    return res, state.p.new_zeros((i.shape[0], D))


def _imu_linearize(problem: VIOProblem, state: VIOState,
                   axis_name: str | None = None):
    """Residuals + Jacobians of all IMU factors wrt the 15-dim blocks,
    whitened: (r (F, 9), Ji (F, 9, 15), Jj (F, 9, 15)).

    Forward-mode AD as the reference's ``jax.jacfwd``: one ``jvp`` of the
    whole bank's residual per tangent direction, the 30 directions under
    ``vmap``. (Per-factor ``vmap(jacfwd(...))`` would run the residual on
    0-d tensors, where PyTorch's forward AD gives float64 tangents to
    float32 operands.)"""
    schur.no_sharding(axis_name, "_imu_linearize")
    res, z = _imu_whitened(problem, state)
    F = z.shape[0]
    basis = torch.eye(2 * D, dtype=z.dtype, device=z.device)[:, None, :]

    def column(t):
        return torch.func.jvp(res, (z, z), (t[:, :D], t[:, D:]))[1]

    cols = torch.func.vmap(column)(basis.expand(2 * D, F, 2 * D))
    J = cols.permute(1, 2, 0)  # (F, 9, 2D)
    return res(z, z), J[..., :D], J[..., D:]


def _bias_walk_linearize(problem: VIOProblem, state: VIOState):
    """Bias random walk between consecutive keyframes: r = [bg_j - bg_i,
    ba_j - ba_i] * sqrt_info, closed-form (constant) Jacobians. Factors
    whose IMU whitening is all zero are padding and are silenced."""
    i, j = problem.imu_i.long(), problem.imu_j.long()
    si = problem.bias_walk_sqrt_info
    dtype = state.p.dtype
    live = (torch.sum(torch.abs(problem.imu_sqrt_info), dim=(-1, -2)) > 0
            ).to(dtype)
    r = torch.cat([state.bg[j] - state.bg[i], state.ba[j] - state.ba[i]],
                  dim=-1) * si * live[:, None]
    F = i.shape[0]
    eye = torch.eye(3, dtype=dtype, device=state.p.device)
    Ji = state.p.new_zeros((F, 6, D))
    Ji[:, 0:3, 9:12] = -si[0:3, None] * eye
    Ji[:, 3:6, 12:15] = -si[3:6, None] * eye
    Ji = Ji * live[:, None, None]
    return r, Ji, -Ji


def _camera_quats(problem, q_body):
    if problem.q_BC is None:
        return q_body
    return so3.quat_multiply(q_body, problem.q_BC)


def _prior_delta(problem: VIOProblem, state: VIOState) -> torch.Tensor:
    """Tangent delta (O*15,) of the head states from the prior mean, in
    retract() order (first-order, identity Jacobian)."""
    O = problem.prior_q.shape[0]
    return torch.cat(
        [
            so3.quat_boxminus(state.q[:O], problem.prior_q),
            state.p[:O] - problem.prior_p,
            state.v[:O] - problem.prior_v,
            state.bg[:O] - problem.prior_bg,
            state.ba[:O] - problem.prior_ba,
        ],
        dim=-1,
    ).reshape(-1)


def _prior_cost(problem: VIOProblem, state: VIOState) -> torch.Tensor:
    # a prior wider than the state (the stiff chain's f64 prior on an f32
    # state) takes the delta in its dtype, as JAX's promotion does
    d = _prior_delta(problem, state).to(problem.prior_Lambda.dtype)
    c = 0.5 * (d @ (problem.prior_Lambda @ d))
    if problem.prior_b is not None:
        c = c - problem.prior_b @ d
    return c


def _prior_terms(problem: VIOProblem, state: VIOState):
    """Normal-equation contributions of the dense head prior: per-keyframe
    diagonal blocks, upper-triangle cross couplings, and the rhs. Returns
    (Hpp_add (O, D, D), (C, ci, cj), bp_add (O, D))."""
    O = problem.prior_q.shape[0]
    dev = problem.prior_Lambda.device
    Lam4 = problem.prior_Lambda.reshape(O, D, O, D)
    ar = torch.arange(O, device=dev)
    diag = Lam4[ar, :, ar, :]  # (O, D, D)
    iu, ju = torch.triu_indices(O, O, offset=1, device=dev)
    C = Lam4[iu, :, ju, :]
    d = _prior_delta(problem, state).to(problem.prior_Lambda.dtype)
    g = -(problem.prior_Lambda @ d)
    if problem.prior_b is not None:
        g = g + problem.prior_b
    return diag, (C, iu.to(torch.int32), ju.to(torch.int32)), g.reshape(O, D)


def vio_cost(problem: VIOProblem, state: VIOState,
             axis_name: str | None = None,
             huber_delta: float | None = None) -> torch.Tensor:
    """Total cost (f64): whitened reprojection (optionally Huber) + 1e10
    per behind-camera observation + IMU + bias walk + bias prior + the
    marginal head prior."""
    schur.no_sharding(axis_name, "vio_cost")
    N = problem.free_pose.shape[0]
    r, valid = reprojection_residual_ell(
        problem.K,
        _camera_quats(problem, state.q),
        state.p,
        state.lm,
        problem.lm_idx.reshape(N, -1),
        problem.uv.T.reshape(2, N, -1),
    )
    f64 = torch.float64
    wf = problem.obs_weight.reshape(N, -1)
    wv = wf * valid.to(r.dtype)
    sq_white = (r[0] * r[0] + r[1] * r[1]) / problem.pixel_sigma**2
    if huber_delta is None:
        c = 0.5 * torch.sum(wv * sq_white).to(f64)
    else:
        c = torch.sum(wv * _huber_rho(sq_white, huber_delta)).to(f64)
    c = c + _CHEIRALITY_PENALTY * torch.sum(wf * (~valid).to(r.dtype)).to(f64)
    res, z = _imu_whitened(problem, state)  # residual only: no Jacobian
    r_imu = res(z, z)
    c = c + 0.5 * torch.sum(r_imu * r_imu).to(f64)
    r_bw, _, _ = _bias_walk_linearize(problem, state)
    c = c + 0.5 * torch.sum(r_bw * r_bw).to(f64)
    if problem.bias_prior_sqrt_info is not None:
        rp = torch.cat([state.bg, state.ba], dim=-1) * \
            problem.bias_prior_sqrt_info
        c = c + 0.5 * torch.sum(rp * rp).to(f64)
    if problem.prior_Lambda is not None:
        c = c + _prior_cost(problem, state).to(f64)
    return c


def _linearize_vio(problem: VIOProblem, state: VIOState, lam,
                   huber_delta: float | None = None,
                   axis_name: str | None = None,
                   hessian_dtype: str | None = None) -> schur.SchurBlocks:
    """Linearize every factor (reprojection + IMU + bias walk + bias prior
    + marginal head prior) at ``state`` and assemble damped normal-equation
    blocks. ``hessian_dtype`` widens the pose-block sums before they meet;
    the factor blocks stay in the state's dtype."""
    schur.no_sharding(axis_name, "_linearize_vio")
    N = problem.free_pose.shape[0]
    M = state.lm.shape[0]
    dtype = state.p.dtype

    # reprojection bank, pose-ELL component-major; the Jacobian touches
    # only [omega, dp] (6 of 15 dims: build_normal_equations' pose_dim).
    # The camera is body ∘ q_BC with zero lever arm, so
    # J_omega_body = J_omega_cam @ R_BC^T.
    r, J6, J_lm, valid = linearize_reprojection_ell(
        problem.K,
        _camera_quats(problem, state.q),
        state.p,
        state.lm,
        problem.lm_idx.reshape(N, -1),
        problem.uv.T.reshape(2, N, -1),
    )
    if problem.q_BC is not None:
        R_BC = so3.quat_to_rot(problem.q_BC)
        Jw = torch.stack([
            torch.stack([sum(J6[a, b] * R_BC[i, b] for b in range(3))
                         for i in range(3)])
            for a in range(2)
        ])
        J6 = torch.cat([Jw, J6[:, 3:6]], dim=1)
    w = (problem.obs_weight.reshape(N, -1) * valid.to(dtype)
         / problem.pixel_sigma**2)
    if huber_delta is not None:
        rn = torch.sqrt(torch.clamp(r[0] * r[0] + r[1] * r[1], min=1e-20)
                        ) / problem.pixel_sigma
        w = w * torch.clamp(huber_delta / rn, max=1.0)

    # IMU + bias-walk factors -> diagonal contributions + couplings
    r_imu, Ji, Jj = _imu_linearize(problem, state)
    r_bw, Bi, Bj = _bias_walk_linearize(problem, state)
    bi, bj = problem.imu_i, problem.imu_j
    bil, bjl = bi.long(), bj.long()
    JiT, JjT, BiT, BjT = Ji.mT, Jj.mT, Bi.mT, Bj.mT
    sdt = _dtype(hessian_dtype)

    def wide(x):
        return x if sdt is None else x.to(sdt)

    seg = schur._segment_sum0
    extra_Hpp = (seg(wide(JiT @ Ji + BiT @ Bi), bil, N)
                 + seg(wide(JjT @ Jj + BjT @ Bj), bjl, N))
    extra_bp = seg(
        wide(-torch.einsum("fij,fj->fi", JiT, r_imu)
             - torch.einsum("fij,fj->fi", BiT, r_bw)), bil, N,
    ) + seg(
        wide(-torch.einsum("fij,fj->fi", JjT, r_imu)
             - torch.einsum("fij,fj->fi", BjT, r_bw)), bjl, N,
    )
    C_bank, ci_bank, cj_bank = wide(JiT @ Jj + BiT @ Bj), bi, bj

    if problem.bias_prior_sqrt_info is not None:
        # (6,) shared across keyframes, or (N, 6) per keyframe
        si = problem.bias_prior_sqrt_info
        si2_n = torch.broadcast_to(si * si, (N, 6))
        diag_n = torch.cat([state.p.new_zeros((N, 9)), si2_n], dim=-1)
        eye = torch.eye(D, dtype=dtype, device=state.p.device)
        extra_Hpp = extra_Hpp + wide(eye[None] * diag_n[:, None, :])
        rp = torch.cat([state.bg, state.ba], dim=-1)
        extra_bp = extra_bp - wide(torch.cat(
            [state.p.new_zeros((N, 9)), rp * si2_n], dim=-1))

    if problem.prior_Lambda is not None:
        O = problem.prior_q.shape[0]
        Hp_add, (Cp, cpi, cpj), bp_add = _prior_terms(problem, state)
        extra_Hpp = torch.cat([extra_Hpp[:O] + wide(Hp_add), extra_Hpp[O:]])
        extra_bp = torch.cat([extra_bp[:O] + wide(bp_add), extra_bp[O:]])
        C_bank = torch.cat([C_bank, wide(Cp)])
        ci_bank = torch.cat([ci_bank, cpi])
        cj_bank = torch.cat([cj_bank, cpj])

    return schur.build_normal_equations(
        r, J6, J_lm, w, problem.pose_idx, problem.lm_idx,
        N, M, lam, problem.free_pose,
        extra_Hpp=extra_Hpp, extra_bp=extra_bp,
        couplings=(C_bank, ci_bank, cj_bank),
        ell=problem.ell, pose_dim=D, sum_dtype=sdt,
    )


@f32_matmuls
def vio_reduced_hessian(problem: VIOProblem, state: VIOState,
                        huber_delta: float | None = None,
                        hessian_dtype: str | None = None):
    """Dense landmark-eliminated Hessian + rhs of the full VIO graph at
    ``state``, undamped: ``(H (N*D, N*D), b (N*D,))`` with ``b = -grad``.
    No gauge projection is applied."""
    blocks = _linearize_vio(problem, state, 0.0, huber_delta, None,
                            hessian_dtype)
    S = schur.dense_reduced_system(blocks)
    b = schur.schur_rhs(blocks)
    N = b.shape[0]
    return S.reshape(N * D, N * D), b.reshape(-1)


@f32_matmuls
def vio_marginalize_device(problem: VIOProblem, state: VIOState,
                           keep_dim: int,
                           huber_delta: float | None = None,
                           hessian_dtype: str | None = None):
    """Schur-complement marginalization on the device: only the (keep_dim,
    keep_dim) prior and its rhs leave it. The leading ``n - keep_dim``
    coordinates are marginalized out with an equilibrated, ridge-lifted
    Cholesky in the (possibly widened) Hessian dtype. Returns
    ``(Lambda, b_m)``; callers apply their own PSD projection."""
    blocks = _linearize_vio(problem, state, 0.0, huber_delta, None,
                            hessian_dtype)
    S = schur.dense_reduced_system(blocks)
    b = schur.schur_rhs(blocks)
    N = b.shape[0]
    n = N * D
    H = S.reshape(n, n)
    bf = b.reshape(-1)
    cut = n - keep_dim
    Hoo = H[:cut, :cut]
    dg = torch.diagonal(Hoo)
    ridge = 1e-10 if H.dtype == torch.float64 else 1e-7
    Hoo = Hoo + torch.diag(ridge * torch.clamp(dg, min=1.0))
    d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Hoo), min=1e-12))
    Hoo_e = d[:, None] * Hoo * d[None, :]
    rhs = torch.cat([H[:cut, cut:], bf[:cut, None]], dim=1)
    sol = d[:, None] * schur.chol_solve_mixed(Hoo_e, d[:, None] * rhs)
    Lam = H[cut:, cut:] - H[:cut, cut:].T @ sol[:, :keep_dim]
    b_m = bf[cut:] - H[:cut, cut:].T @ sol[:, -1]
    return 0.5 * (Lam + Lam.T), b_m


def _vio_iteration(problem: VIOProblem, cfg: VIOConfig, carry,
                   axis_name: str | None = None):
    """One LM step. ``carry`` = (state, lam, cost); returns the new carry
    and (cost, accepted, cg_iterations)."""
    schur.no_sharding(axis_name, "_vio_iteration")
    state, lam, cost = carry
    N = problem.free_pose.shape[0]
    M = state.lm.shape[0]
    # static solver choice first: the widened-Hessian path only pays off
    # under the dense factorization, so PCG keeps the state's dtype. The
    # G-bytes gate uses the f32 itemsize, as the G/A build is f32.
    use_dense = _use_dense_schur(cfg, N, D, 6, M, 4, None)
    hdt = cfg.hessian_dtype if use_dense else None
    blocks = _linearize_vio(problem, state, lam, cfg.huber_delta, None, hdt)
    rhs = schur.schur_rhs(blocks)
    if use_dense:
        dx = schur.dense_schur_solve(blocks, rhs).to(state.p.dtype)
        cg_iterations = torch.zeros((), dtype=torch.int32,
                                    device=rhs.device)
    else:
        cg = schur.pcg(blocks, rhs, max_iters=cfg.cg_max_iters,
                       tol=cfg.cg_tol)
        dx = cg.x.to(state.p.dtype)
        cg_iterations = cg.iterations
    dlm = schur.back_substitute(blocks, dx)

    new_state = state.retract(dx, dlm, problem.free_pose)
    new_cost = vio_cost(problem, new_state, None, cfg.huber_delta)
    step_ok = torch.isfinite(torch.sum(dx)) & torch.isfinite(torch.sum(dlm))
    accept = (new_cost < cost) & torch.isfinite(new_cost) & step_ok
    state = VIOState(*(torch.where(accept, new, old)
                       for new, old in zip(new_state, state)))
    cost = torch.where(accept, new_cost, cost)
    lam = torch.clip(
        torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up),
        1e-10, 1e8,
    )
    return (state, lam, cost), (cost, accept, cg_iterations)


@f32_matmuls
def solve_vio(problem: VIOProblem, state: VIOState,
              cfg: VIOConfig = VIOConfig(),
              axis_name: str | None = None, lam0=None):
    """Run ``cfg.max_iterations`` LM iterations on the device of
    ``state``. Returns (state, info dict of tensors): initial and final
    cost (f64), the per-iteration accepted cost, acceptance flags, CG
    iteration counts and the final lambda. ``lam0`` (a 0-d tensor or a
    number) is the starting lambda, so a caller can chunk a solve without
    resetting the lambda adaptation."""
    schur.no_sharding(axis_name, "solve_vio")
    cost0 = vio_cost(problem, state, None, cfg.huber_delta)
    if lam0 is None:
        lam0 = cfg.init_lambda
    if isinstance(lam0, torch.Tensor):
        lam = lam0.to(dtype=state.p.dtype, device=state.p.device)
    else:
        lam = state.p.new_full((), float(lam0))
    carry = (state, lam, cost0)
    costs, accepts, cg_iters = [], [], []
    for _ in range(cfg.max_iterations):
        carry, (c, a, it) = _vio_iteration(problem, cfg, carry)
        costs.append(c)
        accepts.append(a)
        cg_iters.append(it)
    state, lam, cost = carry
    return state, {
        "initial_cost": cost0,
        "final_cost": cost,
        "costs": torch.stack(costs),
        "accepted": torch.stack(accepts),
        "cg_iterations": torch.stack(cg_iters),
        "final_lambda": lam,
    }


def vio_dead_reckon(problem: VIOProblem, q0, p0, v0, lm_init) -> VIOState:
    """Initialize keyframe states by propagating the preintegrated IMU
    deltas from (q0, p0, v0), one keyframe interval after another.
    Landmarks come from the caller."""
    g = vec3(problem.gravity, p0)
    pim = problem.pim
    q, p, v = q0, p0, v0
    qs, ps, vs = [q0], [p0], [v0]
    for f in range(pim.dq.shape[0]):
        dt = pim.dt_total[f]
        R = so3.quat_to_rot(q)
        p = p + v * dt + 0.5 * g * dt * dt + R @ pim.dp[f]
        v = v + g * dt + R @ pim.dv[f]
        q = so3.quat_multiply(q, pim.dq[f])
        qs.append(q)
        ps.append(p)
        vs.append(v)
    N = len(qs)
    return VIOState(
        q=torch.stack(qs), p=torch.stack(ps), v=torch.stack(vs),
        bg=p0.new_zeros((N, 3)), ba=p0.new_zeros((N, 3)), lm=lm_init,
    )


def solve_vio_staged(problem: VIOProblem, state: VIOState,
                     cfg: VIOConfig = VIOConfig(),
                     vision_stage_scale: float = 1e-3):
    """Two-stage solve: down-weighted inertial factors first, then the full
    graph (see the reference's caution on a very small scale)."""
    soft = problem._replace(
        imu_sqrt_info=problem.imu_sqrt_info * vision_stage_scale,
        bias_walk_sqrt_info=problem.bias_walk_sqrt_info * vision_stage_scale,
    )
    state, _ = solve_vio(soft, state, cfg)
    return solve_vio(problem, state, cfg)


def _gradient(x, h):
    """``jnp.gradient(x, h, axis=0)``: central differences inside,
    one-sided at the ends."""
    inner = (x[2:] - x[:-2]) * 0.5 / h
    return torch.cat([(x[1:2] - x[0:1]) / h, inner, (x[-1:] - x[-2:-1]) / h])


def vio_from_sim(dataset, imu_rate_mult: int = 10, pixel_noise: float = 1.0,
                 imu_gyro_sigma: float = 1e-3, imu_accel_sigma: float = 1e-2,
                 generator: torch.Generator | None = None, q_BC=None,
                 device=None):
    """Build a VIOProblem from a synthetic VoDataset plus simulated IMU, on
    ``device`` (default: the card). IMU samples are generated at
    ``imu_rate_mult`` x the dataset step rate and preintegrated per
    keyframe interval. ``generator`` (on ``device``) draws the IMU and pixel
    noise; None gives the noise-free problem. Returns (problem, gt_state).
    """
    from libwave_tpu_torch.benchmark import Trajectory, interpolate_at
    from libwave_tpu_torch.geometry.se3 import SE3
    from libwave_tpu_torch.sim.vo_dataset import q_BC as default_q_BC

    device = resolve(device)
    ds = type(dataset)(*(x.to(device) for x in dataset))
    dtype = ds.robot_p_GB.dtype
    trig = ds.frame_has_obs.cpu().numpy()
    times_all = ds.times.cpu().numpy()
    frames = np.nonzero(trig)[0]
    N = len(frames)
    qbc = default_q_BC(dtype, device) if q_BC is None else q_BC
    fr = torch.as_tensor(frames, device=device)
    q_GB, p_GB = ds.robot_q_GB[fr], ds.robot_p_GB[fr]
    times = times_all[frames]

    # dense body trajectory for the IMU simulation
    dt_imu = float(times_all[1] - times_all[0]) / imu_rate_mult
    fine_t = torch.as_tensor(
        np.arange(float(times[0]), float(times[-1]) + 1e-9, dt_imu),
        dtype=dtype, device=device)
    fine = interpolate_at(
        Trajectory(ds.times, SE3(q=ds.robot_q_GB, t=ds.robot_p_GB)), fine_t)
    v_fine = _gradient(fine.t, dt_imu)
    gyro, accel = simulate_imu(
        fine.q, fine.t, v_fine, dt_imu, generator=generator,
        gyro_sigma=imu_gyro_sigma, accel_sigma=imu_accel_sigma,
    )

    # preintegrate every keyframe interval at once (equal-length windows;
    # a start past the end clamps, as dynamic_slice does in the reference)
    steps_per_kf = int(round((times[1] - times[0]) / dt_imu))
    n_imu = gyro.shape[0]
    starts = [min(max(int(round((times[i] - times[0]) / dt_imu)), 0),
                  n_imu - steps_per_kf) for i in range(N - 1)]
    win = (torch.as_tensor(starts, device=device)[:, None]
           + torch.arange(steps_per_kf, device=device))
    z3 = gyro.new_zeros(3)
    pim = preintegrate_imu(
        gyro[win], accel[win], dt_imu, z3, z3,
        gyro_noise_density=max(imu_gyro_sigma, 1e-5),
        accel_noise_density=max(imu_accel_sigma, 1e-4),
    )
    sqrt_infos = imu_sqrt_info(pim)

    # reprojection bank: (keyframe, landmark) pairs in row-major order
    vis = ds.visible.cpu().numpy()[frames]
    pose_idx, lm_idx = np.nonzero(vis)
    uv = ds.pixels[fr][torch.as_tensor(pose_idx, device=device),
                       torch.as_tensor(lm_idx, device=device)]
    if generator is not None and pixel_noise > 0:
        uv = uv + pixel_noise * torch.randn(uv.shape, generator=generator,
                                            dtype=uv.dtype, device=device)

    # gauge: fix only the POSE of the first keyframe
    free = np.ones((N, D))
    free[0, 0:6] = 0.0

    kf_idx = np.round((times - times[0]) / dt_imu).astype(int)
    v_kf = v_fine[torch.as_tensor(np.minimum(kf_idx, v_fine.shape[0] - 1),
                                  device=device)]

    M = int(ds.landmarks.shape[0])
    pose_ell, lm_ell, pad_mask, ell, uv_p = schur.pack_observations(
        pose_idx.astype(np.int32), lm_idx.astype(np.int32), N, M,
        uv.cpu().numpy(), device=device,
    )
    F = N - 1
    problem = VIOProblem(
        K=ds.camera_K.to(dtype),
        pose_idx=pose_ell,
        lm_idx=lm_ell,
        uv=uv_p.to(dtype),
        obs_weight=pad_mask.to(dtype),
        pim=pim,
        imu_i=torch.arange(F, dtype=torch.int32, device=device),
        imu_j=torch.arange(1, N, dtype=torch.int32, device=device),
        imu_sqrt_info=sqrt_infos,
        bias_walk_sqrt_info=torch.full((6,), 1e3, dtype=dtype, device=device),
        bias_prior_sqrt_info=torch.tensor([1e2] * 3 + [1e1] * 3, dtype=dtype,
                                          device=device),
        ell=ell,
        free_pose=torch.as_tensor(free, dtype=dtype, device=device),
        q_BC=qbc,
        pixel_sigma=max(pixel_noise, 0.5),
    )
    gt = VIOState(
        q=q_GB, p=p_GB, v=v_kf,
        bg=p_GB.new_zeros((N, 3)), ba=p_GB.new_zeros((N, 3)),
        lm=ds.landmarks,
    )
    return problem, gt
