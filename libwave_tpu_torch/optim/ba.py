"""Bundle adjustment: problem container + Levenberg-Marquardt solve.

Port of ``libwave_tpu.optim.ba``. The problem is a fixed-shape observation
bank (pose_idx, lm_idx, uv, weight). One LM iteration = closed-form
linearization -> normal equations -> batched 3x3 landmark elimination ->
PCG on the reduced camera system (matrix-free, or against an explicit S
whose G/A build is the CUDA kernel) -> back-substitution -> manifold
retraction, with a trust-region lambda update on cost decrease.

The reference's ``lax.scan`` over LM iterations is a Python loop of fixed
length here. Acceptance, convergence and lambda stay 0-d tensors updated
with ``torch.where``: nothing inside the loop reads a device value on the
host, and every iteration runs even after convergence, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.optim import pose_graph, schur
from libwave_tpu_torch.optim.reprojection import (
    linearize_reprojection_cm,
    linearize_reprojection_ell,
    reprojection_residual_cm,
    reprojection_residual_ell,
)
from libwave_tpu_torch.utils.precision import f32_matmuls


class BAProblem(NamedTuple):
    """Fixed-shape bundle-adjustment problem.

    When ``ell`` is set, the observation bank MUST be in pose-ELL order:
    rectangular, ``Pmax = K_ / N`` slots per pose (pose_idx =
    repeat(arange(N), Pmax)), padding slots carrying zero weight — use
    :func:`libwave_tpu_torch.optim.schur.pack_observations`. With
    ``ell=None`` the bank is a flat pose-sorted list and the solver uses
    segment sums.

    ``between``/``priors`` optionally add pose-graph factors; ``None``
    means absent. ``prior_*`` is a dense marginal prior on the head O
    poses: cost 0.5 d^T Lambda d - b^T d with d the (O*6,) tangent delta
    [omega, dp] of poses [0, O) from the prior mean. ``bands`` is a
    :class:`schur.BandPlan` for the explicit-S build, or None.
    """

    K: torch.Tensor  # (3, 3) intrinsics
    pose_idx: torch.Tensor  # (K_,) int32 — observation -> pose
    lm_idx: torch.Tensor  # (K_,) int32 — observation -> landmark
    uv: torch.Tensor  # (K_, 2) pixel measurements
    weight: torch.Tensor  # (K_,) 0 for padding/invalid observations
    free_pose: torch.Tensor  # (N,) 1.0 free / 0.0 gauge-fixed
    between: object = None  # BetweenBank | None
    priors: object = None  # PriorBank | None
    ell: object = None  # schur.EllLayout | None (pose-ELL fast path)
    prior_Lambda: torch.Tensor = None  # (O*6, O*6)
    prior_b: torch.Tensor = None  # (O*6,)
    prior_q: torch.Tensor = None  # (O, 4) mean orientations
    prior_p: torch.Tensor = None  # (O, 3) mean positions
    bands: object = None  # schur.BandPlan | None

    @property
    def num_poses(self) -> int:
        return self.free_pose.shape[0]


class BAState(NamedTuple):
    """Optimizable variables: camera poses (q_GC, p_GC) and landmarks."""

    q: torch.Tensor  # (N, 4) camera orientations (camera-to-world)
    p: torch.Tensor  # (N, 3) camera positions
    lm: torch.Tensor  # (M, 3) landmark positions


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """LM and solver settings; defaults and meanings as in the reference
    (``libwave_tpu/optim/ba.py:90-177``)."""

    max_iterations: int = 20
    cg_max_iters: int = 100
    cg_tol: float = 1e-6
    init_lambda: float = 1e-4
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    min_lambda: float = 1e-8
    max_lambda: float = 1e6
    # GTSAM-style stopping: once an accepted step improves cost by less
    # than these, the solve freezes.
    relative_decrease_tol: float = 1e-5
    absolute_decrease_tol: float = 1e-9
    # Huber robust loss scale in pixels (None = plain L2), applied by IRLS.
    huber_delta: float = None
    # Reduced-camera-system solver: "pcg", "dense" (explicit Schur +
    # Cholesky) or "auto" (dense when it fits the gates below).
    solver: str = "pcg"
    # Explicit-S PCG: materialize S once per LM iteration and run the same
    # PCG against it. "auto" uses it for single-device pose-ELL problems on
    # a CUDA device when S fits explicit_max_s_bytes (and M fits
    # explicit_max_landmarks unless a band plan bounds the work);
    # "never"/"always" override. The thresholds were measured on a TPU
    # and are defaults only until they are measured on the card.
    explicit_s: str = "auto"
    explicit_max_s_bytes: float = 4e8  # (N*D)^2 cap for materialized S
    explicit_max_landmarks: int = 20_000
    # Storage dtype of the explicit-S operator. Only "f32" is ported: the
    # reference measured "bf16" as unusable for ill-conditioned BA.
    s_op_dtype: str = "f32"
    dense_max_pose_dim: int = 4096  # N*D cap for the dense path
    dense_max_g_bytes: float = 1.5e9  # cap on the (N*Dj, 3M) scatter
    dense_max_landmarks: int = 1500

    def validate(self):
        if self.max_iterations <= 0:
            raise ValueError("max_iterations must be > 0")
        if self.solver not in ("auto", "pcg", "dense"):
            raise ValueError("solver must be auto | pcg | dense")
        if self.explicit_s not in ("auto", "never", "always"):
            raise ValueError("explicit_s must be auto | never | always")
        if self.s_op_dtype == "bf16":
            raise ValueError(
                "s_op_dtype='bf16' is not supported by the PyTorch port: the "
                "reference measured the bf16 explicit-S operator as unusable "
                "for ill-conditioned BA; use 'f32'"
            )
        if self.s_op_dtype != "f32":
            raise ValueError("s_op_dtype must be f32")


def _use_dense_schur(cfg, N, D, Dj, M, itemsize, axis_name):
    """Static solver choice: dense Schur when allowed and it fits."""
    if axis_name is not None:
        return False
    if cfg.solver == "pcg":
        return False
    g_bytes = itemsize * N * Dj * 3 * M
    fits = N * D <= cfg.dense_max_pose_dim and g_bytes <= cfg.dense_max_g_bytes
    if cfg.solver == "dense":
        if not fits:
            raise ValueError(
                f"dense solver requested but N*D={N * D} or G bytes "
                f"{g_bytes:.2e} exceed the configured caps"
            )
        return True
    return fits and M <= cfg.dense_max_landmarks


def _use_explicit_s(cfg, N, D, M, itemsize, ell, axis_name, bands=None,
                    device=None):
    """Static choice of the explicit-S PCG matvec: gated on structure
    (pose-ELL, single-device), the S footprint, the landmark count, and
    for "auto" on ``device`` being a CUDA device (where the G/A kernel
    runs)."""
    if cfg.explicit_s == "never":
        return False
    if axis_name is not None or ell is None:
        return False
    if itemsize * (N * D) ** 2 > cfg.explicit_max_s_bytes:
        return False
    if cfg.explicit_s == "always":
        return True
    if M > cfg.explicit_max_landmarks and bands is None:
        # dense explicit work is linear in M; a band plan bounds it by
        # the covisibility share instead, so banded problems skip the cap
        return False
    return device is not None and torch.device(device).type == "cuda"


# Penalty charged per cheirality-violated observation: without it, a step
# that pushes points behind the camera zeroes their (masked) residuals and
# the LM acceptance test mistakes that for an improvement. (The VIO back
# end uses its own, larger penalty.)
_CHEIRALITY_PENALTY = 1e6


def _huber_rho(sq_norm, delta):
    """Huber loss on squared residual norms: 0.5 r^2 inside, delta(|r| -
    0.5 delta) outside."""
    rn = torch.sqrt(torch.clamp(sq_norm, min=1e-20))
    return torch.where(
        rn <= delta, 0.5 * sq_norm, delta * (rn - 0.5 * delta)
    )


def _prior_delta(problem: BAProblem, state: BAState) -> torch.Tensor:
    """Tangent delta (O*6,) of the head poses from the prior mean, in
    retraction order [omega, dp]."""
    O = problem.prior_q.shape[0]
    return torch.cat(
        [
            so3.quat_boxminus(state.q[:O], problem.prior_q),
            state.p[:O] - problem.prior_p,
        ],
        dim=-1,
    ).reshape(-1)


def _prior_cost(problem: BAProblem, state: BAState) -> torch.Tensor:
    d = _prior_delta(problem, state)
    c = 0.5 * (d @ (problem.prior_Lambda @ d))
    if problem.prior_b is not None:
        c = c - problem.prior_b @ d
    return c


def _prior_terms(problem: BAProblem, state: BAState):
    """Normal-equation contributions of the dense head prior: per-pose
    diagonal blocks, upper-triangle cross couplings, and the rhs."""
    O = problem.prior_q.shape[0]
    dev = problem.prior_Lambda.device
    Lam4 = problem.prior_Lambda.reshape(O, 6, O, 6)
    ar = torch.arange(O, device=dev)
    diag = Lam4[ar, :, ar, :]  # (O, 6, 6)
    iu, ju = torch.triu_indices(O, O, offset=1, device=dev).to(torch.int32)
    C = Lam4[iu, :, ju, :]
    d = _prior_delta(problem, state)
    g = -(problem.prior_Lambda @ d)
    if problem.prior_b is not None:
        g = g + problem.prior_b
    return diag, (C, iu, ju), g.reshape(O, 6)


def ba_cost(problem: BAProblem, state: BAState,
            huber_delta: float | None = None,
            axis_name: str | None = None) -> torch.Tensor:
    """Weighted (optionally Huber-robustified) reprojection cost +
    pose-graph factor cost + a fixed penalty per behind-camera
    observation."""
    schur.no_sharding(axis_name, "ba_cost")
    if problem.ell is not None:
        N = problem.free_pose.shape[0]
        r, valid = reprojection_residual_ell(
            problem.K, state.q, state.p, state.lm,
            problem.lm_idx.reshape(N, -1),
            problem.uv.T.reshape(2, N, -1),
        )
        r = r.reshape(2, -1)
        valid = valid.reshape(-1)
    else:
        r, valid = reprojection_residual_cm(
            problem.K, state.q, state.p, state.lm,
            problem.pose_idx, problem.lm_idx, problem.uv.T,
        )
    sq = r[0] * r[0] + r[1] * r[1]
    if huber_delta is None:
        c = 0.5 * torch.sum(problem.weight * sq)
    else:
        c = torch.sum(problem.weight * _huber_rho(sq, huber_delta))
    c = c + _CHEIRALITY_PENALTY * torch.sum(
        problem.weight * (~valid).to(r.dtype)
    )
    c = c + pose_graph.pose_graph_cost(
        state.q, state.p, problem.between, problem.priors
    )
    if problem.prior_Lambda is not None:
        c = c + _prior_cost(problem, state)
    return c


def _linearize_ba(problem: BAProblem, state: BAState, lam,
                  huber_delta: float | None = None,
                  axis_name: str | None = None) -> schur.SchurBlocks:
    """Linearize every factor (reprojection + pose-graph + marginal head
    prior) at ``state`` and assemble damped normal-equation blocks. Shared
    by the LM iteration and by :func:`ba_reduced_hessian` (``lam=0``)."""
    schur.no_sharding(axis_name, "_linearize_ba")
    N = problem.free_pose.shape[0]
    M = state.lm.shape[0]

    if problem.ell is not None:
        r, J_pose, J_lm, valid = linearize_reprojection_ell(
            problem.K, state.q, state.p, state.lm,
            problem.lm_idx.reshape(N, -1),
            problem.uv.T.reshape(2, N, -1),
        )
        w = problem.weight.reshape(N, -1) * valid.to(r.dtype)
    else:
        r, J_pose, J_lm, valid = linearize_reprojection_cm(
            problem.K, state.q, state.p, state.lm,
            problem.pose_idx, problem.lm_idx, problem.uv.T,
        )
        w = problem.weight * valid.to(r.dtype)
    if huber_delta is not None:
        # IRLS weight rho'(r)/|r| = min(1, delta/|r|)
        rn = torch.sqrt(torch.clamp(r[0] * r[0] + r[1] * r[1], min=1e-20))
        w = w * torch.clamp(huber_delta / rn, max=1.0)

    # pose-graph factor contributions (odometry between-factors + priors)
    seg = schur._segment_sum0
    extra_Hpp = None
    extra_bp = None
    couplings = None
    if problem.between is not None:
        rb, Ji, Jj = pose_graph.linearize_between(
            problem.between, state.q, state.p
        )
        JiT = Ji.mT
        JjT = Jj.mT
        bi, bj = problem.between.i, problem.between.j
        extra_Hpp = seg(JiT @ Ji, bi, N) + seg(JjT @ Jj, bj, N)
        extra_bp = seg(
            -torch.einsum("fij,fj->fi", JiT, rb), bi, N
        ) + seg(-torch.einsum("fij,fj->fi", JjT, rb), bj, N)
        couplings = (JiT @ Jj, bi, bj)
    if problem.priors is not None:
        rp, Jp = pose_graph.linearize_prior(problem.priors, state.q, state.p)
        JpT = Jp.mT
        pi = problem.priors.i
        add_H = seg(JpT @ Jp, pi, N)
        add_b = seg(-torch.einsum("fij,fj->fi", JpT, rp), pi, N)
        extra_Hpp = add_H if extra_Hpp is None else extra_Hpp + add_H
        extra_bp = add_b if extra_bp is None else extra_bp + add_b

    if problem.prior_Lambda is not None:
        O = problem.prior_q.shape[0]
        Hp_add, (Cp, cpi, cpj), bp_add = _prior_terms(problem, state)
        if extra_Hpp is None:
            extra_Hpp = r.new_zeros((N, 6, 6))
            extra_bp = r.new_zeros((N, 6))
        extra_Hpp = torch.cat([extra_Hpp[:O] + Hp_add, extra_Hpp[O:]])
        extra_bp = torch.cat([extra_bp[:O] + bp_add, extra_bp[O:]])
        if couplings is None:
            couplings = (Cp, cpi, cpj)
        else:
            C0, ci0, cj0 = couplings
            couplings = (
                torch.cat([C0, Cp]),
                torch.cat([ci0, cpi]),
                torch.cat([cj0, cpj]),
            )

    return schur.build_normal_equations(
        r, J_pose, J_lm, w, problem.pose_idx, problem.lm_idx,
        N, M, lam, problem.free_pose,
        extra_Hpp=extra_Hpp, extra_bp=extra_bp, couplings=couplings,
        ell=problem.ell,
    )


@f32_matmuls
def ba_reduced_hessian(problem: BAProblem, state: BAState,
                       huber_delta: float | None = None):
    """Dense landmark-eliminated (reduced) Hessian + rhs of the BA graph at
    ``state``, undamped: ``(H (N*6, N*6), b (N*6,))`` with ``b = -grad``.
    No gauge projection beyond ``free_pose`` is applied."""
    blocks = _linearize_ba(problem, state, 0.0, huber_delta, None)
    S = schur.dense_reduced_system(blocks)
    b = schur.schur_rhs(blocks)
    N = b.shape[0]
    return S.reshape(N * 6, N * 6), b.reshape(-1)


def _lm_iteration(problem: BAProblem, cfg: BAConfig, carry,
                  axis_name: str | None = None):
    """One LM step. ``carry`` = (state, lam, cost, converged), all tensors;
    returns the new carry and (cost, accepted, cg_iterations)."""
    state, lam, cost, converged = carry
    N = problem.free_pose.shape[0]
    M = state.lm.shape[0]
    blocks = _linearize_ba(problem, state, lam, cfg.huber_delta, axis_name)
    rhs = schur.schur_rhs(blocks)
    itemsize = rhs.element_size()
    if _use_dense_schur(cfg, N, 6, 6, M, itemsize, axis_name):
        dx_pose = schur.dense_schur_solve(blocks, rhs)
        cg_iterations = torch.zeros((), dtype=torch.int32, device=rhs.device)
    else:
        S4 = None
        if _use_explicit_s(
            cfg, N, 6, M, itemsize, problem.ell, axis_name, problem.bands,
            device=rhs.device,
        ):
            S4 = schur.dense_reduced_system(
                blocks, max_g_bytes=cfg.dense_max_g_bytes,
                bands=problem.bands,
            )
        cg = schur.pcg(
            blocks, rhs, max_iters=cfg.cg_max_iters, tol=cfg.cg_tol, S4=S4
        )
        dx_pose = cg.x
        cg_iterations = cg.iterations
    dx_lm = schur.back_substitute(blocks, dx_pose)

    free = problem.free_pose[:, None]
    new_state = BAState(
        q=so3.quat_boxplus(state.q, dx_pose[:, 0:3] * free),
        p=state.p + dx_pose[:, 3:6] * free,
        lm=state.lm + dx_lm,
    )
    new_cost = ba_cost(problem, new_state, cfg.huber_delta, axis_name)
    step_ok = torch.isfinite(torch.sum(dx_pose)) & torch.isfinite(
        torch.sum(dx_lm)
    )
    accept = (new_cost < cost) & ~converged & torch.isfinite(new_cost) & step_ok
    decrease = cost - new_cost
    converged = converged | (
        accept
        & (decrease < cfg.relative_decrease_tol * cost
           + cfg.absolute_decrease_tol)
    )
    state = BAState(
        *(torch.where(accept, new, old) for new, old in zip(new_state, state))
    )
    cost = torch.where(accept, new_cost, cost)
    lam = torch.where(
        converged,
        lam,
        torch.clip(
            torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up),
            cfg.min_lambda,
            cfg.max_lambda,
        ),
    )
    return (state, lam, cost, converged), (cost, accept, cg_iterations)


@f32_matmuls
def solve_ba(problem: BAProblem, state: BAState, cfg: BAConfig = BAConfig(),
             axis_name: str | None = None):
    """Run ``cfg.max_iterations`` LM iterations. Returns (state, info dict
    of tensors): initial and final cost, the per-iteration accepted cost,
    acceptance flags, CG iteration counts and the final lambda.

    Runs on the device of ``state``; matmuls run with TF32 off.
    """
    schur.no_sharding(axis_name, "solve_ba")
    cfg.validate()
    lam = torch.full((), cfg.init_lambda, dtype=state.p.dtype,
                     device=state.p.device)
    cost0 = ba_cost(problem, state, cfg.huber_delta)
    carry = (state, lam, cost0,
             torch.zeros((), dtype=torch.bool, device=state.p.device))
    costs, accepts, cg_iters = [], [], []
    for _ in range(cfg.max_iterations):
        carry, (c, a, it) = _lm_iteration(problem, cfg, carry)
        costs.append(c)
        accepts.append(a)
        cg_iters.append(it)
    state, lam, cost, _ = carry
    info = {
        "initial_cost": cost0,
        "final_cost": cost,
        "costs": torch.stack(costs),
        "accepted": torch.stack(accepts),
        "cg_iterations": torch.stack(cg_iters),
        "final_lambda": lam,
    }
    return state, info
