"""Bundle adjustment: problem container + Levenberg-Marquardt solve.

Port of ``libwave_tpu.optim.ba``. The problem is a fixed-shape observation
bank (pose_idx, lm_idx, uv, weight). One LM iteration = closed-form
linearization -> normal equations -> batched 3x3 landmark elimination ->
PCG on the reduced camera system (matrix-free, or against an explicit S
whose G/A build is the CUDA kernel) -> back-substitution -> manifold
retraction, with a trust-region lambda update on cost decrease.

``axis_name`` (a ``parallel.mesh.Axis``) runs one rank's share of a sharded
solve (``parallel.dist_ba``): the rank's bank is a contiguous pose block
(pose-ELL) or a slice of a flat bank, the state and the LM loop are
replicated, the reduced system is solved by matrix-free PCG. A
``parallel.mesh.Sharding`` in its place: the flat bank and the landmark
state are the rank's chunk of landmark rows (the one-step's ``tp``), and a
scalar over landmark rows is agreed over the ranks of the other chunks.

The reference's ``lax.scan`` over LM iterations is a Python loop of fixed
length here. Acceptance, convergence and lambda stay 0-d tensors updated
with ``torch.where``: nothing inside the loop reads a device value on the
host, and every iteration runs even after convergence, as in the reference.

:func:`solve_ba_batched` is the port's ``jax.vmap(solve_ba)``: B problems
of one shape solved as one disjoint union, each window with its own lambda,
cost, acceptance and convergence ((B,) tensors). :func:`ba_from_dataset`
builds a problem and its ground truth from a synthetic VO dataset.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.optim import pose_graph, schur
from libwave_tpu_torch.optim.reprojection import (
    linearize_reprojection_cm,
    linearize_reprojection_ell,
    reprojection_residual_cm,
    reprojection_residual_ell,
)
from libwave_tpu_torch.ops import segmm
from libwave_tpu_torch.utils.device import resolve
from libwave_tpu_torch.utils.precision import f32_matmuls, sums
from libwave_tpu_torch.utils.trace import SOLVE_SPAN, count, span


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

    K: torch.Tensor  # (3, 3) intrinsics; (3, 3, N, 1) per pose (batched)
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


def _local_pose_view(state: BAState, num_poses: int, axis_name):
    """(q, p, nb) for the ELL bank: the full state on one device, or this
    rank's contiguous pose block when sharded (the bank is local)."""
    q, nb = schur.local_pose_block(state.q, num_poses, axis_name)
    p, _ = schur.local_pose_block(state.p, num_poses, axis_name)
    return q, p, nb


def ba_cost(problem: BAProblem, state: BAState,
            huber_delta: float | None = None,
            axis_name=None,
            windows: int | None = None) -> torch.Tensor:
    """Weighted (optionally Huber-robustified) reprojection cost +
    pose-graph factor cost + a fixed penalty per behind-camera
    observation. ``windows``: ``problem`` is that many equal windows of a
    disjoint union (:func:`solve_ba_batched`); the cost is (windows,), each
    window's sums reduced on their own. ``axis_name``: the bank is this
    rank's share; its cost psums over the axis and the (replicated)
    pose-graph cost is added once."""
    with span("ba.cost"):
        total = sums(windows)
        if problem.ell is not None:
            N = problem.free_pose.shape[0]
            q, p, nb = _local_pose_view(state, N, axis_name)
            r, valid = reprojection_residual_ell(
                problem.K, q, p, state.lm,
                problem.lm_idx.reshape(nb, -1),
                problem.uv.T.reshape(2, nb, -1),
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
            c = 0.5 * total(problem.weight * sq)
        else:
            c = total(problem.weight * _huber_rho(sq, huber_delta))
        c = c + _CHEIRALITY_PENALTY * total(
            problem.weight * (~valid).to(r.dtype)
        )
        if axis_name is not None:
            c = schur.pose_axis(axis_name).psum(c)
        c = c + pose_graph.pose_graph_cost(
            state.q, state.p, problem.between, problem.priors, windows
        )
        if problem.prior_Lambda is not None:
            c = c + _prior_cost(problem, state)
        return c


def _linearize_ba(problem: BAProblem, state: BAState, lam,
                  huber_delta: float | None = None,
                  axis_name=None,
                  lm_lam=None) -> schur.SchurBlocks:
    """Linearize every factor (reprojection + pose-graph + marginal head
    prior) at ``state`` and assemble damped normal-equation blocks. Shared
    by the LM iteration and by :func:`ba_reduced_hessian` (``lam=0``).
    ``lm_lam``: the landmarks' damping when it differs from the poses'
    (per pose and per landmark in the batched solve). ``axis_name``: the
    bank is this rank's share (sharded blocks)."""
    with span("ba.linearize"):
        N = problem.free_pose.shape[0]
        M = state.lm.shape[0]

        if problem.ell is not None:
            q_loc, p_loc, nb = _local_pose_view(state, N, axis_name)
            r, J_pose, J_lm, valid = linearize_reprojection_ell(
                problem.K, q_loc, p_loc, state.lm,
                problem.lm_idx.reshape(nb, -1),
                problem.uv.T.reshape(2, nb, -1),
            )
            w = problem.weight.reshape(nb, -1) * valid.to(r.dtype)
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
            ell=problem.ell, axis_name=axis_name, lm_damping=lm_lam,
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


def _reduced_step(problem: BAProblem, cfg: BAConfig, blocks, rhs):
    """Solve the reduced camera system: dense Schur, or PCG (matrix-free or
    against an explicit S; matrix-free for sharded blocks). Returns
    (dx_pose, CG iterations)."""
    axis_name = blocks.axis_name
    N = blocks.Hpp.shape[0]
    M = blocks.bl.shape[-1]
    itemsize = rhs.element_size()
    if _use_dense_schur(cfg, N, 6, 6, M, itemsize, axis_name):
        return schur.dense_schur_solve(blocks, rhs), torch.zeros(
            (), dtype=torch.int32, device=rhs.device)
    with span("schur.pcg"):
        S4 = None
        if _use_explicit_s(
            cfg, N, 6, M, itemsize, problem.ell, axis_name, problem.bands,
            device=rhs.device,
        ):
            S4 = schur.dense_reduced_system(
                blocks, max_g_bytes=cfg.dense_max_g_bytes, bands=problem.bands,
            )
        cg = schur.pcg(
            blocks, rhs, max_iters=cfg.cg_max_iters, tol=cfg.cg_tol, S4=S4
        )
    return cg.x, cg.iterations


class _Single:
    """One problem, seen through :class:`_Windows`' interface: its lambda,
    cost and flags are scalars that broadcast as they are."""

    count = None

    @staticmethod
    def per_pose(x):
        return x

    per_landmark = per_pose

    @staticmethod
    def reduced_step(cfg: BAConfig, problem: BAProblem, blocks, rhs):
        return _reduced_step(problem, cfg, blocks, rhs)


def _lm_iteration(problem: BAProblem, cfg: BAConfig, carry,
                  axis_name=None, windows=_Single):
    """One LM step. ``carry`` = (state, lam, cost, converged), all tensors;
    returns the new carry and (cost, accepted, cg_iterations). With
    ``windows`` (a :class:`_Windows`), ``problem`` is their disjoint union
    and lam, cost, converged and the outputs are (B,)."""
    state, lam, cost, converged = carry
    blocks = _linearize_ba(problem, state, windows.per_pose(lam),
                           cfg.huber_delta, axis_name,
                           lm_lam=windows.per_landmark(lam))
    rhs = schur.schur_rhs(blocks)
    dx_pose, cg_iterations = windows.reduced_step(cfg, problem, blocks, rhs)
    dx_lm = schur.back_substitute(blocks, dx_pose)

    free = problem.free_pose[:, None]
    new_state = BAState(
        q=so3.quat_boxplus(state.q, dx_pose[:, 0:3] * free),
        p=state.p + dx_pose[:, 3:6] * free,
        lm=state.lm + dx_lm,
    )
    new_cost = ba_cost(problem, new_state, cfg.huber_delta, axis_name,
                       windows.count)
    with span("ba.update"):
        total = sums(windows.count)
        lm_total = total(dx_lm)
        chunk = getattr(axis_name, "chunk", None)
        if chunk is not None:  # landmark chunks: one rank of each adds its own
            lm_total = chunk.psum(lm_total)
        step_ok = torch.isfinite(total(dx_pose)) & torch.isfinite(lm_total)
        accept = ((new_cost < cost) & ~converged & torch.isfinite(new_cost)
                  & step_ok)
        decrease = cost - new_cost
        converged = converged | (
            accept
            & (decrease < cfg.relative_decrease_tol * cost
               + cfg.absolute_decrease_tol)
        )
        keep = (windows.per_pose(accept),) * 2 + (
            windows.per_landmark(accept)[..., None],)
        state = BAState(*(torch.where(k, new, old)
                          for k, new, old in zip(keep, new_state, state)))
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(
            converged,
            lam,
            torch.clip(
                torch.where(accept, lam * cfg.lambda_down,
                            lam * cfg.lambda_up),
                cfg.min_lambda,
                cfg.max_lambda,
            ),
        )
    return (state, lam, cost, converged), (cost, accept, cg_iterations)


@f32_matmuls
def solve_ba(problem: BAProblem, state: BAState, cfg: BAConfig = BAConfig(),
             axis_name=None):
    """Run ``cfg.max_iterations`` LM iterations. Returns (state, info dict
    of tensors): initial and final cost, the per-iteration accepted cost,
    acceptance flags, CG iteration counts and the final lambda.

    Runs on the device of ``state``; matmuls run with TF32 off.
    ``axis_name`` (a ``parallel.mesh.Axis``): this rank's share of a
    sharded solve (see :func:`libwave_tpu_torch.parallel.dist_ba.
    solve_ba_sharded`, the public entry point); every rank runs the same
    replicated LM loop on the all-reduced cost and takes the same steps.
    """
    cfg.validate()
    with span(SOLVE_SPAN, iterations=cfg.max_iterations,
              cg_max_iters=cfg.cg_max_iters):
        lam = torch.full((), cfg.init_lambda, dtype=state.p.dtype,
                         device=state.p.device)
        cost0 = ba_cost(problem, state, cfg.huber_delta, axis_name)
        carry = (state, lam, cost0,
                 torch.zeros((), dtype=torch.bool, device=state.p.device))
        costs, accepts, cg_iters = [], [], []
        for i in range(cfg.max_iterations):
            with span("ba.iteration", i=i):
                count("ba.lm_iterations")
                carry, (c, a, it) = _lm_iteration(problem, cfg, carry,
                                                  axis_name)
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


class _Windows(NamedTuple):
    """B windows of one shape packed as a disjoint union: window b holds
    poses ``[b*N, (b+1)*N)``, landmarks ``[b*M, (b+1)*M)`` and between
    factors ``[b*F, (b+1)*F)``; ``layouts`` are the windows' landmark
    layouts of their own slots, ``bands`` their own band plans."""

    count: int
    poses: int
    landmarks: int
    factors: int
    layouts: tuple
    bands: tuple

    def each(self):
        N, M, F = self.poses, self.landmarks, self.factors
        return [schur.Window(b * N, (b + 1) * N, b * M, (b + 1) * M, b * F,
                             (b + 1) * F) for b in range(self.count)]

    def per_pose(self, x):
        """(B,) -> (B*N, 1): each window's value on each of its poses."""
        return x[:, None].expand(self.count, self.poses).reshape(-1, 1)

    def per_landmark(self, x):
        """(B,) -> (B*M,): each window's value on each of its landmarks."""
        return x[:, None].expand(self.count, self.landmarks).reshape(-1)

    def reduced_step(self, cfg: BAConfig, problem: BAProblem, blocks, rhs):
        """Each window's reduced camera system, solved as
        :func:`_reduced_step` solves a problem of its own, on the window's
        view of the union's blocks: its G/A calls, products, Cholesky and
        CG (dots, step sizes, stopping test) are those of its own solve.
        Matrix-free CG so runs its matvecs window by window: an LM
        iteration launches 3 + B*cg reduces and 1 + B*(1 + cg) broadcasts
        at cg CG steps, against 3 and 1 on the dense and explicit-S routes.
        Returns (dx_pose, (B,) CG iterations)."""
        xs, its = [], []
        for w, layout, bands in zip(self.each(), self.layouts, self.bands):
            x, it = _reduced_step(
                problem._replace(ell=layout, bands=bands), cfg,
                schur.window_blocks(blocks, w, layout), rhs[w.plo:w.phi])
            xs.append(x)
            its.append(it)
        return torch.cat(xs), torch.stack(its)


def _union(problems, states):
    """The disjoint union of B pose-ELL problems of one shape (N poses, M
    landmarks, banks of equal sizes), built on their device without a host
    read. Slot banks are padded to the widest window with zero-weight
    slots; the landmark layout lists each window's slots in that window's
    order, so every landmark's reduce adds what its own solve adds, in the
    same order."""
    B = len(problems)
    if B == 0 or len(states) != B:
        raise ValueError(f"solve_ba_batched: {B} problems and {len(states)} "
                         "states; need one state per problem, at least one")
    p0 = problems[0]
    N, M = p0.num_poses, states[0].lm.shape[0]
    for pr, st in zip(problems, states):
        if pr.ell is None or pr.prior_Lambda is not None:
            raise ValueError("solve_ba_batched takes pose-ELL problems "
                             "(schur.pack_observations) without a dense "
                             "marginal prior")
        if pr.num_poses != N or st.lm.shape[0] != M:
            raise ValueError(f"solve_ba_batched: windows of {pr.num_poses} "
                             f"poses and {st.lm.shape[0]} landmarks; the "
                             f"first has {N} and {M}")
        for bank in ("between", "priors"):
            a, b = getattr(pr, bank), getattr(p0, bank)
            if (a is None) != (b is None) or (
                    a is not None and a.i.shape != b.i.shape):
                raise ValueError(f"solve_ba_batched: the windows' {bank} "
                                 "banks differ in size")
    P = max(pr.lm_idx.shape[0] // N for pr in problems)

    def slots(x, fill=0):
        """(N*Pb, ...) pose-ELL slots -> (N, P, ...), padded with fill."""
        x = x.reshape((N, -1) + x.shape[1:])
        if x.shape[1] == P:
            return x
        pad = x.new_full((N, P - x.shape[1]) + x.shape[2:], fill)
        return torch.cat([x, pad], dim=1)

    def cat(fn):
        return torch.cat([fn(b, pr) for b, pr in enumerate(problems)])

    lm_idx = cat(lambda b, pr: slots(pr.lm_idx) + b * M).reshape(-1)
    listed = cat(lambda b, pr: slots(
        segmm.layout_ids(pr.ell, pr.lm_idx.shape[0]) >= 0, False)).reshape(-1)
    dev = lm_idx.device
    K = torch.stack([pr.K for pr in problems]).permute(1, 2, 0)
    between = priors = None
    if p0.between is not None:
        between = pose_graph.BetweenBank(
            i=cat(lambda b, pr: pr.between.i + b * N),
            j=cat(lambda b, pr: pr.between.j + b * N),
            dq=cat(lambda b, pr: pr.between.dq),
            dp=cat(lambda b, pr: pr.between.dp),
            sqrt_info=cat(lambda b, pr: pr.between.sqrt_info))
    if p0.priors is not None:
        priors = pose_graph.PriorBank(
            i=cat(lambda b, pr: pr.priors.i + b * N),
            q=cat(lambda b, pr: pr.priors.q), p=cat(lambda b, pr: pr.priors.p),
            sqrt_info=cat(lambda b, pr: pr.priors.sqrt_info))
    problem = BAProblem(
        K=K[:, :, :, None].expand(3, 3, B, N).reshape(3, 3, B * N, 1),
        pose_idx=torch.arange(B * N, dtype=torch.int32, device=dev)[
            :, None].expand(B * N, P).reshape(-1),
        lm_idx=lm_idx,
        uv=cat(lambda b, pr: slots(pr.uv)).reshape(-1, 2),
        weight=cat(lambda b, pr: slots(pr.weight)).reshape(-1),
        free_pose=cat(lambda b, pr: pr.free_pose),
        between=between, priors=priors,
        ell=segmm.sorted_layout(torch.where(listed, lm_idx, B * M), B * M),
    )
    # each window's layout of its own (padded) slots: the same stable sort
    # as the union's, so a window's runs are its runs in the union
    local = (lm_idx.reshape(B, -1) - M * torch.arange(
        B, dtype=lm_idx.dtype, device=dev)[:, None])
    layouts = tuple(segmm.sorted_layout(torch.where(v, i, M), M)
                    for i, v in zip(local, listed.reshape(B, -1)))
    state = BAState(*(torch.cat(x) for x in zip(*states)))
    F = 0 if between is None else p0.between.i.shape[0]
    return problem, state, _Windows(B, N, M, F, layouts,
                                    tuple(pr.bands for pr in problems))


@f32_matmuls
def solve_ba_batched(problems, states, cfg: BAConfig = BAConfig()):
    """Solve B bundle-adjustment windows of one shape as one batch: the
    port's form of ``jax.vmap(solve_ba)``. ``problems`` and ``states`` are
    sequences of B pose-ELL :class:`BAProblem` / :class:`BAState` on one
    device, with N poses and M landmarks each and banks of equal sizes (a
    window's slot bank may be narrower: it is padded with zero-weight
    slots). Returns the states stacked, q (B, N, 4), p (B, N, 3), lm (B, M,
    3), and the info of :func:`solve_ba` with a leading (B,) (costs,
    accepted and cg_iterations (B, iterations)).

    Every window keeps its own lambda, cost, acceptance and frozen
    convergence: one window's rejection touches no other. The windows are
    packed as one disjoint union, so linearization, normal equations, the
    segment reduce and broadcast, back-substitution and the cost run once
    for all B; the reduced camera system is solved window by window (dense
    Schur: one G/A call per window and iteration, its own Cholesky). On the
    dense and explicit-S routes an LM iteration so launches 3 reduces and 1
    broadcast whatever B; matrix-free CG adds each window's own (see
    :meth:`_Windows.reduced_step`). Each window's sums are reduced on their
    own, so on a window of the widest slot bank the batch computes what the
    window's own :func:`solve_ba` computes."""
    cfg.validate()
    problem, state, windows = _union(problems, states)
    B = windows.count
    dev = state.p.device
    with span(SOLVE_SPAN, iterations=cfg.max_iterations,
              cg_max_iters=cfg.cg_max_iters):
        lam = torch.full((B,), cfg.init_lambda, dtype=state.p.dtype,
                         device=dev)
        cost0 = ba_cost(problem, state, cfg.huber_delta, windows=B)
        carry = (state, lam, cost0, torch.zeros((B,), dtype=torch.bool,
                                                device=dev))
        costs, accepts, cg_iters = [], [], []
        for i in range(cfg.max_iterations):
            with span("ba.iteration", i=i):
                count("ba.lm_iterations")
                carry, (c, a, it) = _lm_iteration(problem, cfg, carry,
                                                  windows=windows)
            costs.append(c)
            accepts.append(a)
            cg_iters.append(it)
    state, lam, cost, _ = carry
    N, M = windows.poses, windows.landmarks
    out = BAState(q=state.q.reshape(B, N, 4), p=state.p.reshape(B, N, 3),
                  lm=state.lm.reshape(B, M, 3))
    info = {
        "initial_cost": cost0,
        "final_cost": cost,
        "costs": torch.stack(costs, dim=1),
        "accepted": torch.stack(accepts, dim=1),
        "cg_iterations": torch.stack(cg_iters, dim=1),
        "final_lambda": lam,
    }
    return out, info


def ba_from_dataset(dataset, noise_pixels: float = 0.0,
                    generator: torch.Generator | None = None,
                    max_obs: int | None = None, with_odometry: bool = False,
                    with_priors: bool = False, device=None):
    """A :class:`BAProblem` and its ground-truth :class:`BAState` from a
    synthetic VO dataset (port of ``libwave_tpu.optim.ba.ba_from_dataset``;
    the reference's ba_test.cpp:62-193), on ``device`` (default: the
    card). Returns ``(problem, gt_state)``; callers perturb the state.

    Only frames where the camera triggered become poses, q_GC = q_GB ⊗
    q_BC. Observations run frame-major, landmark id ascending within a
    frame (that order fixes the ELL layout and where ``max_obs`` cuts).
    With ``noise_pixels`` and ``generator``, pixels get that much standard
    normal noise, drawn on the generator's device in the pixels' dtype (the
    JAX package draws from a key). The first two poses are the gauge;
    ``with_priors`` frees them and puts priors of sqrt-information 1e5
    (rotation) and 1e6 (translation) on them; ``with_odometry`` adds
    ground-truth between factors of sigmas 1e-3 and 1e-4."""
    from libwave_tpu_torch.sim.vo_dataset import q_BC

    device = resolve(device)
    vis = dataset.visible.to(device)
    frames = torch.nonzero(dataset.frame_has_obs.to(device))[:, 0]
    M = dataset.landmarks.shape[0]
    q_GB = dataset.robot_q_GB.to(device)[frames]
    p_GB = dataset.robot_p_GB.to(device)[frames]
    q_GC = so3.quat_multiply(q_GB, q_BC(q_GB.dtype, device))

    # row-major nonzero: frame-major, ids ascending within a frame
    pose_idx, lm_idx = torch.nonzero(vis[frames], as_tuple=True)
    uv = dataset.pixels.to(device)[frames[pose_idx], lm_idx]
    if generator is not None and noise_pixels > 0:
        uv = uv + noise_pixels * torch.randn(
            uv.shape, generator=generator, dtype=uv.dtype,
            device=generator.device).to(device)
    if max_obs is not None:
        pose_idx, lm_idx, uv = pose_idx[:max_obs], lm_idx[:max_obs], uv[:max_obs]

    N = frames.shape[0]
    free = np.ones(N)
    free[:2] = 0.0
    gt = BAState(q=q_GC, p=p_GB, lm=dataset.landmarks.to(device))
    between = priors = None
    if with_odometry:
        between = pose_graph.between_from_trajectory(
            gt.q, gt.p, sigmas_rot=1e-3, sigmas_trans=1e-4)
    if with_priors:
        free[:] = 1.0
        si = torch.tensor([1e5] * 3 + [1e6] * 3, dtype=uv.dtype,
                          device=device)
        priors = pose_graph.PriorBank(
            i=torch.tensor([0, 1], dtype=torch.int32, device=device),
            q=gt.q[:2], p=gt.p[:2], sqrt_info=si.expand(2, 6).contiguous())
    pose_ell, lm_ell, pad_mask, ell, uv_p = schur.pack_observations(
        pose_idx, lm_idx, N, M, uv, device=device)
    problem = BAProblem(
        K=dataset.camera_K.to(device),
        pose_idx=pose_ell, lm_idx=lm_ell, uv=uv_p,
        weight=pad_mask.to(uv.dtype),
        free_pose=torch.as_tensor(free, dtype=uv.dtype, device=device),
        between=between, priors=priors, ell=ell,
    )
    return problem, gt
