"""Factor residuals over combined trajectory states and a dense LM solver
(port of ``libwave_tpu.optim.factors``).

The reference's wave_gtsam factor pack (SURVEY.md §2.6), each factor a
*bank*: index tensors select the instances, and one call evaluates the
residuals of all of them:

- ``motion_residual``: constant-velocity binary factor
  r = [v1·dt − Local(pose1, pose2); v1 − v2; (b1 − b2)]
  (motion_factor.hpp:31, impl/motion_factor_impl.hpp:8-66)
- ``gps_residual``: r = Logmap(T_meas⁻¹ ∘ (LiftedBias(B) ∘ T)), the bias
  lifted into translation (gps_factor_with_bias.hpp:19,
  src/gps_factor_with_bias.cpp:10-45)
- ``hand_eye_residual``: GPS↔sensor extrinsic calibration
  r = Logmap((T_LOCAL_S1 ∘ (LiftedBias ∘ T_S1_S2))⁻¹ ∘ T_LOCAL_S2)
  (hand_eye.hpp:20, src/hand_eye.cpp:14-62)
- ``decaying_bias_residual``: r = B2 − B1·exp(−dt/τ)
  (decaying_bias.hpp:14, src/decaying_bias.cpp)
- ``pose_prior_residual`` / ``twist_prior_residual`` /
  ``bias_prior_residual``: unary priors on state sub-blocks
  (pose_prior.hpp:14, twist_prior.hpp:9, bias_prior.hpp:9)

:func:`solve_trajectory_gn` is Levenberg-Marquardt on the stacked (T·D)
trajectory tangent. The Jacobian is one ``torch.func.jacfwd`` of the whole
stacked residual through ``state.retract`` (forward mode, one tangent
direction per column), as the reference takes one ``jax.jacfwd``. The loop
runs a fixed ``num_iters`` with accept/reject as ``torch.where`` selects
and the damped system solved by ``torch.linalg.solve_ex``, which reports a
failure in a tensor instead of raising: it makes no host sync. A failed
solve gives a NaN step, a NaN cost, and so a rejected step, as in the
reference.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from libwave_tpu_torch.geometry import se3, so3
from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.utils.precision import f32_matmuls

__all__ = ["motion_residual", "gps_residual", "hand_eye_residual",
           "decaying_bias_residual", "pose_prior_residual",
           "twist_prior_residual", "bias_prior_residual",
           "solve_trajectory_gn"]


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` (a number, array or tensor) as a tensor in ``ref``'s dtype on
    its device."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def _steps(state, i) -> SE3:
    pose = state.pose()
    return SE3(q=pose.q[i], t=pose.t[i])


# ---------------------------------------------------------------------------
# factor residuals (each returns a flat residual vector, already weighted)
# ---------------------------------------------------------------------------


def motion_residual(state, i, j, dt, sqrt_info=1.0):
    """Constant-velocity factor between steps i and j (vectorized over
    index tensors). The state has ``.pose()``/``.vel`` (and ``.bias`` if it
    carries one)."""
    P1, P2 = _steps(state, i), _steps(state, j)
    local = se3.boxminus(P2, P1)  # Local(pose1, pose2)
    dt_arr = _like(dt, state.vel)[..., None]
    parts = [state.vel[i] * dt_arr - local, state.vel[i] - state.vel[j]]
    if hasattr(state, "bias"):
        parts.append(state.bias[i] - state.bias[j])
    return (torch.cat(parts, dim=-1) * sqrt_info).reshape(-1)


def _lifted_bias(bias3):
    """Pose with identity rotation and the bias as translation."""
    q = so3.quat_identity(bias3.shape[:-1], bias3.dtype, bias3.device)
    return SE3(q=q, t=bias3)


def gps_residual(state, i, T_meas: SE3, sqrt_info=1.0):
    """GPS factor with additive translational bias at steps ``i``:
    r = Logmap(T_meas⁻¹ ∘ (LiftedBias(bias_i) ∘ pose_i))."""
    P = _steps(state, i)
    biased = _lifted_bias(state.bias[i]).compose(P)
    err = T_meas.inverse().compose(biased)
    return (se3.log(err) * sqrt_info).reshape(-1)


def hand_eye_residual(T_LOCAL_S2: SE3, T_S1_S2: SE3, bias3,
                      T_LOCAL_S1: SE3, sqrt_info=1.0):
    """Hand-eye calibration residual over explicit pose variables (not
    trajectory-indexed: calibration states)."""
    B = _lifted_bias(_like(bias3, T_LOCAL_S2.t))
    meas = T_LOCAL_S1.compose(B.compose(T_S1_S2))
    err = meas.inverse().compose(T_LOCAL_S2)
    return (se3.log(err) * sqrt_info).reshape(-1)


def decaying_bias_residual(state, i, j, dt, tau, sqrt_info=1.0):
    """r = B_j − B_i · exp(−dt/τ) (decaying_bias.cpp)."""
    decay = torch.exp(-_like(dt, state.bias) / tau)[..., None]
    return ((state.bias[j] - state.bias[i] * decay) * sqrt_info).reshape(-1)


def pose_prior_residual(state, i, prior: SE3, sqrt_info=1.0):
    return (se3.boxminus(_steps(state, i), prior) * sqrt_info).reshape(-1)


def twist_prior_residual(state, i, prior_vel, sqrt_info=1.0):
    return ((state.vel[i] - prior_vel) * sqrt_info).reshape(-1)


def bias_prior_residual(state, i, prior_bias, sqrt_info=1.0):
    return ((state.bias[i] - prior_bias) * sqrt_info).reshape(-1)


# ---------------------------------------------------------------------------
# trajectory LM solver
# ---------------------------------------------------------------------------


@f32_matmuls
def solve_trajectory_gn(
    state,
    residual_fns: Sequence[Callable],
    num_iters: int = 20,
    init_lambda: float = 1e-6,
    lambda_up: float = 10.0,
    lambda_down: float = 0.3,
):
    """Levenberg-Marquardt over a combined trajectory state, on the state's
    device.

    ``residual_fns``: callables state -> flat residual vector (already
    weighted by sqrt information). Linearization is ``torch.func.jacfwd``
    of the stacked residual through ``state.retract`` on the (T·D) tangent.

    Returns (state, info): ``info`` holds ``initial_cost``, ``final_cost``
    and ``costs`` (num_iters,), the cost after each iteration, as tensors
    on the device. No host sync.
    """
    T = state.q.shape[0]
    D = state.DIM
    n = T * D
    dtype, device = state.p.dtype, state.p.device

    def residuals_at(st):
        return torch.cat([torch.atleast_1d(f(st)) for f in residual_fns])

    def cost_of(st):
        r = residuals_at(st)
        return 0.5 * torch.sum(r * r)

    eye = torch.eye(n, dtype=dtype, device=device)
    zero = torch.zeros(n, dtype=dtype, device=device)

    def linearize(st):
        def f(dx):
            r = residuals_at(st.retract(dx.reshape(T, D)))
            return r, r

        J, r = torch.func.jacfwd(f, has_aux=True)(zero)
        return r, J

    cost0 = cost_of(state)
    cost = cost0
    lam = torch.full((), init_lambda, dtype=dtype, device=device)
    costs = []
    for _ in range(num_iters):
        r, J = linearize(state)
        H = J.T @ J
        g = J.T @ r
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-12 * eye
        dx = torch.linalg.solve_ex(Hd, -g)[0]
        new_state = state.retract(dx.reshape(T, D))
        new_cost = cost_of(new_state)
        accept = new_cost < cost
        state = type(state)(*(torch.where(accept, a, b)
                              for a, b in zip(new_state, state)))
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clip(
            torch.where(accept, lam * lambda_down, lam * lambda_up),
            1e-12, 1e8)
        costs.append(cost)
    costs = torch.stack(costs) if costs else cost0.new_zeros((0,))
    return state, {"initial_cost": cost0, "final_cost": cost, "costs": costs}
