"""Small-scale nonlinear least squares: dense Levenberg-Marquardt (port of
``libwave_tpu.optim.nlls``).

The reference's ``ceres_examples`` (wave_optimization/src/ceres/
ceres_examples.cpp:5-80): the tutorial residuals, ``f(x) = 10 - x`` by
autodiff, numeric and analytic Jacobians, and exponential curve fitting
``y = exp(m*x + c)``, generalized into a reusable dense LM solver. The
Jacobian is ``torch.func.jacfwd`` (autodiff, the default), central finite
differences (:func:`numeric_jacobian`), or a user-supplied analytic one.

The loop has a fixed trip count and a freeze on convergence as
``torch.where`` selects, and the damped normal equations are solved by
``torch.linalg.solve_ex``, which reports a singular system in a tensor: no
host sync. So :func:`lm_solve` runs under ``torch.func.vmap`` over a batch
of independent problems. It targets small parameter vectors (calibration,
curve fits); large structured problems use ``optim.ba`` and
``optim.factors``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from libwave_tpu_torch.utils.device import as_tensor
from libwave_tpu_torch.utils.precision import f32_matmuls

__all__ = ["LMConfig", "LMResult", "lm_solve", "curve_fit",
           "numeric_jacobian", "exp_curve_residual"]


@dataclass(frozen=True)
class LMConfig:
    """LM solver knobs (defaults mirror Ceres' tutorial-scale settings)."""

    max_iterations: int = 50
    lambda_init: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    gradient_tol: float = 1e-10
    step_tol: float = 1e-12


class LMResult(NamedTuple):
    x: torch.Tensor            # final parameters
    cost: torch.Tensor         # final 0.5*||r||^2
    iterations: torch.Tensor   # accepted-step count (int32)
    converged: torch.Tensor    # bool
    cost_trace: torch.Tensor   # (max_iterations,) cost after each sweep


def numeric_jacobian(residual_fn: Callable, eps: float = 1e-6) -> Callable:
    """Central-difference Jacobian of ``residual_fn`` w.r.t. its first
    argument (Ceres NumericDiffCostFunction, CENTRAL, as in
    ceres_examples.cpp ``NumericalDiffCostFunctor``): every coordinate's
    ±eps pair in one ``torch.func.vmap``."""

    def jac(x, *args):
        x = torch.as_tensor(x)
        eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device) * eps

        def col(dx):
            return (residual_fn(x + dx, *args)
                    - residual_fn(x - dx, *args)) / (2.0 * eps)

        return torch.func.vmap(col)(eye).T  # (n_res, n_params)

    return jac


@f32_matmuls
def lm_solve(
    residual_fn: Callable,
    x0,
    args: tuple = (),
    jac: Optional[Callable] = None,
    config: LMConfig = LMConfig(),
    device=None,
) -> LMResult:
    """Dense Levenberg-Marquardt: minimize 0.5*||residual_fn(x, *args)||^2.

    A tensor ``x0`` stays on its device unless ``device`` names one; a list
    or numpy ``x0`` goes to ``utils.device.resolve(device)``, the card
    unless the caller asks for the CPU. Numpy arrays in ``args`` follow
    ``x0``. ``jac(x, *args) -> (n_res, n_params)`` may be analytic (the
    reference's ``AnalyticalCostFunction``), :func:`numeric_jacobian`'s,
    or None for ``torch.func.jacfwd`` (``AutoDiffCostFunction``).
    """
    x0 = torch.atleast_1d(as_tensor(x0, device))
    args = tuple(torch.as_tensor(a, device=x0.device)
                 if isinstance(a, np.ndarray) else a for a in args)
    if jac is None:
        jac = torch.func.jacfwd(residual_fn, argnums=0)

    def cost_of(x):
        r = residual_fn(x, *args)
        return 0.5 * torch.sum(r * r)

    n = x0.shape[0]
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)

    x = x0
    lam = torch.full((), config.lambda_init, dtype=x0.dtype, device=x0.device)
    cost = cost_of(x0)
    iters = torch.zeros((), dtype=torch.int32, device=x0.device)
    done = torch.zeros((), dtype=torch.bool, device=x0.device)
    trace = []
    for _ in range(config.max_iterations):
        r = residual_fn(x, *args)
        J = torch.atleast_2d(jac(x, *args))
        g = J.T @ r
        H = J.T @ J
        dx = -torch.linalg.solve_ex(H + lam * eye, g)[0]
        x_new = x + dx
        cost_new = cost_of(x_new)
        accept = cost_new < cost
        take = accept & ~done
        x = torch.where(take, x_new, x)
        cost = torch.where(take, cost_new, cost)
        lam = torch.where(accept, lam * config.lambda_down,
                          lam * config.lambda_up)
        lam = torch.clip(lam, 1e-12, 1e12)
        converged = (torch.max(torch.abs(g)) < config.gradient_tol) | (
            torch.linalg.vector_norm(dx) < config.step_tol
        )
        iters = iters + take.to(torch.int32)
        done = done | converged
        trace.append(cost)
    return LMResult(x=x, cost=cost, iterations=iters, converged=done,
                    cost_trace=torch.stack(trace))


def exp_curve_residual(params, x, y):
    """Residuals of the Ceres curve-fitting tutorial model
    ``y = exp(m*x+c)`` (ceres_examples.cpp ExponentialResidual)."""
    m, c = params[0], params[1]
    return y - torch.exp(m * x + c)


def curve_fit(
    model: Callable,
    x,
    y,
    p0,
    jac: Optional[Callable] = None,
    config: LMConfig = LMConfig(max_iterations=100),
    device=None,
) -> LMResult:
    """Fit ``model(params, x) ~= y`` by LM (the runCurveFitting example,
    ceres_examples.cpp). ``model`` is vectorized over x. ``p0`` takes its
    device as :func:`lm_solve`'s ``x0`` does; x and y go to it."""

    def residual(params, x, y):
        return y - model(params, x)

    p0 = as_tensor(p0, device)
    x, y = (torch.as_tensor(a, device=p0.device) for a in (x, y))
    return lm_solve(residual, p0, args=(x, y), jac=jac, config=config)
