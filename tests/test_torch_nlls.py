"""Parity of libwave_tpu_torch.optim.nlls with libwave_tpu's dense LM:
every case of tests/test_nlls.py's ``TestLMSolve`` and ``TestCurveFit`` on
the port, each held against the JAX package on the same inputs at f64:
the whole cost trace within rtol 1e-9 (atol 1e-20 of the initial cost, for
costs at rounding level) for autodiff, numeric and analytic Jacobians,
the final x within 1e-9, the accepted-step count and the converged flag
equal (on the curve fits the count within one: their last accepted step
decreases the cost at rounding level, where acceptance turns on the last
bits). A batch of problems under ``torch.func.vmap`` equals ``jax.vmap``'s
within rtol 1e-9; the ``done`` freeze leaves x, the cost and the count
where the JAX package leaves them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.optim import nlls as jn
from libwave_tpu_torch import bench_trajectory as bt
from libwave_tpu_torch.optim import nlls as tn


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def held(rt, rj, x_atol=1e-9, count_slack=0):
    floor = 1e-20 * max(float(np.max(np.asarray(rj.cost_trace))), 1.0)
    np.testing.assert_allclose(rt.cost_trace.numpy(), np.asarray(rj.cost_trace),
                               rtol=1e-9, atol=floor)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=x_atol)
    np.testing.assert_allclose(rt.cost.numpy(), np.asarray(rj.cost),
                               rtol=1e-9, atol=floor)
    assert np.abs(rt.iterations.numpy()
                  - np.asarray(rj.iterations)).max() <= count_slack
    assert np.array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    assert rt.iterations.dtype == torch.int32


def hello_j(x):
    return 10.0 - x


def hello_t(x):
    return 10.0 - x


def jac_j(x):
    return -jnp.ones((1, 1), x.dtype)


def jac_t(x):
    return -torch.ones((1, 1), dtype=x.dtype)


@pytest.mark.parametrize("kind", ["autodiff", "numeric", "analytic"])
def test_hello_world(kind):
    """ceres_examples.cpp's f(x) = 10 - x, three Jacobians."""
    jac = {"autodiff": (None, None),
           "numeric": (jn.numeric_jacobian(hello_j),
                       tn.numeric_jacobian(hello_t)),
           "analytic": (jac_j, jac_t)}[kind]
    rj = jn.lm_solve(hello_j, jnp.array([0.5]), jac=jac[0])
    rt = tn.lm_solve(hello_t, t64([0.5]), jac=jac[1])
    held(rt, rj)
    assert abs(float(rt.x[0]) - 10.0) < 1e-5
    # the freeze: converged early, x and the count stop moving
    assert bool(rt.converged) and int(rt.iterations) < 50


@pytest.mark.parametrize("kind", ["autodiff", "numeric", "analytic"])
def test_exponential_curve(kind):
    """tests/test_nlls.py's curve (68 points, default_rng(0)), each
    Jacobian kind, whole trace."""
    x, y = bt.curve_batch(1)
    y = y[0]

    def ana_j(p, x, y):
        e = jnp.exp(p[0] * x + p[1])
        return jnp.stack([-x * e, -e], axis=-1)

    def ana_t(p, x, y):
        e = torch.exp(p[0] * x + p[1])
        return torch.stack([-x * e, -e], dim=-1)

    jac = {"autodiff": (None, None),
           "numeric": (jn.numeric_jacobian(jn.exp_curve_residual),
                       tn.numeric_jacobian(tn.exp_curve_residual)),
           "analytic": (ana_j, ana_t)}[kind]
    cfg_j = jn.LMConfig(max_iterations=bt.CURVE_ITERS)
    cfg_t = tn.LMConfig(max_iterations=bt.CURVE_ITERS)
    rj = jn.lm_solve(jn.exp_curve_residual, jnp.zeros(2),
                     args=(jnp.asarray(x), jnp.asarray(y)), jac=jac[0],
                     config=cfg_j)
    rt = tn.lm_solve(tn.exp_curve_residual, torch.zeros(2, dtype=torch.float64),
                     args=(t64(x), t64(y)), jac=jac[1], config=cfg_t)
    # the last accepted step's decrease is at rounding level (1e-17 of a
    # cost of 0.011), so its acceptance may differ: one step
    held(rt, rj, count_slack=1)
    m, c = rt.x.numpy()
    assert abs(m - bt.CURVE_M) < bt.CURVE_BOUNDS[0]
    assert abs(c - bt.CURVE_C) < bt.CURVE_BOUNDS[1]


def test_rosenbrock_style_2d():
    rj = jn.lm_solve(lambda p: jnp.array([10.0 * (p[1] - p[0] ** 2),
                                          1.0 - p[0]]),
                     jnp.array([-1.2, 1.0]),
                     config=jn.LMConfig(max_iterations=200))
    rt = tn.lm_solve(lambda p: torch.stack([10.0 * (p[1] - p[0] ** 2),
                                            1.0 - p[0]]),
                     t64([-1.2, 1.0]), config=tn.LMConfig(max_iterations=200))
    held(rt, rj)
    np.testing.assert_allclose(rt.x.numpy(), [1.0, 1.0], atol=1e-4)


def test_curve_fit_wrapper():
    x = np.linspace(-1, 1, 32)
    y = 2.0 * x - 0.5
    rj = jn.curve_fit(lambda p, x: p[0] * x + p[1], x, y, jnp.array([0.0, 0.0]))
    rt = tn.curve_fit(lambda p, x: p[0] * x + p[1], x, y, t64([0.0, 0.0]))
    held(rt, rj)
    np.testing.assert_allclose(rt.x.numpy(), [2.0, -0.5], atol=1e-6)


def test_host_inputs_take_the_device_argument():
    """numpy p0, x and y go to ``device`` (here the CPU) and give the fit
    that tensors give; with ``device=None`` they go to the card, so without
    one they raise rather than run on the CPU."""
    x = np.linspace(-1, 1, 32)
    y = 2.0 * x - 0.5

    def line(p, x):
        return p[0] * x + p[1]

    rn = tn.curve_fit(line, x, y, np.zeros(2), device="cpu")
    rt = tn.curve_fit(line, t64(x), t64(y), t64([0.0, 0.0]))
    np.testing.assert_array_equal(rn.cost_trace.numpy(),
                                  rt.cost_trace.numpy())
    np.testing.assert_array_equal(rn.x.numpy(), rt.x.numpy())
    rl = tn.lm_solve(tn.exp_curve_residual, np.zeros(2), args=(x, y),
                     device="cpu")
    assert rl.x.dtype == torch.float64
    if torch.cuda.is_available():
        assert tn.curve_fit(line, x, y, np.zeros(2)).x.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tn.curve_fit(line, x, y, np.zeros(2))


def test_vmap_batch_matches_jax_vmap():
    """A batch of independent fits: torch.func.vmap against jax.vmap (the
    JAX test's jit-and-vmap case, and chip_smoke.py's nlls batch at 16)."""
    x, y = bt.curve_batch(16)
    cfg_j = jn.LMConfig(max_iterations=bt.CURVE_ITERS)
    cfg_t = tn.LMConfig(max_iterations=bt.CURVE_ITERS)
    rj = jax.jit(jax.vmap(lambda yy: jn.lm_solve(
        jn.exp_curve_residual, jnp.zeros(2), args=(jnp.asarray(x), yy),
        config=cfg_j)))(jnp.asarray(y))
    X = t64(x)
    rt = torch.func.vmap(lambda yy: tn.lm_solve(
        tn.exp_curve_residual, torch.zeros(2, dtype=torch.float64),
        args=(X, yy), config=cfg_t))(t64(y))
    assert rt.cost_trace.shape == (16, bt.CURVE_ITERS)
    held(rt, rj, count_slack=1)
    # each row equals its own unbatched solve
    one = tn.lm_solve(tn.exp_curve_residual,
                      torch.zeros(2, dtype=torch.float64),
                      args=(X, t64(y[5])), config=cfg_t)
    np.testing.assert_allclose(rt.x[5].numpy(), one.x.numpy(), atol=1e-9)


def test_hello_vmap_over_starts():
    """tests/test_nlls.py test_jit_and_vmap: four starts, one vmap."""
    starts = np.linspace(-3, 3, 4)[:, None]
    rj = jax.vmap(lambda v: jn.lm_solve(hello_j, v))(jnp.asarray(starts))
    rt = torch.func.vmap(lambda v: tn.lm_solve(hello_t, v))(t64(starts))
    held(rt, rj)
    np.testing.assert_allclose(rt.x.numpy(), 10.0, atol=1e-5)


def test_singular_system_rejects_step():
    """A residual with no dependence on x and lambda at its floor: the
    damped system is singular, the step NaN, its cost NaN, and the step is
    rejected in both packages (x stays, the count stays 0)."""
    cfg_j = jn.LMConfig(max_iterations=5, lambda_init=0.0)
    cfg_t = tn.LMConfig(max_iterations=5, lambda_init=0.0)
    rj = jn.lm_solve(lambda x: jnp.ones(3) + 0.0 * x[0], jnp.array([0.5, 2.0]),
                     config=cfg_j)
    rt = tn.lm_solve(lambda x: torch.ones(3, dtype=x.dtype) + 0.0 * x[0],
                     t64([0.5, 2.0]), config=cfg_t)
    held(rt, rj)
    assert int(rt.iterations) == 0
    np.testing.assert_array_equal(rt.x.numpy(), [0.5, 2.0])
