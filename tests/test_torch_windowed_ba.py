"""Windowed bundle adjustment (``pipelines.windowed_ba``): the port
against the JAX package on the CPU at f64.

One problem made in numpy from seeds (``bench_problem.windowed_ba_circle``
at 400 steps: 36 frames, 60 landmarks, 1 px of pixel noise, noisy odometry
between-factors, priors on the first two poses, an offset init), carried to
each package as the same arrays; ``window=15, overlap=4`` (3 windows) with
10 LM iterations a window. The port runs explicit-S PCG on the CPU
(``explicit_s="always"``, the path its "auto" takes on the card), the JAX
package its own "auto" choice: the same operator, so window costs agree
within rtol 1e-9 and poses within 1e-8 (measured ~1e-12 and ~1e-10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.optim import BAConfig as JConfig
from libwave_tpu.optim import BetweenBank as JBetween
from libwave_tpu.optim import PriorBank as JPrior
from libwave_tpu.pipelines import windowed_ba as jwb
from libwave_tpu_torch import bench_problem
from libwave_tpu_torch.optim import BAConfig as TConfig
from libwave_tpu_torch.optim import BetweenBank as TBetween
from libwave_tpu_torch.optim import PriorBank as TPrior
from libwave_tpu_torch.pipelines import windowed_ba as twb
from libwave_tpu_torch.sim import VoSimParams
from test_torch_windowed_vio import one_torch_thread  # noqa: F401

CFG = dict(max_iterations=10, cg_max_iters=150, huber_delta=3.0)


@pytest.fixture(scope="module")
def case():
    return bench_problem.windowed_ba_circle(VoSimParams(
        nb_landmarks=60, steps=400, fx=200.0, fy=200.0, hz=10.0))


def _port(c, **kw):
    return twb.solve_ba_windowed(
        c["K"], c["tracks"], c["num_frames"], c["q_init"], c["p_init"],
        between=TBetween(**{k: torch.as_tensor(v)
                            for k, v in c["between"].items()}),
        priors=TPrior(**{k: torch.as_tensor(v)
                         for k, v in c["priors"].items()}),
        device="cpu", dtype=torch.float64, **kw)


def test_windowed_ba_matches_reference(case):
    c = case
    wp = dict(window=15, overlap=4)
    qj, pj, rj = jwb.solve_ba_windowed(
        c["K"], c["tracks"], c["num_frames"], c["q_init"], c["p_init"],
        between=JBetween(**{k: jnp.asarray(v)
                            for k, v in c["between"].items()}),
        priors=JPrior(**{k: jnp.asarray(v) for k, v in c["priors"].items()}),
        wparams=jwb.WindowedBAParams(**wp), cfg=JConfig(**CFG))
    qt, pt, rt = _port(c, wparams=twb.WindowedBAParams(**wp),
                       cfg=TConfig(**CFG, explicit_s="always"))
    assert rt["num_windows"] == rj["num_windows"] == 3
    for k in rj:
        if k not in ("window_final_costs", "solve_seconds",
                     "marginalization_seconds"):
            assert rt[k] == rj[k], k
    np.testing.assert_allclose(rt["window_final_costs"],
                               rj["window_final_costs"], rtol=1e-9)
    np.testing.assert_allclose(qt, np.asarray(qj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(pt, np.asarray(pj), rtol=0, atol=1e-8)
    assert rt["window_iterations"] == [10, 10, 10]
    assert np.linalg.norm(pt - c["p_gt"], axis=-1).max() < 0.1


def test_explicit_s_and_matrix_free_agree(case):
    """The CPU's own "auto" (matrix-free PCG) against explicit S: the same
    operator in another summation order, 150 CG steps each, so the
    trajectories part by the CG residual only (positions within 1e-6 m;
    measured ~1e-10)."""
    wp = twb.WindowedBAParams(window=15, overlap=4)
    _, p_mf, r_mf = _port(case, wparams=wp, cfg=TConfig(**CFG))
    _, p_ex, r_ex = _port(case, wparams=wp,
                          cfg=TConfig(**CFG, explicit_s="always"))
    np.testing.assert_allclose(p_mf, p_ex, rtol=0, atol=1e-6)
    np.testing.assert_allclose(r_mf["window_final_costs"],
                               r_ex["window_final_costs"], rtol=1e-6)


def test_freeze_mode_without_priors(case):
    """The ablation without priors: window 0 pins its first two poses at
    the init (the hard gauge), later windows pin their heads at the
    previous window's estimates; costs stay finite."""
    wp = twb.WindowedBAParams(window=15, overlap=4, mode="freeze")
    c = case
    q, p, rep = twb.solve_ba_windowed(
        c["K"], c["tracks"], c["num_frames"], c["q_init"], c["p_init"],
        between=TBetween(**{k: torch.as_tensor(v)
                            for k, v in c["between"].items()}),
        wparams=wp, cfg=TConfig(**CFG, explicit_s="always"),
        device="cpu", dtype=torch.float64)
    assert rep["mode"] == "freeze" and rep["num_windows"] == 3
    assert np.isfinite(rep["window_final_costs"]).all()
    np.testing.assert_array_equal(p[:2], c["p_init"][:2])
    np.testing.assert_array_equal(q[:2], c["q_init"][:2])
