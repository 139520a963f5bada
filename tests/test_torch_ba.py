"""Parity of libwave_tpu_torch.optim.ba (the LM back end) with libwave_tpu's.

The reference's synthetic dataset (test_ba.py:38-52, 100 landmarks) is
built by the JAX package, perturbed with numpy from a seed, and carried
across with ``interop.from_jax_numpy``. Both packages then run the whole
solve and the per-iteration accepted-cost trajectories are compared at
f64 with rtol 1e-6 (measured agreement is about 1e-9; the Krylov steps
amplify summation-order differences of the two frameworks).

The headline problem generator without JAX (``bench_problem``) must give
arrays and band plans bit-identical to ``bench.make_problem``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from libwave_tpu.geometry import so3 as jso3
from libwave_tpu.optim import ba as jba
from libwave_tpu.sim import VoSimParams, generate_vo_dataset
from libwave_tpu_torch import bench_problem, interop
from libwave_tpu_torch.optim import ba as tba
from libwave_tpu_torch.optim import schur as ts


@pytest.fixture(scope="module")
def dataset():
    return generate_vo_dataset(
        VoSimParams(nb_landmarks=100, steps=300, fx=200.0, fy=200.0,
                    hz=10.0),
        jax.random.key(7),
    )


def _perturbed(problem, gt, seed=2):
    """The reference test's perturbation (test_ba.py:363-374), drawn with
    numpy."""
    rng = np.random.default_rng(seed)
    n, m = gt.q.shape[0], gt.lm.shape[0]
    free = np.asarray(problem.free_pose)[:, None]
    return jba.BAState(
        q=jso3.quat_boxplus(gt.q, jnp.asarray(
            0.03 * rng.normal(size=(n, 3)) * free)),
        p=gt.p + 0.05 * rng.normal(size=(n, 3)) * free,
        lm=gt.lm + 0.3 * rng.normal(size=(m, 3)),
    )


def _port(problem, state, dtype=None):
    pn, sn = jax.tree.map(np.asarray, (problem, state))
    return interop.from_jax_numpy(pn, sn, "cpu", dtype)


BASE = dict(max_iterations=6, cg_max_iters=25, cg_tol=1e-10)
MODES = {
    "matrix_free": dict(explicit_s="never"),
    "explicit_s": dict(explicit_s="always"),
    "dense": dict(solver="dense"),
    "huber": dict(explicit_s="never", huber_delta=0.5),
}
FACTORS = {
    "vision": dict(),
    # odometry between-factors plus first-two-pose priors (soft gauge)
    "pose_graph": dict(with_odometry=True, with_priors=True),
}
CASES = [(m, f) for m in ("matrix_free", "explicit_s", "dense")
         for f in sorted(FACTORS)] + [("huber", "vision")]


@pytest.mark.parametrize("mode,factors", CASES)
def test_solve_trajectory_matches_reference(mode, factors, dataset):
    problem, gt = jba.ba_from_dataset(dataset, **FACTORS[factors])
    init = _perturbed(problem, gt)
    _, info_j = jba.solve_ba(problem, init,
                             jba.BAConfig(**BASE, **MODES[mode]))
    pt, st = _port(problem, init)
    state_t, info_t = tba.solve_ba(pt, st, tba.BAConfig(**BASE, **MODES[mode]))
    costs_j = np.asarray(info_j["costs"])
    np.testing.assert_allclose(float(info_t["initial_cost"]),
                               float(info_j["initial_cost"]), rtol=1e-10)
    np.testing.assert_allclose(info_t["costs"].numpy(), costs_j, rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(info_t["accepted"].numpy(),
                                  np.asarray(info_j["accepted"]))
    np.testing.assert_array_equal(info_t["cg_iterations"].numpy(),
                                  np.asarray(info_j["cg_iterations"]))
    assert costs_j[-1] < 1e-3 * float(info_j["initial_cost"])
    assert state_t.q.dtype == torch.float64


def test_gauge_poses_fixed_and_zero_cost(dataset):
    problem, gt = jba.ba_from_dataset(dataset)
    pt, st = _port(problem, gt)
    assert float(tba.ba_cost(pt, st)) < 1e-12
    shifted = st._replace(p=st.p + 0.01)
    out, _ = tba.solve_ba(pt, shifted, tba.BAConfig(max_iterations=2))
    np.testing.assert_allclose(out.p[:2].numpy(), shifted.p[:2].numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(out.q[:2].numpy(), st.q[:2].numpy(),
                               atol=1e-12)


def test_marginal_prior_and_reduced_hessian(dataset):
    """Dense head prior (prior_Lambda/b/q/p) in the cost and the normal
    equations, and the undamped reduced Hessian, against the reference."""
    problem, gt = jba.ba_from_dataset(dataset, with_odometry=True)
    rng = np.random.default_rng(5)
    O = 3
    B = rng.normal(size=(O * 6, O * 6))
    problem = problem._replace(
        prior_Lambda=jnp.asarray(B @ B.T + np.eye(O * 6)),
        prior_b=jnp.asarray(rng.normal(size=O * 6)),
        prior_q=gt.q[:O], prior_p=gt.p[:O] + 0.01,
    )
    init = _perturbed(problem, gt, seed=3)
    pt, st = _port(problem, init)
    np.testing.assert_allclose(float(tba.ba_cost(pt, st, 2.0)),
                               float(jba.ba_cost(problem, init, 2.0)),
                               rtol=1e-10)
    bj = jax.jit(lambda p, s: jba._linearize_ba(p, s, 1e-3, 2.0))(
        problem, init)
    bt = tba._linearize_ba(pt, st, torch.tensor(1e-3, dtype=torch.float64),
                           2.0)
    for f in ("Hpp", "bp", "C", "ci", "cj", "Hll_inv", "bl", "W"):
        ref = np.asarray(getattr(bj, f))
        np.testing.assert_allclose(getattr(bt, f).numpy(), ref, rtol=1e-10,
                                   atol=1e-12 * max(np.abs(ref).max(), 1.0))
    Hj, rj = jax.jit(jba.ba_reduced_hessian)(problem, init)
    Ht, rt = tba.ba_reduced_hessian(pt, st)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(Hj)).max())
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(rj)).max())


def test_config_and_gates():
    with pytest.raises(ValueError, match="bf16"):
        tba.BAConfig(s_op_dtype="bf16").validate()
    with pytest.raises(ValueError, match="bf16"):
        tba.solve_ba(None, None, tba.BAConfig(s_op_dtype="bf16"))
    assert tba.BAConfig() == tba.BAConfig(
        **{f.name: getattr(jba.BAConfig(), f.name)
           for f in dataclasses.fields(jba.BAConfig)}
    )
    ell, cuda, cpu = object(), torch.device("cuda"), torch.device("cpu")
    auto = tba.BAConfig()
    # "auto" is explicit-S on CUDA and matrix-free on CPU
    assert tba._use_explicit_s(auto, 200, 6, 10_000, 4, ell, None,
                               device=cuda)
    assert not tba._use_explicit_s(auto, 200, 6, 10_000, 4, ell, None,
                                   device=cpu)
    always = tba.BAConfig(explicit_s="always")
    assert tba._use_explicit_s(always, 200, 6, 10_000, 4, ell, None,
                               device=cpu)
    assert not tba._use_explicit_s(always, 200, 6, 10_000, 4, None, None)
    assert not tba._use_explicit_s(always, 200, 6, 10_000, 4, ell, "dp")
    assert not tba._use_explicit_s(
        tba.BAConfig(explicit_s="always", explicit_max_s_bytes=1e3),
        200, 6, 10_000, 4, ell, None)
    assert not tba._use_explicit_s(auto, 400, 6, 100_000, 4, ell, None,
                                   device=cuda)
    assert tba._use_explicit_s(auto, 400, 6, 100_000, 4, ell, None,
                               bands=object(), device=cuda)
    assert not tba._use_dense_schur(auto, 200, 6, 6, 120, 4, None)
    dense_auto = tba.BAConfig(solver="auto")
    assert tba._use_dense_schur(dense_auto, 200, 6, 6, 120, 4, None)
    assert not tba._use_dense_schur(dense_auto, 200, 6, 6, 10_000, 4, None)
    with pytest.raises(ValueError, match="dense"):
        tba._use_dense_schur(tba.BAConfig(solver="dense",
                                          dense_max_pose_dim=4),
                             200, 6, 6, 10, 4, None)


SMALL = dict(num_poses=20, num_landmarks=500, obs_per_pose=40)


@pytest.fixture(scope="module")
def small_problems():
    return bench.make_problem(**SMALL), bench_problem.make_problem(**SMALL)


def test_bench_problem_bit_identical(small_problems):
    (pj, sj), (pt, st) = small_problems
    for name in ("K", "pose_idx", "lm_idx", "uv", "weight", "free_pose"):
        a, b = np.asarray(getattr(pj, name)), getattr(pt, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for a, b in zip(pj.ell, pt.ell):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())
    for a, b in zip(sj, st):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())
    assert pt.bands.entries == pj.bands.entries
    full = bench_problem.make_problem(num_poses=30, num_landmarks=2000,
                                      obs_per_pose=60)[0]
    ref = bench.make_problem(num_poses=30, num_landmarks=2000,
                             obs_per_pose=60)[0]
    assert full.bands.entries == ref.bands.entries
    assert len(full.bands.entries) > 1


def test_bench_config_solve(small_problems):
    """The benchmark's 3-iteration f32 solve against the reference's.

    The first LM iteration agrees within rtol 1e-3. Later iterations are
    compared at f64 (rtol 1e-6) and only bounded at f32: on this problem
    the 20 f32 CG steps stop at a residual of ~54 and the reduced rhs
    carries ~1e-4 relative f32 cancellation noise, so two f32
    implementations that differ only in summation order land 10-20% apart
    by the second iteration (measured 2.26e+0, 5.10e-3, 1.57e-3 here
    against 2.26e+0, 5.83e-3, 1.72e-3 for the reference, whose own f64
    trajectory is 2.27e+0, 6.24e-3, 1.83e-3).
    """
    (pj, sj), (pt, st) = small_problems
    cfg_t = bench_problem.bench_config(3)
    cfg_j = jba.BAConfig(**{f.name: getattr(cfg_t, f.name)
                            for f in dataclasses.fields(cfg_t)})
    _, info_j = jba.solve_ba(pj, sj, cfg_j)
    _, info_t = tba.solve_ba(pt, st, cfg_t)
    cj, ct = np.asarray(info_j["costs"]), info_t["costs"].numpy()
    assert ct.dtype == np.float32
    np.testing.assert_allclose(ct[0], cj[0], rtol=1e-3)
    assert np.all(np.diff(ct) < 0) and np.all(np.diff(cj) < 0)
    np.testing.assert_allclose(ct, cj, rtol=0.25)

    cast = lambda x: (x.astype(jnp.float64)
                      if jnp.issubdtype(x.dtype, jnp.floating) else x)
    pj64, sj64 = jax.tree.map(cast, (pj, sj))
    _, info_j64 = jba.solve_ba(pj64, sj64, cfg_j)
    pt64, st64 = _port(pj64, sj64)
    _, info_t64 = tba.solve_ba(pt64, st64, cfg_t)
    np.testing.assert_allclose(info_t64["costs"].numpy(),
                               np.asarray(info_j64["costs"]), rtol=1e-6)


def test_bench_backend_reports_rate_and_cost(small_problems):
    _, (pt, st) = small_problems
    rate, cost = bench_problem.bench_backend(pt, st, iters=2, repeats=1)
    assert rate > 0 and np.isfinite(cost)
    assert isinstance(cost, float)
    # the problem's bank is pose-ELL and carries a band plan
    assert isinstance(pt.ell, ts.EllLayout) and pt.bands is not None
