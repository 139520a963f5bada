"""``libwave_tpu_torch.optim.ba.ba_from_dataset`` against the JAX package's
on the reference test's dataset (``tests/test_ba.py``: 100 landmarks, 300
steps, fx = fy = 200, 10 Hz), at f64.

- The problem's arrays are the JAX package's for all four flag
  combinations at noise 0: observation bank, weights, gauge, K and the
  landmark layout exactly; the ground-truth poses and the between bank
  within 1e-12 (q_GC and the relative poses are products of two
  libraries' trigonometry).
- Both packages' solves of the same problems (the reference test's
  perturb-and-recover case and its noisy offline case, the noise drawn by
  the port's generator) follow the same trajectory at rtol 1e-6 with equal
  accept flags, as ``tests/test_torch_ba.py`` holds the solve, and the
  port's meet the reference's bounds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.optim import ba as jba
from libwave_tpu.sim import VoSimParams, generate_vo_dataset
from libwave_tpu_torch import interop
from libwave_tpu_torch.geometry import so3 as tso3
from libwave_tpu_torch.optim import ba as tba


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small tensor ops: one intra-op thread leaves the cores to the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def datasets():
    dj = generate_vo_dataset(
        VoSimParams(nb_landmarks=100, steps=300, fx=200.0, fy=200.0,
                    hz=10.0),
        jax.random.key(7),
    )
    return dj, interop.vo_dataset_from_jax_numpy(
        jax.tree.map(np.asarray, dj), device="cpu")


FLAGS = [dict(), dict(with_odometry=True), dict(with_priors=True),
         dict(with_odometry=True, with_priors=True)]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "+".join(f) or "vision")
def test_problem_arrays_match_jax_package(datasets, flags):
    dj, dt = datasets
    pj, gj = jba.ba_from_dataset(dj, **flags)
    pt, gt = tba.ba_from_dataset(dt, **flags, device="cpu")
    for f in ("pose_idx", "lm_idx", "uv", "weight", "free_pose", "K"):
        a, b = _np(getattr(pt, f)), _np(getattr(pj, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(gt.lm.numpy(), np.asarray(gj.lm))
    np.testing.assert_allclose(gt.p.numpy(), np.asarray(gj.p), rtol=0,
                               atol=0)
    np.testing.assert_allclose(gt.q.numpy(), np.asarray(gj.q), rtol=1e-12,
                               atol=1e-15)
    # the landmark layout: each landmark's real slots in the same order
    sigma_j = np.asarray(pj.ell.sigma)
    real = np.asarray(pj.weight)[sigma_j] > 0
    off = pt.ell.offsets.numpy()
    np.testing.assert_array_equal(pt.ell.sigma.numpy()[:off[-1]],
                                  sigma_j[real])
    np.testing.assert_array_equal((np.diff(off) > 0).astype(np.float64),
                                  np.asarray(pj.ell.has_obs))
    for bank in ("between", "priors"):
        bj, bt = getattr(pj, bank), getattr(pt, bank)
        assert (bj is None) == (bt is None)
        if bj is None:
            continue
        for f in bj._fields:
            a, b = _np(getattr(bt, f)), _np(getattr(bj, f))
            assert a.dtype == b.dtype and a.shape == b.shape, (bank, f)
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14,
                                       err_msg=f"{bank}.{f}")
    cut = tba.ba_from_dataset(dt, max_obs=500, device="cpu")[0]
    np.testing.assert_array_equal(
        cut.lm_idx.numpy(), np.asarray(jba.ba_from_dataset(dj, max_obs=500)[0]
                                       .lm_idx))


@functools.cache
def _jax_solver(iterations):
    return jax.jit(lambda p, s: jba.solve_ba(
        p, s, jba.BAConfig(max_iterations=iterations)))


def _solve_both(pt, st, cfg):
    """The port's solve of (pt, st) and the JAX package's of the same
    arrays."""
    pj = jba.BAProblem(
        K=jnp.asarray(pt.K.numpy()), pose_idx=jnp.asarray(pt.pose_idx.numpy()),
        lm_idx=jnp.asarray(pt.lm_idx.numpy()), uv=jnp.asarray(pt.uv.numpy()),
        weight=jnp.asarray(pt.weight.numpy()),
        free_pose=jnp.asarray(pt.free_pose.numpy()),
        between=None if pt.between is None else jba.pose_graph.BetweenBank(
            *(jnp.asarray(x.numpy()) for x in pt.between)),
        priors=None if pt.priors is None else jba.pose_graph.PriorBank(
            *(jnp.asarray(x.numpy()) for x in pt.priors)),
    )
    sj = jba.BAState(*(jnp.asarray(x.numpy()) for x in st))
    out_j, info_j = _jax_solver(cfg["max_iterations"])(pj, sj)
    out_t, info_t = tba.solve_ba(pt, st, tba.BAConfig(**cfg))
    np.testing.assert_allclose(info_t["costs"].numpy(),
                               np.asarray(info_j["costs"]), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(info_t["accepted"].numpy(),
                                  np.asarray(info_j["accepted"]))
    np.testing.assert_allclose(out_t.p.numpy(), np.asarray(out_j.p),
                               rtol=1e-6, atol=1e-9)
    return out_t, info_t


def _errors(out, gt):
    rot = tso3.rotation_distance(out.q, gt.q).max().item()
    pos = (out.p - gt.p).norm(dim=-1).max().item()
    return rot, pos, (out.lm - gt.lm).norm(dim=-1).numpy()


def test_perturb_and_recover_matches_jax_package(datasets):
    """The reference test's perturb-and-recover case (perturbation drawn
    with numpy): the reference's bounds, poses 0.01 rad and 0.1 m,
    observed landmarks 1 m."""
    _, dt = datasets
    pt, gt = tba.ba_from_dataset(dt, device="cpu")
    rng = np.random.default_rng(11)
    N, M = gt.q.shape[0], gt.lm.shape[0]
    free = pt.free_pose.numpy()[:, None]
    st = tba.BAState(
        q=tso3.quat_boxplus(gt.q, torch.as_tensor(
            0.05 * rng.normal(size=(N, 3)) * free)),
        p=gt.p + torch.as_tensor(0.10 * rng.normal(size=(N, 3)) * free),
        lm=gt.lm + torch.as_tensor(0.50 * rng.normal(size=(M, 3))),
    )
    out, info = _solve_both(pt, st, dict(max_iterations=25))
    assert float(info["final_cost"]) < 1e-6 * float(info["initial_cost"])
    rot, pos, lm = _errors(out, gt)
    observed = np.zeros(M, bool)
    observed[pt.lm_idx.numpy()[pt.weight.numpy() > 0]] = True
    assert rot < 0.01 and pos < 0.1 and lm[observed].max() < 1.0


def test_noisy_offline_example_matches_jax_package(datasets):
    """The reference test's gtsam offline example: 1.1 px noise, priors on
    the first two poses, landmarks offset by (-0.25, 0.20, 0.15). On the
    JAX package's own draw (``jax.random.key(3)``, the reference test's)
    the port's solve meets the reference's bounds: positions under 0.1 m,
    rotations under 0.05 rad, landmark error mean under 1.5 m and 85th
    percentile under 2 m. Those bounds belong to that draw: over keys 0-7
    the JAX package meets them on 3, the port's generator seeds 0-7 on 2
    (``tests/ba_noise_draws.py``). The port's own draw is held to the JAX
    package's solve of the same data."""
    dj, dt = datasets
    pj, _ = jba.ba_from_dataset(dj, noise_pixels=1.1, key=jax.random.key(3),
                                with_priors=True)
    clean, gt = tba.ba_from_dataset(dt, with_priors=True, device="cpu")
    st = gt._replace(lm=gt.lm + torch.tensor([-0.25, 0.20, 0.15],
                                             dtype=torch.float64))
    out, _ = _solve_both(clean._replace(uv=torch.as_tensor(np.array(pj.uv))),
                         st, dict(max_iterations=30))
    rot, pos, lm = _errors(out, gt)
    assert pos < 0.1 and rot < 0.05
    assert lm.mean() < 1.5 and np.quantile(lm, 0.85) < 2.0

    g = torch.Generator().manual_seed(3)
    pt, _ = tba.ba_from_dataset(dt, noise_pixels=1.1, generator=g,
                                with_priors=True, device="cpu")
    noise = (pt.uv - clean.uv)[pt.weight > 0]
    assert 0.9 < float(noise.std()) < 1.3 and pt.uv.dtype == torch.float64
    _solve_both(pt, st, dict(max_iterations=30))
