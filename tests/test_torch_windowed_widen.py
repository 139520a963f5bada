"""The stiff-chain widening: an f32 state with f64 pose-block sums, an f64
Cholesky and an f64 carried prior, the path ``run_euroc_vio_windowed``
takes above 3e4 of IMU whitening (20 Hz keyframes, as MH_01). The port at
``dtype=float32`` against the JAX package at the same precision (x64 off:
f32 arrays, the explicit f64 ones allowed), on the CPU.

The chain: 3 s at a 20 Hz camera and 200 Hz IMU, 100 landmarks, seed 0
(61 keyframes), written by the JAX package, at ``window=20, overlap=5`` (4
windows) with the default chunks. Tolerances and what they measured:

- both packages widen (``hessian_dtype == "float64"``) and carry an f64
  prior;
- port f32 against the JAX package's f32: window costs within rtol 1e-4
  (measured 2.4e-5), keyframe positions within 1 mm (2.6e-4 m), ATE within
  0.5 mm (8.7e-5 m); the final carried prior's Lambda within 1e-3 of
  max|Lambda| (3.0e-4) and b within 1e-2 of max|b| (7.9e-4). These are
  the scale of f32 rounding on this chain: the port's f64 chain is 5.6e-4 m
  and 3.9e-3 of max|b| from the JAX package's f32 one, and the port's f32
  chain run with 2 torch threads instead of 1 moved by ~3e-4 m;
- port f32 against port f64 (what the widening is for): window costs
  within rtol 1e-4 (measured 1.9e-5), positions within 1 mm (3.0e-4 m);
  without the widening (``hessian_dtype=None``) the f32 chain is 5.1e-3 m
  from the f64 one;
- ``_prior_cost`` and ``_prior_terms`` on an f32 state with an f64 prior
  of entries up to 1e9: f64 results equal to the f64 arithmetic on the
  state's f32 delta within 1e-12 relative, and to the JAX package's within
  1e-6 relative (the two packages' f32 deltas differ in the last bits).
"""

import types

import jax
import numpy as np
import pytest
import torch

from libwave_tpu.pipelines import vio as jvio
from libwave_tpu.pipelines import windowed_vio as jw
from libwave_tpu.pipelines.euroc_vio import EurocVIOParams as JParams
from libwave_tpu.sim import euroc_sim as jsim
from libwave_tpu_torch.pipelines import vio as tvio
from libwave_tpu_torch.pipelines import windowed_vio as tw
from libwave_tpu_torch.pipelines.euroc_vio import EurocVIOParams as TParams
from test_torch_windowed_vio import one_torch_thread  # noqa: F401

WIN = dict(window=20, overlap=5)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """The JAX package's and the port's f32 chains (checkpointed) and the
    port's f64 chain on the same sequence."""
    base = tmp_path_factory.mktemp("wvio_widen")
    root = str(base / "seq")
    jsim.generate_euroc_sequence(
        root, jsim.EurocSimParams(duration=3.0, cam_hz=20.0, imu_hz=200.0,
                                  nb_landmarks=100), seed=0)
    with jax.enable_x64(False):
        j = jw.run_euroc_vio_windowed(
            root, JParams(), jw.WindowedVIOParams(**WIN),
            checkpoint_dir=str(base / "jax"))
    t32 = tw.run_euroc_vio_windowed(
        root, TParams(), tw.WindowedVIOParams(**WIN),
        checkpoint_dir=str(base / "torch"), device="cpu",
        dtype=torch.float32)
    t64 = tw.run_euroc_vio_windowed(
        root, TParams(), tw.WindowedVIOParams(**WIN), device="cpu",
        dtype=torch.float64)
    return base, j, t32, t64


def test_both_packages_widen(chains):
    _, (ej, rj), (et, rt), _ = chains
    assert rj["hessian_dtype"] == rt["hessian_dtype"] == "float64"
    assert np.asarray(ej.poses.t).dtype == np.float32
    assert rt["num_windows"] == rj["num_windows"] == 4
    assert rt["completed"] and rt["marg_host_fallbacks"] == 0


def test_f32_chain_matches_reference(chains):
    _, (ej, rj), (et, rt), _ = chains
    np.testing.assert_allclose(rt["window_final_costs"],
                               rj["window_final_costs"], rtol=1e-4)
    np.testing.assert_allclose(et.poses.t.numpy(),
                               np.asarray(ej.poses.t, np.float64),
                               rtol=0, atol=1e-3)
    assert abs(rt["ate_rmse"] - rj["ate_rmse"]) < 5e-4


def test_f32_carried_prior_matches_reference(chains):
    base = chains[0]
    with np.load(base / "jax" / "windowed_vio.npz") as fj, \
            np.load(base / "torch" / "windowed_vio.npz") as ft:
        # leaves in sorted-key order: prior_Lambda (7), prior_b (8)
        for i in (7, 8):
            ref, got = fj[f"leaf_{i}"], ft[f"leaf_{i}"]
            assert ref.dtype == got.dtype == np.float64
            tol = {7: 1e-3, 8: 1e-2}[i]
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=tol * np.abs(ref).max())


def test_f32_chain_follows_f64(chains):
    _, _, (et, rt), (e64, r64) = chains
    assert r64["hessian_dtype"] == "float64"
    np.testing.assert_allclose(rt["window_final_costs"],
                               r64["window_final_costs"], rtol=1e-4)
    np.testing.assert_allclose(et.poses.t.numpy(), e64.poses.t.numpy(),
                               rtol=0, atol=1e-3)


def _prior_inputs(O=3, D=15, seed=0):
    """An f32 head state, f32 prior means and an f64 prior whose entries
    reach 1e9 (the stiff chain's IMU information), in numpy."""
    rng = np.random.default_rng(seed)

    def quats(n):
        q = rng.normal(size=(n, 4))
        return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(
            np.float32)

    q = quats(O)
    prior_q = quats(O)
    state = dict(q=q, **{k: rng.normal(size=(O, 3)).astype(np.float32)
                         for k in ("p", "v", "bg", "ba")})
    prior = {f"prior_{k}": (state[k] + 1e-3 * rng.normal(size=(O, 3))
                            ).astype(np.float32)
             for k in ("p", "v", "bg", "ba")}
    prior["prior_q"] = prior_q
    A = rng.normal(size=(O * D, O * D))
    scale = np.logspace(0, 4.5, O * D)
    prior["prior_Lambda"] = (A @ A.T + O * D * np.eye(O * D)) * np.outer(
        scale, scale)
    prior["prior_b"] = rng.normal(size=O * D) * scale ** 2
    return state, prior


def _port_prior(state, prior):
    st = types.SimpleNamespace(**{k: torch.from_numpy(v)
                                  for k, v in state.items()})
    pr = types.SimpleNamespace(**{k: torch.from_numpy(v)
                                  for k, v in prior.items()})
    return st, pr


def test_prior_cost_and_terms_take_the_prior_dtype():
    state, prior = _prior_inputs()
    st, pr = _port_prior(state, prior)
    cost = tvio._prior_cost(pr, st)
    diag, (C, ci, cj), g = tvio._prior_terms(pr, st)
    assert cost.dtype == g.dtype == diag.dtype == C.dtype == torch.float64
    # the f64 arithmetic on the state's f32 delta
    d = tvio._prior_delta(pr, st).numpy().astype(np.float64)
    Lam, b = prior["prior_Lambda"], prior["prior_b"]
    want_cost = 0.5 * d @ (Lam @ d) - b @ d
    want_g = -(Lam @ d) + b
    assert abs(cost.item() - want_cost) <= 1e-12 * abs(want_cost)
    np.testing.assert_allclose(g.numpy().reshape(-1), want_g, rtol=0,
                               atol=1e-12 * np.abs(want_g).max())
    with jax.enable_x64(False):
        jst = types.SimpleNamespace(**{k: jax.numpy.asarray(v)
                                       for k, v in state.items()})
        jpr = types.SimpleNamespace(
            **{k: jax.numpy.asarray(v, v.dtype) for k, v in prior.items()})
        jcost = np.asarray(jvio._prior_cost(jpr, jst))
        jdiag, (jC, jci, jcj), jg = (
            jax.tree.map(np.asarray, x) for x in jvio._prior_terms(jpr, jst))
    assert jcost.dtype == np.float64
    assert abs(cost.item() - float(jcost)) <= 1e-6 * abs(float(jcost))
    np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                               atol=1e-6 * np.abs(jg).max())
    np.testing.assert_array_equal(diag.numpy(), jdiag)
    np.testing.assert_array_equal(C.numpy(), jC)
    np.testing.assert_array_equal(ci.numpy(), jci)
    np.testing.assert_array_equal(cj.numpy(), jcj)
