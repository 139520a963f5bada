"""The port's ``solve_vio`` against the JAX package's at f64: the LM cost
trajectory (accepted cost per iteration), the acceptance flags and the CG
iteration counts on a noise-free synthetic problem (30 landmarks from a
seeded numpy generator, 100 steps, 10 Hz keyframes) from a perturbed
start, for the dense solver (``solver="auto"`` at this size) and the
matrix-free PCG solver. Both packages solve the port's ``vio_from_sim``
problem, carried into the JAX package's containers here (its own
``vio_from_sim`` gives the same problem to 1e-9, tests/test_torch_vio.py).
Costs agree to rtol 1e-9 (measured about 1e-11: the reduce sums in slot
order, the JAX package with a log-shift scan), the final states to 1e-7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.geometry import so3 as jso3
from libwave_tpu.optim import imu as jimu
from libwave_tpu.optim import schur as js
from libwave_tpu.pipelines import vio as jv
from libwave_tpu_torch.pipelines import vio as tv
from libwave_tpu_torch.sim import vo_dataset as tvo

PARAMS = dict(nb_landmarks=30, steps=100, hz=10.0, fx=200.0, fy=200.0)


def _to_jax(pt):
    """The port's VIOProblem as the JAX package's (f64 numpy leaves)."""
    kw = {}
    for f in tv.VIOProblem._fields:
        v = getattr(pt, f)
        if f == "pim":
            v = jimu.PreintegratedImu(*(jnp.asarray(x.numpy()) for x in v))
        elif f == "ell":
            v = js.build_ell_layout(pt.lm_idx.numpy(), PARAMS["nb_landmarks"])
        elif isinstance(v, torch.Tensor):
            v = jnp.asarray(v.numpy())
        kw[f] = v
    return jv.VIOProblem(**kw)


@pytest.fixture(scope="module")
def problems():
    ds = tvo.generate_vo_dataset(tvo.VoSimParams(**PARAMS), seed=2,
                                 device="cpu")
    pt, gt = tv.vio_from_sim(ds, device="cpu")
    rng = np.random.default_rng(3)
    N, M = gt.q.shape[0], gt.lm.shape[0]
    gj = jv.VIOState(*(jnp.asarray(x.numpy()) for x in gt))
    init_j = jv.VIOState(
        q=jso3.quat_boxplus(gj.q, jnp.asarray(0.01 * rng.normal(size=(N, 3)))),
        p=gj.p + 0.03 * rng.normal(size=(N, 3)), v=gj.v, bg=gj.bg,
        ba=gj.ba, lm=gj.lm + 0.2 * rng.normal(size=(M, 3)),
    )
    st = tv.VIOState(*(torch.as_tensor(np.array(x)) for x in init_j))
    return _to_jax(pt), init_j, pt, st


@pytest.mark.parametrize("solver", ["auto", "pcg"])
def test_solve_vio_trajectory(solver, problems):
    pj, init_j, pt, st = problems
    kw = dict(max_iterations=3, cg_max_iters=30, solver=solver)
    sj, ij = jax.jit(lambda p, s: jv.solve_vio(p, s, jv.VIOConfig(**kw)))(
        pj, init_j)
    s_t, it = tv.solve_vio(pt, st, tv.VIOConfig(**kw))
    np.testing.assert_allclose(it["costs"].numpy(), np.asarray(ij["costs"]),
                               rtol=1e-9)
    np.testing.assert_array_equal(it["accepted"].numpy(),
                                  np.asarray(ij["accepted"]))
    np.testing.assert_array_equal(it["cg_iterations"].numpy(),
                                  np.asarray(ij["cg_iterations"]))
    assert float(it["initial_cost"]) == pytest.approx(
        float(ij["initial_cost"]), rel=1e-12)
    assert float(it["final_cost"]) < float(it["initial_cost"])
    for a, b in zip(s_t, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7,
                                   atol=1e-7)


def test_lam0_chunks_and_sharding_not_ported(problems):
    _, _, pt, st = problems
    cfg = tv.VIOConfig(max_iterations=2, cg_max_iters=20)
    s1, i1 = tv.solve_vio(pt, st, cfg)
    s2, i2 = tv.solve_vio(pt, s1, cfg, lam0=i1["final_lambda"])
    full, i4 = tv.solve_vio(pt, st, tv.VIOConfig(max_iterations=4,
                                                 cg_max_iters=20))
    np.testing.assert_allclose(
        np.concatenate([i1["costs"].numpy(), i2["costs"].numpy()]),
        i4["costs"].numpy(), rtol=1e-12)
    # the sharded path (a stub that raised before the distributed layer
    # was ported) on a one-rank axis: the single-device solve
    from libwave_tpu_torch.parallel.mesh import Axis

    _, i1s = tv.solve_vio(pt, st, tv.VIOConfig(
        max_iterations=2, cg_max_iters=20, solver="pcg"))
    _, i1a = tv.solve_vio(pt, st, tv.VIOConfig(
        max_iterations=2, cg_max_iters=20, solver="pcg"),
        axis_name=Axis("dp", 1, 0))
    assert torch.equal(i1a["costs"], i1s["costs"])
