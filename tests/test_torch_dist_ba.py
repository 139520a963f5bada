"""The port's distributed BA (``libwave_tpu_torch.parallel.dist_ba``)
against the JAX package's on the CPU.

The JAX side runs on a 2-device sub-mesh of the conftest's 8 virtual CPU
devices; the port's on 2 gloo processes (``tests/torch_dist_worker.py``,
one run per module, read by every case). Same problem (the JAX package's
``ba_from_dataset`` with odometry, priors and Huber, f64), same
partitions: the sharded solves agree to 1e-9 (the two packages sum the
landmark runs in other orders; nothing else differs); the one-step
distributed LM iteration equals a local iteration to rtol 1e-7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.geometry import so3 as so3_jax
from libwave_tpu.optim import BAConfig as JBAConfig
from libwave_tpu.optim import BAState as JBAState
from libwave_tpu.optim import ba_from_dataset
from libwave_tpu.optim.ba import _lm_iteration as j_lm_iteration
from libwave_tpu.optim.ba import ba_cost as j_ba_cost
from libwave_tpu import parallel as jpar
from libwave_tpu.sim import VoSimParams, generate_vo_dataset
from libwave_tpu_torch import interop
from libwave_tpu_torch.optim import ba
from libwave_tpu_torch.parallel import (
    MeshConfig,
    make_mesh,
    partition_ba_problem,
    solve_ba_sharded,
)
from torch_dist_run import run_ranks

CPU = torch.device("cpu")
ITERS, CG, HUBER = 6, 50, 2.0


@pytest.fixture(scope="module")
def problem():
    ds = generate_vo_dataset(
        VoSimParams(nb_landmarks=40, steps=120, fx=200.0, fy=200.0,
                    hz=10.0), jax.random.key(11))
    jp, gt = ba_from_dataset(ds, with_odometry=True, with_priors=True)
    rng = np.random.default_rng(13)
    N, M = gt.q.shape[0], gt.lm.shape[0]
    init = JBAState(
        q=so3_jax.quat_boxplus(gt.q, jnp.asarray(
            0.02 * rng.standard_normal((N, 3)))),
        p=gt.p + 0.05 * rng.standard_normal((N, 3)),
        lm=gt.lm + 0.3 * rng.standard_normal((M, 3)),
    )
    jp = jax.tree.map(np.asarray, jp)
    init = jax.tree.map(np.asarray, init)
    return jp, init


def _inputs(jp, init):
    z = dict(K=jp.K, pose_idx=jp.pose_idx, lm_idx=jp.lm_idx, uv=jp.uv,
             weight=jp.weight, free_pose=jp.free_pose, q=init.q, p=init.p,
             lm=init.lm, iters=ITERS, cg=CG, huber=HUBER)
    for bank in ("between", "priors"):
        b = getattr(jp, bank)
        z.update({f"{bank}_{f}": getattr(b, f) for f in b._fields})
    return z


def _jcfg():
    return JBAConfig(max_iterations=ITERS, cg_max_iters=CG,
                     huber_delta=HUBER, solver="pcg")


@pytest.fixture(scope="module")
def ranks(problem, tmp_path_factory):
    jp, init = problem
    return run_ranks("ba", 2, tmp_path_factory.mktemp("dist_ba"),
                     _inputs(jp, init))


@pytest.fixture(scope="module")
def jax_sharded(problem):
    jp, init = problem
    mesh = jpar.make_mesh(jpar.MeshConfig(dp=2), devices=jax.devices()[:2])
    stacked, padded = jpar.partition_ba_problem(jp, init, 2)
    state, info = jpar.solve_ba_sharded(stacked, padded, mesh, _jcfg())
    return (jax.tree.map(np.asarray, (stacked, padded)),
            jax.tree.map(np.asarray, (state, info)))


def test_partition_matches_jax(problem, jax_sharded):
    jp, init = problem
    (jst, jpad), _ = jax_sharded
    tp, ts = interop.from_jax_numpy(jp, init, CPU)
    st, pad = partition_ba_problem(tp, ts, 2)
    for f in ("pose_idx", "lm_idx", "weight", "uv", "free_pose"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    for f in ("q", "p", "lm"):
        np.testing.assert_array_equal(getattr(pad, f).numpy(),
                                      getattr(jpad, f), err_msg=f)
    # the port's own layout of each block lists exactly its real slots
    for b in range(2):
        sig, off = st.ell.sigma[b].numpy(), st.ell.offsets[b].numpy()
        real = np.flatnonzero(jst.weight[b] > 0)
        np.testing.assert_array_equal(np.sort(sig[:off[-1]]), real)
        np.testing.assert_array_equal(jst.lm_idx[b][sig[:off[-1]]],
                                      np.repeat(np.arange(len(off) - 1),
                                                np.diff(off)))
    # the JAX partition carried across by interop is the port's partition
    cst, cpad = interop.stacked_ba_from_jax_numpy(jst, jpad, CPU)
    for a, b in zip(cst.ell, st.ell):
        assert torch.equal(a, b)


def test_sharded_solve_matches_jax(ranks, jax_sharded):
    _, (jstate, jinfo) = jax_sharded
    r = ranks[0]
    np.testing.assert_allclose(r["costs"], jinfo["costs"], rtol=1e-9)
    np.testing.assert_allclose(r["initial_cost"], jinfo["initial_cost"],
                               rtol=1e-9)
    for f in ("q", "p", "lm"):
        np.testing.assert_allclose(r[f], getattr(jstate, f), rtol=0,
                                   atol=1e-9, err_msg=f)
    assert r["costs"][-1] < r["initial_cost"]


def test_ranks_end_bit_identical(ranks):
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_sharded_solve_matches_single_device(problem, ranks):
    jp, init = problem
    tp, ts = interop.from_jax_numpy(jp, init, CPU)
    cfg = ba.BAConfig(max_iterations=ITERS, cg_max_iters=CG,
                      huber_delta=HUBER, solver="pcg")
    out, info = ba.solve_ba(tp, ts, cfg)
    N = ts.q.shape[0]
    np.testing.assert_allclose(ranks[0]["costs"], info["costs"].numpy(),
                               rtol=1e-9)
    np.testing.assert_allclose(ranks[0]["p"][:N], out.p.numpy(), rtol=0,
                               atol=1e-9)
    # solve_ba_multihost over the same two ranks is the same solve
    np.testing.assert_array_equal(ranks[0]["multi_costs"], ranks[0]["costs"])


def test_lm_step_matches_local_iteration(problem, ranks):
    """``distributed_lm_step`` over 2 ranks (the flat bank split in two)
    against one local LM iteration of the port and of the JAX package."""
    jp, init = problem
    tp, ts = interop.from_jax_numpy(jp, init, CPU)
    cfg = ba.BAConfig(max_iterations=ITERS, cg_max_iters=CG,
                      huber_delta=HUBER, solver="pcg")
    lam = torch.tensor(1e-4, dtype=torch.float64)
    carry = (ts, lam, ba.ba_cost(tp, ts, HUBER), torch.tensor(False))
    (local, _, cost, _), _ = ba._lm_iteration(tp, cfg, carry)
    np.testing.assert_allclose(float(ranks[0]["step_cost"]), float(cost),
                               rtol=1e-7)
    M = ts.lm.shape[0]
    np.testing.assert_allclose(ranks[0]["step_lm"][:M], local.lm.numpy(),
                               atol=1e-7)
    @jax.jit
    def jstep(jp, init):
        carry = (init, jnp.asarray(1e-4), j_ba_cost(jp, init, HUBER),
                 jnp.asarray(False))
        return j_lm_iteration(jp, _jcfg(), carry, None)[0][2]

    jcost = jstep(*jax.tree.map(jnp.asarray, (jp, init)))
    np.testing.assert_allclose(float(ranks[0]["step_cost"]), float(jcost),
                               rtol=1e-7)


def test_one_rank_equals_single_device(problem):
    """A one-rank mesh (no process group) runs the sharded code path with
    identity collectives: the same numbers as ``solve_ba``, bit for bit."""
    jp, init = problem
    tp, ts = interop.from_jax_numpy(jp, init, CPU)
    cfg = ba.BAConfig(max_iterations=3, cg_max_iters=CG, solver="pcg")
    mesh = make_mesh(MeshConfig(), device=CPU)
    stacked, padded = partition_ba_problem(tp, ts, 1)
    out, info = solve_ba_sharded(stacked, padded, mesh, cfg)
    ref, rinfo = ba.solve_ba(tp, ts, cfg)
    assert torch.equal(info["costs"], rinfo["costs"])
    assert torch.equal(out.p, ref.p) and torch.equal(out.lm, ref.lm)


def test_block_count_mismatch_raises(problem):
    jp, init = problem
    tp, ts = interop.from_jax_numpy(jp, init, CPU)
    stacked, padded = partition_ba_problem(tp, ts, 2)
    with pytest.raises(ValueError, match="blocks"):
        solve_ba_sharded(stacked, padded, make_mesh(device=CPU))


def test_dense_reduced_system_refuses_sharded_blocks(problem):
    from libwave_tpu_torch.optim import schur
    from libwave_tpu_torch.parallel.mesh import Axis

    jp, init = problem
    tp, ts = interop.from_jax_numpy(jp, init, CPU)
    blocks = ba._linearize_ba(tp, ts, 0.0, axis_name=Axis("dp", 1, 0))
    with pytest.raises(ValueError, match="sharded"):
        schur.dense_reduced_system(blocks)
