"""The port's distributed BA (``libwave_tpu_torch.parallel.dist_ba``)
against the JAX package's on the CPU.

The JAX side runs on a 2-device sub-mesh of the conftest's 8 virtual CPU
devices; the port's on 2 gloo processes (``tests/torch_dist_worker.py``,
one run per module, read by every case). Same problem (the JAX package's
``ba_from_dataset`` with odometry, priors and Huber, f64), same
partitions: the sharded solves agree to 1e-9 (the two packages sum the
landmark runs in other orders; nothing else differs); the one-step
distributed LM iteration equals a local iteration to rtol 1e-7. With
landmark rows split over ``tp`` (a (1, 2) mesh on the same 2 ranks, a
(2, 2) mesh on 4 more), the one-step equals a local iteration and the
JAX package's step on a (2, 2) sub-mesh to the JAX test's own bounds
(``tests/test_parallel.py``: cost rtol 1e-7, states atol 1e-8)."""

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
    shard_ba_problem,
    solve_ba_sharded,
)
from libwave_tpu_torch.parallel.mesh import Axis, Mesh
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


# ---------------------------------------------------------------------------
# landmark rows sharded over tp in the one-step
# ---------------------------------------------------------------------------

MESHES = {"1x2": (1, 2), "2x2": (2, 2)}


@pytest.fixture(scope="module")
def ranks4(problem, tmp_path_factory):
    jp, init = problem
    return run_ranks("ba_step", 4, tmp_path_factory.mktemp("dist_ba_step"),
                     _inputs(jp, init))


@pytest.fixture(scope="module")
def local_step(problem):
    """One local LM iteration of the port: (state, cost)."""
    jp, init = problem
    tp, ts = interop.from_jax_numpy(jp, init, CPU)
    cfg = ba.BAConfig(max_iterations=ITERS, cg_max_iters=CG,
                      huber_delta=HUBER, solver="pcg")
    lam = torch.tensor(1e-4, dtype=torch.float64)
    carry = (ts, lam, ba.ba_cost(tp, ts, HUBER), torch.tensor(False))
    (state, _, cost, _), _ = ba._lm_iteration(tp, cfg, carry)
    return state, float(cost)


@pytest.fixture(scope="module")
def jax_step(problem):
    """The JAX package's ``shard_ba_problem`` + ``distributed_lm_step`` on
    a (2, 2) sub-mesh: (state, cost)."""
    jp, init = problem
    mesh = jpar.make_mesh(jpar.MeshConfig(dp=2, tp=2),
                          devices=jax.devices()[:4])
    sp, ss = jpar.shard_ba_problem(*jax.tree.map(jnp.asarray, (jp, init)),
                                   mesh)
    state, cost = jpar.distributed_lm_step(sp, ss, _jcfg())
    return jax.tree.map(np.asarray, state), float(cost)


@pytest.fixture(scope="module", params=sorted(MESHES))
def tp_step(request):
    """(mesh shape, the port's ranks' results on it)."""
    dp, tp = MESHES[request.param]
    return (dp, tp), request.getfixturevalue(
        "ranks4" if dp * tp == 4 else "ranks")


def test_lm_step_tp_matches_local_and_jax(local_step, jax_step, tp_step):
    """The one-step with landmark rows over tp against a local LM iteration
    of the port and the JAX package's step on a (dp, tp) mesh."""
    _, outs = tp_step
    jstate, jcost = jax_step
    local, cost = local_step
    M = local.lm.shape[0]
    r = outs[0]
    for ref in (cost, jcost):
        np.testing.assert_allclose(float(r["tp_cost"]), ref, rtol=1e-7)
    for want in (local.lm.numpy(), jstate.lm[:M]):
        np.testing.assert_allclose(r["tp_lm"], want, rtol=0, atol=1e-8)
    for f in ("q", "p"):
        for want in (getattr(local, f).numpy(), getattr(jstate, f)):
            np.testing.assert_allclose(r[f"tp_{f}"], want, rtol=0,
                                       atol=1e-8, err_msg=f)


def test_lm_step_tp_layout(problem, tp_step):
    """Each rank holds ceil(M / tp) landmark rows (its chunk, gathered by
    rank); the poses and the cost are the same bits on every rank, a chunk
    the same bits on its dp replicas; ``gather_landmarks`` gives back the
    M rows, the chunks in order, on every rank."""
    (dp, tp), outs = tp_step
    M = problem[1].lm.shape[0]
    mt = -(-M // tp)
    for k in ("tp_q", "tp_p", "tp_cost", "tp_lm", "tp_chunks"):
        for o in outs[1:]:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
    r0 = outs[0]
    R = dp * tp
    np.testing.assert_array_equal(
        r0["tp_index"], np.stack([np.arange(R) // tp, np.arange(R) % tp], 1))
    chunks = r0["tp_chunks"]
    assert chunks.shape == (R, mt, 3) and r0["tp_lm"].shape == (M, 3)
    for r in range(tp, R):  # dp replica of chunk r % tp
        np.testing.assert_array_equal(chunks[r], chunks[r % tp])
    np.testing.assert_array_equal(
        np.concatenate(list(chunks[:tp]))[:M], r0["tp_lm"])


def _rank_mesh(dp, tp, d, t):
    """Rank (d, t)'s view of a (dp, tp) mesh, for the host partition only
    (its collectives are never called)."""
    axes = {"dp": Axis("dp", dp, d, live=False),
            "tp": Axis("tp", tp, t, live=False),
            ("dp", "tp"): Axis(("dp", "tp"), dp * tp, d * tp + t,
                               live=False)}
    return Mesh(np.arange(dp * tp).reshape(dp, tp), ("dp", "tp"), CPU,
                None, axes)


@pytest.mark.parametrize("shape", [(2, 2), (1, 3), (3, 2)])
def test_shard_partition_owns_each_observation_once(problem, shape):
    """``shard_ba_problem``'s host partition: rank (d, t) holds, in bank
    order, the observations of the d-th contiguous slice whose landmark
    lies in chunk t, with chunk-local ids, so every observation has one
    owner; one common list length, padded with weight-0 rows at the last
    pose and local landmark 0; the rank's chunk of landmark rows, zero rows
    past M (40 landmarks: tp = 3 pads)."""
    dp, tp = shape
    jp, init = problem
    prob, st = interop.from_jax_numpy(jp, init, CPU)
    K, M, N = prob.pose_idx.shape[0], st.lm.shape[0], st.q.shape[0]
    mt, kb = -(-M // tp), -(-K // dp)
    lm_rows = torch.cat([st.lm, st.lm.new_zeros((tp * mt - M, 3))])
    owned, widths = 0, set()
    for d in range(dp):
        for t in range(tp):
            shard, s = shard_ba_problem(prob, st, _rank_mesh(dp, tp, d, t))
            loc = shard.problem
            assert loc.ell is None
            assert torch.equal(s.q, st.q) and torch.equal(s.p, st.p)
            assert torch.equal(s.lm, lm_rows[t * mt:(t + 1) * mt])
            widths.add(loc.pose_idx.shape[0])
            assert bool((torch.diff(loc.pose_idx) >= 0).all())
            rows = torch.arange(d * kb, min((d + 1) * kb, K))
            rows = rows[prob.lm_idx[rows] // mt == t]
            n = rows.shape[0]
            owned += n
            assert torch.equal(loc.pose_idx[:n], prob.pose_idx[rows])
            assert torch.equal(loc.lm_idx[:n], prob.lm_idx[rows] - t * mt)
            assert torch.equal(loc.uv[:n], prob.uv[rows])
            assert torch.equal(loc.weight[:n], prob.weight[rows])
            assert bool((loc.pose_idx[n:] == N - 1).all())
            assert bool((loc.lm_idx[n:] == 0).all())
            assert bool((loc.weight[n:] == 0).all())
            assert bool((loc.uv[n:] == 0).all())
    assert owned == K and len(widths) == 1
