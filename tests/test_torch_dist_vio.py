"""The port's distributed VIO (``libwave_tpu_torch.parallel.dist_vio``)
against the JAX package's on the CPU, at f64.

The problem is the port's ``vio_from_sim`` (noise-free, 30 landmarks, 100
steps at 10 Hz, perturbed start) carried into the JAX package's
containers, as in tests/test_torch_vio_solve.py. Its keyframe count and
IMU factor count are odd, so both the keyframe and the IMU-bank padding
run. The JAX side solves on a 2-device sub-mesh of the conftest's 8
virtual CPU devices, the port on 2 gloo processes (one run, read by every
case); both PCG. Costs agree to rtol 1e-9, the states to 1e-9. Its 9
keyframes pad to 10 at 2 blocks; at 3 blocks (partition only) its 8 IMU
factors pad to 9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.geometry import so3 as jso3
from libwave_tpu.optim import imu as jimu
from libwave_tpu.optim import schur as js
from libwave_tpu.parallel import MeshConfig as JMeshConfig
from libwave_tpu.parallel import make_mesh as jmake_mesh
from libwave_tpu.parallel import partition_vio_problem as jpartition
from libwave_tpu.parallel import solve_vio_sharded as jsolve
from libwave_tpu.pipelines import vio as jv
from libwave_tpu_torch import interop
from libwave_tpu_torch.parallel import partition_vio_problem
from libwave_tpu_torch.pipelines import vio as tv
from libwave_tpu_torch.sim import vo_dataset as tvo
from torch_dist_run import run_ranks

PARAMS = dict(nb_landmarks=30, steps=100, hz=10.0, fx=200.0, fy=200.0)
ITERS, CG = 4, 40
CPU = torch.device("cpu")


def _to_jax(pt):
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
    rng = np.random.default_rng(5)
    N, M = gt.q.shape[0], gt.lm.shape[0]
    gj = jv.VIOState(*(jnp.asarray(x.numpy()) for x in gt))
    init_j = jv.VIOState(
        q=jso3.quat_boxplus(gj.q, jnp.asarray(0.01 * rng.normal(size=(N, 3)))
                            * jnp.asarray(pt.free_pose[:, :3].numpy())),
        p=gj.p + 0.03 * rng.normal(size=(N, 3)) * pt.free_pose[:, 3:6].numpy(),
        v=gj.v + 0.05 * rng.normal(size=(N, 3)), bg=gj.bg, ba=gj.ba,
        lm=gj.lm + 0.2 * rng.normal(size=(M, 3)),
    )
    st = tv.VIOState(*(torch.as_tensor(np.array(x)) for x in init_j))
    return _to_jax(pt), init_j, pt, st


@pytest.fixture(scope="module")
def jax_sharded(problems):
    pj, init_j, _, _ = problems
    cfg = jv.VIOConfig(max_iterations=ITERS, cg_max_iters=CG, solver="pcg")
    mesh = jmake_mesh(JMeshConfig(dp=2), devices=jax.devices()[:2])
    stacked, padded = jpartition(pj, init_j, 2)
    state, info = jsolve(stacked, padded, mesh, cfg)
    return (jax.tree.map(np.asarray, (stacked, padded)),
            jax.tree.map(np.asarray, (state, info)))


@pytest.fixture(scope="module")
def ranks(problems, tmp_path_factory):
    _, _, pt, st = problems
    z = {f: getattr(pt, f).numpy() for f in (
        "K", "pose_idx", "lm_idx", "uv", "obs_weight", "imu_i", "imu_j",
        "imu_sqrt_info", "bias_walk_sqrt_info", "free_pose", "q_BC",
        "bias_prior_sqrt_info")}
    z.update({f"pim_{f}": getattr(pt.pim, f).numpy()
              for f in pt.pim._fields})
    z.update({f: getattr(st, f).numpy() for f in tv.VIOState._fields})
    z.update(pixel_sigma=pt.pixel_sigma, iters=ITERS, cg=CG)
    return run_ranks("vio", 2, tmp_path_factory.mktemp("dist_vio"), z)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_partition_matches_jax(problems, n_shards):
    pj, init_j, pt, st = problems
    jst, jpad = jax.tree.map(np.asarray, jpartition(pj, init_j, n_shards))
    stacked, padded = partition_vio_problem(pt, st, n_shards)
    assert stacked.pose_idx.shape[0] == n_shards
    assert stacked.imu_i.shape[0] % n_shards == 0
    for f in ("pose_idx", "lm_idx", "uv", "obs_weight", "free_pose",
              "imu_i", "imu_j", "imu_sqrt_info"):
        np.testing.assert_array_equal(getattr(stacked, f).numpy(),
                                      np.asarray(getattr(jst, f)),
                                      err_msg=f)
    for a, b in zip(stacked.pim, jst.pim):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(padded, jpad):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    carried = interop.stacked_vio_from_jax_numpy(
        jst, PARAMS["nb_landmarks"], CPU)
    for a, b in zip(carried.ell, stacked.ell):
        assert torch.equal(a, b)


def test_sharded_solve_matches_jax(ranks, jax_sharded):
    _, (jstate, jinfo) = jax_sharded
    r = ranks[0]
    np.testing.assert_allclose(r["costs"], jinfo["costs"], rtol=1e-9)
    np.testing.assert_allclose(r["initial_cost"], jinfo["initial_cost"],
                               rtol=1e-12)
    for f in tv.VIOState._fields:
        np.testing.assert_allclose(r[f], getattr(jstate, f), rtol=0,
                                   atol=1e-9, err_msg=f)
    assert r["final_cost"] < r["initial_cost"]


def test_ranks_end_bit_identical(ranks):
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_sharded_solve_matches_single_device(problems, ranks):
    _, _, pt, st = problems
    cfg = tv.VIOConfig(max_iterations=ITERS, cg_max_iters=CG, solver="pcg")
    out, info = tv.solve_vio(pt, st, cfg)
    N = st.q.shape[0]
    np.testing.assert_allclose(ranks[0]["costs"], info["costs"].numpy(),
                               rtol=1e-9)
    np.testing.assert_allclose(ranks[0]["p"][:N], out.p.numpy(), rtol=0,
                               atol=1e-9)
