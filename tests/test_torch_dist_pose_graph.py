"""The port's block pose-graph solve (``libwave_tpu_torch.parallel.
dist_pose_graph``) against the JAX package's on the CPU, at f64.

The graph is ``bench_parallel.circle_graph(61)``: 61 poses (padded at 2
and 4 blocks), noisy odometry and ground-truth closures onto the previous
block, through separators (one of them targeted twice), the end-to-start
wrap and both directions between two blocks. The JAX side solves on 2-
and 4-device sub-meshes of the conftest's 8 virtual CPU devices, the port
on 2 and 4 gloo processes (one run per rank count, read by every case).
The block partitions are equal array for array; the cost traces agree to
rtol 1e-9 and the poses to 1e-9; and the block solve agrees with the
port's single-device ``solve_pose_graph``."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from libwave_tpu.optim.pose_graph import BetweenBank as JBetweenBank
from libwave_tpu.optim.pose_graph import PoseGraphConfig as JConfig
from libwave_tpu.parallel import partition_pose_graph as jpartition
from libwave_tpu.parallel import solve_pose_graph_blocks as jsolve
from libwave_tpu.parallel import unpartition as junpartition
from libwave_tpu_torch import interop
from libwave_tpu_torch.bench_parallel import circle_graph
from libwave_tpu_torch.optim.pose_graph import PoseGraphConfig, solve_pose_graph
from libwave_tpu_torch.parallel import partition_pose_graph, unpartition
from torch_dist_run import run_ranks

N, ITERS, CG = 61, 5, 60
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def graph():
    return circle_graph(N)


def _jbank(between):
    return JBetweenBank(*(np.asarray(x.numpy()) for x in between))


@pytest.fixture(scope="module", params=[2, 4])
def run(request, graph, tmp_path_factory):
    R = request.param
    _, _, q0, p0, between = graph
    z = dict(q0=q0.numpy(), p0=p0.numpy(), iters=ITERS, cg=CG,
             **{f"between_{f}": getattr(between, f).numpy()
                for f in between._fields})
    ranks = run_ranks("pose_graph", R, tmp_path_factory.mktemp(f"pg{R}"), z)
    g = jpartition(q0.numpy(), p0.numpy(), _jbank(between), None, R)
    mesh = Mesh(np.asarray(jax.devices()[:R]), ("sp",))
    qb, pb, info = jsolve(g, mesh, JConfig(max_iterations=ITERS,
                                           cg_max_iters=CG))
    q, p = junpartition(qb, pb, N)
    return R, ranks, dict(q=np.asarray(q), p=np.asarray(p),
                          trace=np.asarray(info["cost_trace"]))


def test_block_solve_matches_jax(run):
    R, ranks, ref = run
    r = ranks[0]
    np.testing.assert_allclose(r["trace"], ref["trace"], rtol=1e-9)
    np.testing.assert_allclose(r["p"], ref["p"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(r["q"], ref["q"], rtol=0, atol=1e-9)
    assert r["trace"][-1] < r["trace"][0]


def test_ranks_agree(run):
    _, ranks, _ = run
    for other in ranks[1:]:
        for k in ranks[0]:
            np.testing.assert_array_equal(ranks[0][k], other[k], err_msg=k)


def test_block_solve_matches_single_device(run, graph):
    _, ranks, _ = run
    _, _, q0, p0, between = graph
    q, p, info = solve_pose_graph(
        q0, p0, between, cfg=PoseGraphConfig(max_iterations=ITERS,
                                             cg_max_iters=CG))
    np.testing.assert_allclose(ranks[0]["trace"], info["cost_trace"].numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(ranks[0]["p"], p.numpy(), atol=1e-6)


@pytest.mark.parametrize("R", [2, 3, 4])
def test_partition_matches_jax(graph, R):
    _, _, q0, p0, between = graph
    g = partition_pose_graph(q0, p0, between, None, R, device=CPU)
    jg = jax.tree.map(np.asarray, jpartition(q0.numpy(), p0.numpy(),
                                             _jbank(between), None, R))
    for f in g._fields:
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      getattr(jg, f), err_msg=f)
    carried = interop.block_pose_graph_from_jax_numpy(jg, CPU)
    for a, b in zip(carried, g):
        assert torch.equal(a, b)
    if R == 4:  # every separator kind shows at 4 blocks
        assert int(g.f_use_sep.sum()) == 6 and g.sep_mask.shape[0] == 6


def test_unpartition_gives_the_poses_back(graph):
    _, _, q0, p0, between = graph
    g = partition_pose_graph(q0, p0, between, None, 4, device=CPU)
    q, p = unpartition(g.q, g.p, N)
    assert torch.equal(q, q0) and torch.equal(p, p0)
