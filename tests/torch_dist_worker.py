"""One rank of a multi-process CPU run of the port's distributed layer.

    python tests/torch_dist_worker.py CASE RANK WORLD STORE IN_NPZ OUT_DIR

Joins a gloo process group through the file store STORE (no TCP port, so
concurrent test runs never collide), runs CASE on the CPU with one torch
thread, and writes ``OUT_DIR/rank{RANK}.npz``. Inputs come from IN_NPZ,
written by the test that spawned the ranks. Imports no JAX.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from libwave_tpu_torch.matching.icp import ICPParams
from libwave_tpu_torch.matching.multi import multi_match_sharded
from libwave_tpu_torch.matching.pointcloud import PointCloud
from libwave_tpu_torch.optim import ba, schur
from libwave_tpu_torch.optim.pose_graph import BetweenBank, PoseGraphConfig
from libwave_tpu_torch.parallel import (
    MeshConfig,
    MultiHostConfig,
    distributed_lm_step,
    flatten_mesh,
    gather_landmarks,
    initialize_multihost,
    make_host_mesh,
    make_mesh,
    partition_ba_problem,
    partition_pose_graph,
    partition_vio_problem,
    shard_ba_problem,
    solve_ba_multihost,
    solve_ba_sharded,
    solve_pose_graph_blocks,
    solve_vio_sharded,
    unpartition,
)
from libwave_tpu_torch.pipelines.vio import VIOConfig, VIOProblem, VIOState
from libwave_tpu_torch.optim.imu import PreintegratedImu

CPU = torch.device("cpu")


def t(x):
    return torch.as_tensor(np.asarray(x))


def ba_problem(z):
    """The port's BAProblem and state from the arrays the test wrote."""
    M = z["lm"].shape[0]
    between = priors = None
    if "between_i" in z:
        between = BetweenBank(*(t(z[f"between_{f}"])
                                for f in BetweenBank._fields))
    if "priors_i" in z:
        from libwave_tpu_torch.optim.pose_graph import PriorBank
        priors = PriorBank(*(t(z[f"priors_{f}"]) for f in PriorBank._fields))
    problem = ba.BAProblem(
        K=t(z["K"]), pose_idx=t(z["pose_idx"]), lm_idx=t(z["lm_idx"]),
        uv=t(z["uv"]), weight=t(z["weight"]), free_pose=t(z["free_pose"]),
        between=between, priors=priors,
        ell=schur.build_ell_layout(z["lm_idx"], M, valid=z["weight"] > 0,
                                   device=CPU))
    return problem, ba.BAState(t(z["q"]), t(z["p"]), t(z["lm"]))


def ba_config(z):
    return ba.BAConfig(max_iterations=int(z["iters"]),
                       cg_max_iters=int(z["cg"]),
                       huber_delta=float(z["huber"]) or None, solver="pcg")


def one_step(problem, state, cfg, mesh, tag):
    """``distributed_lm_step`` on ``mesh``, keyed ``{tag}_...``: the cost,
    the poses and the gathered map, and every rank's chunk and (dp, tp)
    index gathered in rank order (so every rank writes the same arrays
    but its own cost and poses)."""
    sharded, st = shard_ba_problem(problem, state, mesh)
    step, cost = distributed_lm_step(sharded, st, cfg)
    whole = mesh.axis(mesh.axis_names)
    index = torch.tensor([[mesh.axis("dp").index, mesh.axis("tp").index]])
    return {f"{tag}_cost": cost, f"{tag}_q": step.q, f"{tag}_p": step.p,
            f"{tag}_lm": gather_landmarks(step, mesh, state.lm.shape[0]),
            f"{tag}_chunks": whole.all_gather(step.lm[None]),
            f"{tag}_index": whole.all_gather(index)}


def case_ba(z, world):
    problem, state = ba_problem(z)
    cfg = ba_config(z)
    mesh = make_mesh(MeshConfig(dp=world), device=CPU)
    stacked, padded = partition_ba_problem(problem, state, world)
    out, info = solve_ba_sharded(stacked, padded, mesh, cfg)
    sharded, st = shard_ba_problem(problem, state, mesh)
    step, step_cost = distributed_lm_step(sharded, st, cfg)
    multi, minfo = solve_ba_multihost(problem, state, cfg)
    tp = one_step(problem, state, cfg,
                  make_mesh(MeshConfig(dp=1, tp=world), device=CPU), "tp")
    return dict(q=out.q, p=out.p, lm=out.lm, costs=info["costs"],
                initial_cost=info["initial_cost"],
                final_cost=info["final_cost"], step_cost=step_cost,
                step_p=step.p, step_lm=step.lm, multi_costs=minfo["costs"],
                **tp)


def case_ba_step(z, world):
    """The one-step distributed LM on a (world / 2, 2) mesh."""
    problem, state = ba_problem(z)
    mesh = make_mesh(MeshConfig(dp=world // 2, tp=2), device=CPU)
    return one_step(problem, state, ba_config(z), mesh, "tp")


def case_vio(z, world):
    pim = PreintegratedImu(*(t(z[f"pim_{f}"])
                             for f in PreintegratedImu._fields))
    M = z["lm"].shape[0]
    problem = VIOProblem(
        K=t(z["K"]), pose_idx=t(z["pose_idx"]), lm_idx=t(z["lm_idx"]),
        uv=t(z["uv"]), obs_weight=t(z["obs_weight"]), pim=pim,
        imu_i=t(z["imu_i"]), imu_j=t(z["imu_j"]),
        imu_sqrt_info=t(z["imu_sqrt_info"]),
        bias_walk_sqrt_info=t(z["bias_walk_sqrt_info"]),
        free_pose=t(z["free_pose"]), q_BC=t(z["q_BC"]),
        bias_prior_sqrt_info=t(z["bias_prior_sqrt_info"]),
        ell=schur.build_ell_layout(z["lm_idx"], M,
                                   valid=z["obs_weight"] > 0, device=CPU),
        pixel_sigma=float(z["pixel_sigma"]))
    state = VIOState(*(t(z[f]) for f in VIOState._fields))
    cfg = VIOConfig(max_iterations=int(z["iters"]),
                    cg_max_iters=int(z["cg"]), solver="pcg")
    mesh = make_mesh(MeshConfig(dp=world), device=CPU)
    stacked, padded = partition_vio_problem(problem, state, world)
    out, info = solve_vio_sharded(stacked, padded, mesh, cfg)
    return dict(**{f: getattr(out, f) for f in VIOState._fields},
                costs=info["costs"], initial_cost=info["initial_cost"],
                final_cost=info["final_cost"])


def case_pose_graph(z, world):
    between = BetweenBank(*(t(z[f"between_{f}"])
                            for f in BetweenBank._fields))
    g = partition_pose_graph(t(z["q0"]), t(z["p0"]), between, None, world,
                             device=CPU)
    mesh = flatten_mesh(make_mesh(device=CPU), "sp")
    cfg = PoseGraphConfig(max_iterations=int(z["iters"]),
                          cg_max_iters=int(z["cg"]))
    qb, pb, info = solve_pose_graph_blocks(g, mesh, cfg)
    q, p = unpartition(qb, pb, z["q0"].shape[0])
    return dict(q=q, p=p, trace=info["cost_trace"])


def case_match(z, world):
    def cloud(name):
        return PointCloud(points=t(z[f"{name}_points"]),
                          mask=t(z[f"{name}_mask"]))

    mesh = make_mesh(MeshConfig(dp=world), device=CPU)
    params = ICPParams(max_corr=float(z["max_corr"]),
                       max_iter=int(z["max_iter"]), res=float(z["res"]),
                       multiscale_steps=int(z["multiscale_steps"]))
    res = multi_match_sharded(cloud("refs"), cloud("targets"), mesh, params)
    return dict(t=res.transform.t, q=res.transform.q,
                converged=res.converged, iterations=res.iterations,
                correspondences=res.correspondences)


def case_mesh(z, world):
    """Mesh shapes, the factorization error, the axis collectives and the
    host mesh over ``world`` ranks."""
    me = dist.get_rank()
    mesh = make_mesh(MeshConfig(dp=-1, tp=2), device=CPU)
    dp, tp = mesh.axis("dp"), mesh.axis("tp")
    try:
        make_mesh(MeshConfig(dp=3, tp=2), device=CPU)
        bad = 0
    except ValueError:
        bad = 1
    x = torch.full((2,), float(me + 1), dtype=torch.float64)
    ring = [(k, (k + 1) % dp.size) for k in range(dp.size)]
    host = make_host_mesh(device=CPU)
    flat = flatten_mesh(host, "dp")
    return dict(
        shape=np.array([mesh.shape["dp"], mesh.shape["tp"]]),
        index=np.array([dp.index, tp.index]), bad=np.array(bad),
        psum_tp=tp.psum(x), psum_all=mesh.axis(("dp", "tp")).psum(x),
        gather_dp=dp.all_gather(x[None]), ppermute_dp=dp.ppermute(x, ring),
        host_shape=np.array(host.ranks.shape), flat_size=np.array(flat.size),
        flat_index=np.array(flat.axis("dp").index))


CASES = {"ba": case_ba, "ba_step": case_ba_step, "vio": case_vio, "pose_graph": case_pose_graph,
         "match": case_match, "mesh": case_mesh}


def main():
    case, rank, world, store, inp, out = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    initialize_multihost(MultiHostConfig(
        coordinator_address=f"file://{store}", num_processes=world,
        process_id=rank), backend="gloo")
    z = dict(np.load(inp)) if inp != "-" else {}
    res = CASES[case](z, world)
    np.savez(f"{out}/rank{rank}.npz", **{
        k: v.numpy() if isinstance(v, torch.Tensor) else v
        for k, v in res.items()})
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
