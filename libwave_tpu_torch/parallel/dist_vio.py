"""Distributed VIO: the full visual-inertial solve over a rank mesh.

Port of ``libwave_tpu.parallel.dist_vio``, the design of
:mod:`libwave_tpu_torch.parallel.dist_ba`: the reprojection bank is
partitioned into contiguous keyframe blocks, one per rank, each in the
pose-ELL layout with its own landmark-sorted layout; keyframe and landmark
state and the bias-walk factors stay replicated; each rank linearizes its
slice of the IMU bank (padded with zero-information factors to a multiple
of the rank count) and the slices all_gather. Each rank runs
:func:`libwave_tpu_torch.pipelines.vio.solve_vio` with ``axis_name`` set:
the trust-region LM loop and PCG run replicated with the landmark-side
sums psum'd and the pose blocks all_gathered.
"""

from __future__ import annotations

import torch

from libwave_tpu_torch.parallel.dist_ba import (
    _check_blocks,
    _pad_poses,
    assert_replicated,
    local_block,
    partition_ell_bank,
)
from libwave_tpu_torch.parallel.mesh import Mesh
from libwave_tpu_torch.pipelines.vio import (
    VIOConfig,
    VIOProblem,
    VIOState,
    solve_vio,
)
from libwave_tpu_torch.utils.device import resolve


def partition_vio_problem(problem: VIOProblem, state: VIOState,
                          n_shards: int, device=None):
    """Host-side partitioner: contiguous keyframe blocks of the
    reprojection bank (common Pmax), keyframe padding with frozen dummy
    states, the IMU bank padded to a multiple of ``n_shards`` with
    zero-information factors (copies of the first factor whose whitening
    is zero, which silences their IMU and bias-walk residuals). Returns
    ``(stacked_problem, padded_state)`` on ``device`` (default:
    ``state``'s) for :func:`solve_vio_sharded`."""
    device = state.p.device if device is None else resolve(device)
    N = problem.free_pose.shape[0]
    M = state.lm.shape[0]
    pose_b, lm_b, w_b, ell, uv_b, n_pad = partition_ell_bank(
        problem.pose_idx, problem.lm_idx, problem.obs_weight, N, M,
        n_shards, problem.uv, device=device,
    )
    dtype = state.p.dtype
    pad = n_pad - N
    free = problem.free_pose.to(device)
    stacked = problem._replace(
        pose_idx=pose_b, lm_idx=lm_b, uv=uv_b, obs_weight=w_b.to(dtype),
        free_pose=_pad_poses(free, pad), ell=ell,
    )
    F = problem.imu_i.shape[0]
    f_pad = (-F) % n_shards
    if f_pad:
        def rep(x):
            x = x.to(device)
            return torch.cat([x, x[:1].expand((f_pad,) + x.shape[1:])])

        def zeros(x):
            x = x.to(device)
            return torch.cat([x, x.new_zeros((f_pad,) + x.shape[1:])])

        stacked = stacked._replace(
            pim=type(problem.pim)(*(rep(x) for x in problem.pim)),
            imu_i=zeros(problem.imu_i), imu_j=zeros(problem.imu_j),
            imu_sqrt_info=zeros(problem.imu_sqrt_info),
        )
    padded = VIOState(
        q=_pad_poses(state.q.to(device), pad, 1.0),
        p=_pad_poses(state.p.to(device), pad),
        v=_pad_poses(state.v.to(device), pad),
        bg=_pad_poses(state.bg.to(device), pad),
        ba=_pad_poses(state.ba.to(device), pad),
        lm=state.lm.to(device),
    )
    return stacked, padded


def solve_vio_sharded(
    stacked: VIOProblem,
    state: VIOState,
    mesh: Mesh,
    cfg: VIOConfig = VIOConfig(),
    axis_name: str = "dp",
):
    """Full distributed VIO LM solve, one keyframe block per rank of
    ``axis_name``. ``stacked``/``state`` come from
    :func:`partition_vio_problem` (every rank passes the same ones); the
    number of blocks must equal the axis size. Returns (state, info)
    matching :func:`libwave_tpu_torch.pipelines.vio.solve_vio` on the
    unpartitioned problem to float rounding, on every rank (trim padding
    keyframes with ``[:N]``). Runs PCG whatever ``cfg.solver`` says: the
    reduced system couples keyframes across ranks."""
    _check_blocks(stacked.pose_idx.shape[0], mesh, axis_name, "keyframe")
    axis = mesh.axis(axis_name)
    problem = local_block(stacked, axis.index,
                          ("pose_idx", "lm_idx", "uv", "obs_weight"),
                          mesh.device)
    state = VIOState(*(x.to(mesh.device) for x in state))
    out, info = solve_vio(problem, state, cfg, axis_name=axis)
    assert_replicated(axis, out, "solve_vio_sharded")
    return out, info
