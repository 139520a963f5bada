"""Distributed bundle adjustment over a rank mesh.

Port of ``libwave_tpu.parallel.dist_ba``. Two paths, as in the reference:

1. **Sharded ELL solve** (:func:`partition_ba_problem` +
   :func:`solve_ba_sharded`), the production path. The observation bank is
   partitioned into contiguous pose blocks, one per rank, each packed in
   the pose-ELL layout with a common Pmax and its own landmark-sorted
   layout (``schur.EllLayout``: sigma plus CSR offsets). Pose and landmark
   state stay replicated; each rank runs :func:`libwave_tpu_torch.optim.
   ba.solve_ba` with ``axis_name`` set: linearization and pose-side sums
   are local (the pose block all_gathers), landmark-side sums go through
   the rank's own segment reduce and broadcast kernels and psum, and the
   LM loop and PCG run replicated. Every rank takes the same steps on the
   same all-reduced cost; the solve checks that the ranks end with
   bit-identical states.

2. **Flat one-step** (:func:`shard_ba_problem` + :func:`distributed_lm_step`).
   The reference annotates shardings and lets GSPMD insert collectives;
   PyTorch has no GSPMD, so the port splits the flat observation bank over
   every rank of the mesh and psums both sides of the normal equations
   explicitly. Landmark rows stay replicated (padded to a multiple of tp,
   as the reference pads its tp-sharded landmarks): that costs each rank
   the whole landmark state in memory and changes no result.

The reference caches a ``jit(shard_map)`` executable per configuration;
PyTorch runs eagerly and has nothing to cache.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libwave_tpu_torch.optim import schur
from libwave_tpu_torch.optim.ba import (
    BAConfig,
    BAProblem,
    BAState,
    _lm_iteration,
    ba_cost,
    solve_ba,
)
from libwave_tpu_torch.parallel.mesh import Axis, Mesh
from libwave_tpu_torch.utils.device import resolve
from libwave_tpu_torch.utils.precision import f32_matmuls


def partition_ell_bank(pose_idx, lm_idx, weight, num_poses, num_landmarks,
                       n_shards, *arrays, device=None):
    """Host-side: split an observation bank into ``n_shards`` contiguous
    pose blocks, each packed pose-ELL with a common Pmax (so every rank
    runs the same shapes on its block) and its own landmark-sorted layout.
    Rows with zero weight (prior ELL padding) are dropped first.

    Returns ``(pose_idx, lm_idx, weight, ell, *packed, n_pad)``: tensors on
    ``device`` (default: the card) stacked with a leading (n_shards,) axis
    (``ell`` an ``EllLayout`` of stacked sigma and offsets), and ``n_pad``,
    the padded pose count (blocks of ``n_pad / n_shards`` poses)."""
    device = resolve(device)
    pose_idx, lm_idx, weight = (schur._host(x) for x in (pose_idx, lm_idx,
                                                         weight))
    arrays = [schur._host(a) for a in arrays]
    live = weight > 0
    pose_idx, lm_idx, weight = pose_idx[live], lm_idx[live], weight[live]
    arrays = [a[live] for a in arrays]

    nb = -(-num_poses // n_shards)  # ceil
    n_pad = n_shards * nb
    pmax = max(int(np.bincount(pose_idx, minlength=num_poses).max()), 1)

    banks = []
    for b in range(n_shards):
        lo, hi = b * nb, (b + 1) * nb
        sel = (pose_idx >= lo) & (pose_idx < hi)
        banks.append(schur.pack_observations(
            pose_idx[sel] - lo, lm_idx[sel], nb, num_landmarks,
            weight[sel], *[a[sel] for a in arrays], min_pmax=pmax,
            device=device,
        ))
    ell = schur.EllLayout(
        sigma=torch.stack([bk[3].sigma for bk in banks]),
        offsets=torch.stack([bk[3].offsets for bk in banks]),
    )
    return (
        torch.stack([bk[0] for bk in banks]),
        torch.stack([bk[1] for bk in banks]),
        torch.stack([bk[4] for bk in banks]),  # weight (padding already 0)
        ell,
        *[torch.stack([bk[5 + k] for bk in banks])
          for k in range(len(arrays))],
        n_pad,
    )


def _pad_poses(x, n, fill_first=None):
    """(N, ...) padded with ``n`` rows of zeros (first column ``fill_first``
    when given: identity quaternions)."""
    pad = x.new_zeros((n,) + x.shape[1:])
    if fill_first is not None:
        pad[:, 0] = fill_first
    return torch.cat([x, pad])


def partition_ba_problem(problem: BAProblem, state: BAState, n_shards: int,
                         device=None):
    """Host-side partitioner for the sharded ELL solve: the pose range
    split into ``n_shards`` contiguous blocks (N padded to a multiple with
    frozen dummy poses), each block's observations packed pose-ELL with a
    common Pmax.

    Returns ``(stacked_problem, padded_state)`` on ``device`` (default:
    ``state``'s): the bank fields and the layout carry a leading
    (n_shards,) axis; ``K``, ``free_pose``, ``between``, ``priors`` and the
    marginal prior stay global. Feed both to :func:`solve_ba_sharded`."""
    device = state.p.device if device is None else resolve(device)
    N = problem.free_pose.shape[0]
    M = state.lm.shape[0]
    pose_b, lm_b, w_b, ell, uv_b, n_pad = partition_ell_bank(
        problem.pose_idx, problem.lm_idx, problem.weight, N, M, n_shards,
        problem.uv, device=device,
    )
    dtype = state.p.dtype
    pad = n_pad - N
    stacked = problem._replace(
        pose_idx=pose_b, lm_idx=lm_b, uv=uv_b, weight=w_b.to(dtype),
        free_pose=_pad_poses(problem.free_pose.to(device), pad),
        ell=ell, bands=None,
    )
    padded = BAState(
        q=_pad_poses(state.q.to(device), pad, 1.0),
        p=_pad_poses(state.p.to(device), pad),
        lm=state.lm.to(device),
    )
    return stacked, padded


def to_device(problem, device):
    """``problem`` (a NamedTuple of tensors, nested banks and other
    fields) with every tensor moved to ``device``."""
    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(move(v) for v in x))
        return x

    return move(problem)


def local_block(stacked, index: int, fields, device):
    """Block ``index`` of a stacked problem on ``device``: the named bank
    fields and the layout cut to that block, the rest as it is."""
    cut = {f: getattr(stacked, f)[index] for f in fields}
    cut["ell"] = schur.EllLayout(*(x[index] for x in stacked.ell))
    return to_device(stacked._replace(**cut), device)


def assert_replicated(axis: Axis, tensors, what: str):
    """Raise unless every rank of ``axis`` holds the same bits in each of
    ``tensors`` (the replicated LM loop's invariant)."""
    if axis.size == 1:
        return
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    for t in tensors:
        bits = t.contiguous().view(ints[t.element_size()]) \
            if t.is_floating_point() else t
        every = axis.all_gather(bits[None])
        if not torch.equal(every, bits.expand_as(every)):
            raise RuntimeError(f"{what}: the ranks of axis {axis.name!r} "
                               "ended with different states")


def _check_blocks(n_blocks, mesh: Mesh, axis_name, what):
    n_dev = mesh.axis(axis_name).size
    if n_blocks != n_dev:
        raise ValueError(
            f"problem has {n_blocks} {what} blocks but mesh axis "
            f"'{axis_name}' has {n_dev} ranks; re-partition with "
            f"n_shards={n_dev}"
        )


def solve_ba_sharded(
    stacked: BAProblem,
    state: BAState,
    mesh: Mesh,
    cfg: BAConfig = BAConfig(),
    axis_name: str = "dp",
):
    """Full distributed LM solve (trust-region lambda, convergence freeze,
    Huber) with one observation pose block per rank of ``axis_name``.

    ``stacked``/``state`` come from :func:`partition_ba_problem` (every rank
    passes the same ones); the number of blocks must equal the axis size.
    Each rank solves its block on ``mesh.device``. Returns (state, info)
    with the values of :func:`libwave_tpu_torch.optim.ba.solve_ba` on the
    unpartitioned problem, to float rounding, on every rank (trim padding
    poses with ``state.q[:N]``)."""
    _check_blocks(stacked.pose_idx.shape[0], mesh, axis_name, "pose")
    axis = mesh.axis(axis_name)
    problem = local_block(stacked, axis.index,
                          ("pose_idx", "lm_idx", "uv", "weight"),
                          mesh.device)
    state = BAState(*(x.to(mesh.device) for x in state))
    out, info = solve_ba(problem, state, cfg, axis_name=axis)
    assert_replicated(axis, out, "solve_ba_sharded")
    return out, info


class BAShard(NamedTuple):
    """This rank's slice of a flat observation bank (:func:`shard_ba_problem`)
    and the mesh axis that spans every rank: the port's counterpart of a
    problem placed on a mesh by sharding annotations."""

    problem: BAProblem
    axis: Axis


def _pad_rows(x, multiple, fill=0):
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])


def shard_ba_problem(problem: BAProblem, state: BAState, mesh: Mesh):
    """Split a problem's observation bank over every rank of ``mesh``.

    - observations: the flat (pose-sorted) bank padded to a multiple of the
      mesh size with weight-0 rows pointing at the LAST pose (pose_idx
      stays non-decreasing) and landmark 0, then cut into contiguous
      slices, one per rank; the ELL layout is dropped;
    - landmarks: padded with zero rows to a multiple of tp, replicated;
    - poses, intrinsics, pose-graph factors: replicated.

    Returns ``(BAShard, state)`` on ``mesh.device``."""
    names = tuple(mesh.axis_names)
    axis = mesh.axis(names)
    dev = mesh.device
    R = axis.size
    last = problem.free_pose.shape[0] - 1
    bank = dict(
        pose_idx=_pad_rows(problem.pose_idx, R, last),
        lm_idx=_pad_rows(problem.lm_idx, R),
        uv=_pad_rows(problem.uv, R),
        weight=_pad_rows(problem.weight, R),
    )
    kb = bank["pose_idx"].shape[0] // R
    lo = axis.index * kb
    local = to_device(problem._replace(ell=None, bands=None, **{
        k: v[lo:lo + kb] for k, v in bank.items()}), dev)
    tp = mesh.shape.get("tp", 1)
    state = BAState(q=state.q.to(dev), p=state.p.to(dev),
                    lm=_pad_rows(state.lm, tp).to(dev))
    return BAShard(local, axis), state


@f32_matmuls
def distributed_lm_step(problem: BAShard, state: BAState, cfg: BAConfig,
                        damping: float = 1e-4):
    """One LM iteration on a problem split by :func:`shard_ba_problem`:
    every rank linearizes its slice, the normal equations' pose- and
    landmark-side sums psum over the mesh, and the replicated PCG and
    step follow. Returns ``(state, cost)``, the same on every rank."""
    local, axis = problem
    lam = torch.full((), damping, dtype=state.p.dtype, device=state.p.device)
    cost = ba_cost(local, state, cfg.huber_delta, axis)
    carry = (state, lam, cost,
             torch.zeros((), dtype=torch.bool, device=state.p.device))
    (new_state, _, new_cost, _), _ = _lm_iteration(local, cfg, carry, axis)
    return new_state, new_cost
