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
   The reference annotates shardings (observations over ``dp``, landmark
   rows over ``tp``) and lets GSPMD insert collectives; PyTorch has no
   GSPMD, so the port partitions on the host and reduces explicitly. Rank
   ``(d, t)`` holds the observations of dp block ``d`` whose landmark lies
   in chunk ``t`` and only that chunk of landmark rows; landmark-side sums
   psum over ``dp`` (the ranks of one chunk), pose-side sums and the cost
   over the whole mesh (:class:`~libwave_tpu_torch.parallel.mesh.
   Sharding`). :func:`gather_landmarks` assembles the whole map.

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
from libwave_tpu_torch.parallel.mesh import Axis, Mesh, Sharding
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
    """This rank's share of a flat observation bank (:func:`shard_ba_problem`),
    the port's counterpart of a problem placed on a mesh by sharding
    annotations.

    Layout on a ``(dp, tp)`` mesh, rank ``(d, t)``: with ``Mt = ceil(M /
    tp)``, the rank owns the observations of the d-th of ``dp`` contiguous
    slices of the pose-sorted bank whose landmark lies in rows ``[t*Mt,
    (t+1)*Mt)``, so every observation has one owner. ``lm_idx`` is local to
    the chunk. Every rank's list is padded to one common length with
    weight-0 rows at the last pose (``pose_idx`` stays non-decreasing) and
    local landmark 0. Poses, intrinsics and pose-graph banks are
    replicated. ``axes`` says what each sum reduces over."""

    problem: BAProblem
    axes: Sharding


def _pad_to(x, n, fill=0):
    """``x`` (K, ...) padded with rows of ``fill`` to length ``n``."""
    pad = n - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])


def _mesh_axes(mesh: Mesh) -> Sharding:
    """What each sum of the one-step reduces over on ``mesh``. Without a
    tp split, landmark-side sums reduce over the whole mesh, as pose-side
    ones do."""
    whole = mesh.axis(tuple(mesh.axis_names))
    if mesh.shape.get("tp", 1) == 1:
        return Sharding(whole, whole)
    if tuple(mesh.axis_names) != ("dp", "tp"):
        raise ValueError(f"a tp split needs a ('dp', 'tp') mesh, not "
                         f"{mesh.axis_names}")
    return Sharding(whole, mesh.axis("dp"), mesh.axis("tp"))


def shard_ba_problem(problem: BAProblem, state: BAState, mesh: Mesh):
    """Split a problem over ``mesh``: observations over ``dp`` and
    landmark rows over ``tp`` (the layout of :class:`BAShard`). The ELL
    layout is dropped. A ``tp`` that does not divide the landmark count
    pads the last chunk with zero rows; an unobserved row solves to a zero
    step.

    Returns ``(BAShard, state)`` on ``mesh.device``: ``state.lm`` is the
    rank's chunk, ``(ceil(M / tp), 3)``; ``q`` and ``p`` are whole."""
    axes = _mesh_axes(mesh)
    tp = mesh.shape.get("tp", 1)
    d, t = divmod(axes.pose.index, tp)  # tp innermost
    n_dp = axes.pose.size // tp
    K = problem.pose_idx.shape[0]
    M = state.lm.shape[0]
    mt = -(-M // tp)
    kb = max(-(-K // n_dp), 1)
    # owner of every observation: (dp block, landmark chunk)
    lm = schur._host(problem.lm_idx).astype(np.int64)
    owner = (np.arange(K) // kb) * tp + lm // mt
    width = max(int(np.bincount(owner, minlength=n_dp * tp).max()), 1)
    rows = torch.as_tensor(np.flatnonzero(owner == d * tp + t),
                           device=problem.pose_idx.device)
    last = problem.free_pose.shape[0] - 1
    local = problem._replace(
        ell=None, bands=None,
        pose_idx=_pad_to(problem.pose_idx[rows], width, last),
        lm_idx=_pad_to(problem.lm_idx[rows] - t * mt, width),
        uv=_pad_to(problem.uv[rows], width),
        weight=_pad_to(problem.weight[rows], width),
    )
    chunk = _pad_to(state.lm, tp * mt)[t * mt:(t + 1) * mt]
    dev = mesh.device
    state = BAState(q=state.q.to(dev), p=state.p.to(dev), lm=chunk.to(dev))
    return BAShard(to_device(local, dev), axes), state


def gather_landmarks(state: BAState, mesh: Mesh, M: int) -> torch.Tensor:
    """The whole (M, 3) landmark map from the ranks' chunks of a
    :func:`distributed_lm_step` state: an all_gather over ``tp``, trimmed
    of the padding rows. Every rank of ``tp`` must call it."""
    if mesh.shape.get("tp", 1) == 1:
        return state.lm[:M]
    return mesh.axis("tp").all_gather(state.lm)[:M]


@f32_matmuls
def distributed_lm_step(problem: BAShard, state: BAState, cfg: BAConfig,
                        damping: float = 1e-4):
    """One LM iteration on a problem split by :func:`shard_ba_problem`:
    every rank linearizes its share, the normal equations' landmark-side
    sums psum over the ranks of its chunk and the pose-side sums over the
    mesh, and the replicated PCG and step follow. Returns ``(state,
    cost)``: the cost, poses and accept/reject decision are the same on
    every rank, ``state.lm`` is the rank's chunk of landmark rows."""
    local, axes = problem
    lam = torch.full((), damping, dtype=state.p.dtype, device=state.p.device)
    cost = ba_cost(local, state, cfg.huber_delta, axes)
    carry = (state, lam, cost,
             torch.zeros((), dtype=torch.bool, device=state.p.device))
    (new_state, _, new_cost, _), _ = _lm_iteration(local, cfg, carry, axes)
    return new_state, new_cost
