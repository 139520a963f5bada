"""Distributed pose-graph optimization: trajectory-block (sequence-parallel)
partitioning with explicit halo and separator exchange.

Port of ``libwave_tpu.parallel.dist_pose_graph``. A long trajectory is
split into contiguous keyframe blocks, one per rank of a 1-D mesh axis
(``"sp"``), and the communication is written out by hand:

- **halo exchange** (the reference's ``jax.lax.ppermute`` over the ring):
  odometry factors crossing a block boundary need the neighbouring
  block's poses; every rank receives both neighbours' blocks, so factors
  whose endpoints sit in adjacent blocks stay local. The port's
  ``Axis.ppermute`` is a tiled all_gather and a pick of the source block
  (exact, and the one form gloo offers for CUDA tensors);
- **separator exchange** (psum): long-range loop closures touch a small
  static set of separator poses. Each rank scatters the separators it
  owns into a shared (S, ...) table that one psum replicates; transpose
  contributions flow back through a second psum.

Each between-factor lives on the rank owning pose ``i``, padded to a
common per-block capacity with zero-information slots. The solver is the
GN + block-Jacobi PCG of :func:`libwave_tpu_torch.optim.pose_graph.
solve_pose_graph`, with the global dot products psum'd, so the block and
single-device solves agree to float rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.optim.schur import _host
from libwave_tpu_torch.optim.pose_graph import (
    BetweenBank,
    PoseGraphConfig,
    PriorBank,
    _bank_jacobians,
    _between_residual,
    _prior_residual,
)
from libwave_tpu_torch.parallel.mesh import Axis, Mesh
from libwave_tpu_torch.utils.device import resolve
from libwave_tpu_torch.utils.precision import f32_matmuls


class BlockPoseGraph(NamedTuple):
    """Host-partitioned pose graph, everything block-shaped (leading axis =
    n_blocks, one block per rank).

    Per-factor endpoint addressing is extended-local: index into the
    (3*Nb,) concatenation [prev block | own block | next block], or, for
    long-range closures, into the separator table via ``f_jsep`` with
    ``f_jext`` pointing at a dummy slot and ``f_use_sep`` = 1.
    """

    q: torch.Tensor  # (B, Nb, 4)
    p: torch.Tensor  # (B, Nb, 3)
    free: torch.Tensor  # (B, Nb) 1.0 = free, 0.0 = gauge-fixed/padding
    f_il: torch.Tensor  # (B, Fb) owner-local index of pose i in [0, Nb)
    f_jext: torch.Tensor  # (B, Fb) extended-local index of pose j in [0, 3Nb)
    f_jsep: torch.Tensor  # (B, Fb) separator-table index of j (0 if unused)
    f_use_sep: torch.Tensor  # (B, Fb) 1.0 where j resolves via separators
    f_dq: torch.Tensor  # (B, Fb, 4)
    f_dp: torch.Tensor  # (B, Fb, 3)
    f_sqrt_info: torch.Tensor  # (B, Fb, 6) zero rows on padding slots
    pr_il: torch.Tensor  # (B, Pb)
    pr_q: torch.Tensor  # (B, Pb, 4)
    pr_p: torch.Tensor  # (B, Pb, 3)
    pr_sqrt_info: torch.Tensor  # (B, Pb, 6)
    sep_block: torch.Tensor  # (S,) owning block of each separator pose
    sep_local: torch.Tensor  # (S,) its local index there
    sep_mask: torch.Tensor  # (S,) 1.0 on real separators (slot 0 is dummy)


def _bank_blocks(owner, n_blocks, rows, fields):
    """Pack factor rows into (n_blocks, cap) banks by owning block, in
    factor order. ``fields``: name -> (values per factor, filler row)."""
    counts = np.bincount(owner, minlength=n_blocks)
    cap = max(int(counts.max()) if len(owner) else 0, 1)
    out = {}
    for name, (vals, fill) in fields.items():
        a = np.empty((n_blocks, cap) + vals.shape[1:], vals.dtype)
        a[...] = fill
        out[name] = a
    cursor = np.zeros(n_blocks, np.int64)
    for f in range(rows):
        b = int(owner[f])
        c = int(cursor[b])
        cursor[b] += 1
        for name, (vals, _) in fields.items():
            out[name][b, c] = vals[f]
    return out


def partition_pose_graph(q, p, between: BetweenBank,
                         priors: PriorBank | None, n_blocks: int, free=None,
                         device=None) -> BlockPoseGraph:
    """Host-side partitioner: contiguous keyframe blocks + factor
    ownership. Pads N to ``n_blocks * Nb`` with frozen dummy poses and each
    block's factor and prior banks to common capacities with
    zero-information slots. Tensors on ``device`` (default: ``p``'s when
    it is a tensor, else the card)."""
    if device is None:
        device = p.device if isinstance(p, torch.Tensor) else resolve(None)
    q, p = _host(q), _host(p)
    n = q.shape[0]
    dtype = p.dtype
    nb = -(-n // n_blocks)  # ceil
    n_pad = n_blocks * nb

    if free is None:
        free_np = np.ones(n, dtype)
        if priors is None:
            free_np[0] = 0.0
    else:
        free_np = _host(free).astype(dtype).copy()

    def pad_poses(x, fill):
        out = np.full((n_pad,) + x.shape[1:], fill, dtype=x.dtype)
        out[:n] = x
        return out

    qp = pad_poses(q, 0.0)
    qp[n:, 0] = 1.0  # identity quaternions on padding
    pp = pad_poses(p, 0.0)
    fp = pad_poses(free_np, 0.0)  # padding poses frozen

    i, j = _host(between.i).astype(np.int64), _host(between.j).astype(np.int64)
    own, jblk = i // nb, j // nb
    span = jblk - own

    # separators: targets of long-range (|span| >= 2) factors; slot 0 is a
    # dummy so the table is never empty and padded factors have a target
    long_range = np.abs(span) >= 2
    sep_ids = np.unique(j[long_range]) if long_range.any() \
        else np.empty(0, np.int64)
    sep_block = np.concatenate([[0], sep_ids // nb]).astype(np.int32)
    sep_local = np.concatenate([[0], sep_ids % nb]).astype(np.int32)
    sep_mask = np.concatenate([[0.0], np.ones(len(sep_ids))]).astype(dtype)
    sep_slot = {int(g): s + 1 for s, g in enumerate(sep_ids)}

    near = np.abs(span) <= 1
    jext = np.where(near, (span + 1) * nb + j - jblk * nb, nb)  # dummy: own 0
    jsep = np.array([0 if ok else sep_slot[int(jj)]
                     for ok, jj in zip(near, j)], np.int64)
    eye_q = np.array([1.0, 0, 0, 0], dtype)
    fb = _bank_blocks(own, n_blocks, len(i), {
        "f_il": ((i - own * nb).astype(np.int32), 0),
        "f_jext": (jext.astype(np.int32), 0),
        "f_jsep": (jsep.astype(np.int32), 0),
        "f_use_sep": ((~near).astype(dtype), 0.0),
        "f_dq": (_host(between.dq).astype(dtype), eye_q),
        "f_dp": (_host(between.dp).astype(dtype), 0.0),
        "f_sqrt_info": (_host(between.sqrt_info).astype(dtype), 0.0),
    })
    if priors is not None:
        pi = _host(priors.i).astype(np.int64)
        pown = pi // nb
        pr = _bank_blocks(pown, n_blocks, len(pi), {
            "pr_il": ((pi - pown * nb).astype(np.int32), 0),
            "pr_q": (_host(priors.q).astype(dtype), eye_q),
            "pr_p": (_host(priors.p).astype(dtype), 0.0),
            "pr_sqrt_info": (_host(priors.sqrt_info).astype(dtype), 0.0),
        })
    else:
        pr = _bank_blocks(np.zeros(0, np.int64), n_blocks, 0, {
            "pr_il": (np.zeros(0, np.int32), 0),
            "pr_q": (np.zeros((0, 4), dtype), eye_q),
            "pr_p": (np.zeros((0, 3), dtype), 0.0),
            "pr_sqrt_info": (np.zeros((0, 6), dtype), 0.0),
        })

    def t(x):
        return torch.as_tensor(x, device=device)

    return BlockPoseGraph(
        q=t(qp.reshape(n_blocks, nb, 4)), p=t(pp.reshape(n_blocks, nb, 3)),
        free=t(fp.reshape(n_blocks, nb)),
        **{k: t(v) for k, v in fb.items()}, **{k: t(v) for k, v in pr.items()},
        sep_block=t(sep_block), sep_local=t(sep_local), sep_mask=t(sep_mask),
    )


def _ring(axis: Axis):
    fwd = [(k, (k + 1) % axis.size) for k in range(axis.size)]
    bwd = [(k, (k - 1) % axis.size) for k in range(axis.size)]
    return fwd, bwd


def _halo_exchange(x, axis: Axis):
    """[prev | own | next] along the block ring: x (Nb, ...) -> (3Nb, ...).
    The wrap-around slots are only addressed by factors that cross that
    boundary; the partitioner never emits those for the end blocks."""
    fwd, bwd = _ring(axis)
    prev = axis.ppermute(x, fwd)  # from block b-1
    nxt = axis.ppermute(x, bwd)  # from block b+1
    return torch.cat([prev, x, nxt])


def _halo_return(ext, axis: Axis):
    """Transpose of :func:`_halo_exchange`: route the prev/next thirds of
    an extended accumulator back to their owners and add. (3Nb, ...) ->
    (Nb, ...)."""
    nb = ext.shape[0] // 3
    fwd, bwd = _ring(axis)
    from_next = axis.ppermute(ext[:nb], bwd)
    from_prev = axis.ppermute(ext[2 * nb:], fwd)
    return ext[nb:2 * nb] + from_prev + from_next


def _mine(g: BlockPoseGraph, axis: Axis, dtype):
    return (g.sep_block == axis.index).to(dtype) * g.sep_mask


def _sep_gather(x, g: BlockPoseGraph, axis: Axis):
    """Replicated separator table (S, C) from per-rank block data x
    (Nb, C)."""
    vals = x[g.sep_local.long()] * _mine(g, axis, x.dtype)[:, None]
    return axis.psum(vals)


def _sep_return(acc, g: BlockPoseGraph, nb: int, axis: Axis):
    """Transpose of :func:`_sep_gather`: psum the (S, C) accumulator and
    scatter-add this rank's separators' rows into an (Nb, C) block."""
    total = axis.psum(acc) * _mine(g, axis, acc.dtype)[:, None]
    return acc.new_zeros((nb, acc.shape[-1])).index_add_(
        0, g.sep_local.long(), total)


def _scatter_add(n, idx, vals):
    return vals.new_zeros((n,) + vals.shape[1:]).index_add_(
        0, idx.long(), vals)


def _solve_block(g: BlockPoseGraph, cfg: PoseGraphConfig, axis: Axis):
    """GN + block-Jacobi PCG on this rank's block ``g`` (leading block
    axis consumed). Returns (q, p, cost trace)."""
    nb = g.q.shape[0]
    dtype = g.p.dtype
    eye6 = torch.eye(6, dtype=dtype, device=g.p.device)
    fmask = g.free[:, None]
    w = g.f_sqrt_info  # zero rows silence padded slots entirely
    use = g.f_use_sep[:, None]
    il, jext, jsep, pril = (x.long() for x in (g.f_il, g.f_jext, g.f_jsep,
                                               g.pr_il))
    S = g.sep_mask.shape[0]

    def resolve_j(ext_q, ext_p, sep_q, sep_p):
        return (torch.where(use > 0, sep_q[jsep], ext_q[jext]),
                torch.where(use > 0, sep_p[jsep], ext_p[jext]))

    def neighbours(q, p):
        return resolve_j(_halo_exchange(q, axis), _halo_exchange(p, axis),
                         _sep_gather(q, g, axis), _sep_gather(p, g, axis))

    def scatter_j(t):  # (Fb, C) at the j endpoints -> halo + separators
        ext = _scatter_add(3 * nb, jext, t * (1.0 - g.f_use_sep)[:, None])
        acc = _scatter_add(S, jsep, t * use)
        return _halo_return(ext, axis) + _sep_return(acc, g, nb, axis)

    def gn_step(q, p):
        qi, pi = q[il], p[il]
        qj, pj = neighbours(q, p)

        def res(xi_i, xi_j):
            return _between_residual(
                so3.quat_boxplus(qi, xi_i[:, 0:3]), pi + xi_i[:, 3:6],
                so3.quat_boxplus(qj, xi_j[:, 0:3]), pj + xi_j[:, 3:6],
                g.f_dq, g.f_dp, w)

        r_b, Ji, Jj = _bank_jacobians(res, il.shape[0], 2, p)
        pq, ppos = q[pril], p[pril]

        def resp(xi):
            return _prior_residual(
                so3.quat_boxplus(pq, xi[:, 0:3]), ppos + xi[:, 3:6],
                g.pr_q, g.pr_p, g.pr_sqrt_info)

        r_p, Jp = _bank_jacobians(resp, pril.shape[0], 1, p)

        def scatter_i(y):  # (Fb, 6) J_i^T y -> local poses
            return _scatter_add(nb, il, torch.einsum("fab,fa->fb", Ji, y))

        grad = scatter_i(r_b) + scatter_j(
            torch.einsum("fab,fa->fb", Jj, r_b))
        grad = grad + _scatter_add(nb, pril,
                                   torch.einsum("fab,fa->fb", Jp, r_p))

        # block-Jacobi preconditioner: J_i^T J_i at i, J_j^T J_j at j
        Dblk = _scatter_add(nb, il, torch.einsum("fab,fac->fbc", Ji, Ji))
        Dblk = Dblk + scatter_j(
            torch.einsum("fab,fac->fbc", Jj, Jj).reshape(-1, 36)
        ).reshape(nb, 6, 6)
        Dblk = Dblk + _scatter_add(nb, pril,
                                   torch.einsum("fab,fac->fbc", Jp, Jp))
        Dblk = Dblk + (cfg.damping + 1e-10) * eye6
        Dblk = torch.where((g.free > 0)[:, None, None], Dblk, eye6)
        Pinv = torch.linalg.inv_ex(Dblk).inverse

        def Hv(v):
            v = v * fmask
            ext_v = _halo_exchange(v, axis)
            sep_v = _sep_gather(v, g, axis)
            vj = torch.where(use > 0, sep_v[jsep], ext_v[jext])
            y = torch.einsum("fab,fb->fa", Ji, v[il]) \
                + torch.einsum("fab,fb->fa", Jj, vj)
            out = scatter_i(y) + scatter_j(torch.einsum("fab,fa->fb", Jj, y))
            yp = torch.einsum("fab,fb->fa", Jp, v[pril])
            out = out + _scatter_add(nb, pril,
                                     torch.einsum("fab,fa->fb", Jp, yp))
            return (out + cfg.damping * v) * fmask

        def apply_P(v):
            return torch.einsum("nij,nj->ni", Pinv, v * fmask) * fmask

        def dot(a, b):  # global inner product
            return axis.psum(torch.sum(a * b))

        b = -grad * fmask
        x = torch.zeros_like(b)
        r = b
        z = apply_P(r)
        pdir = z
        rz = dot(r, z)
        rr = dot(b, b)
        thresh = (cfg.cg_tol ** 2) * rr
        for _ in range(cfg.cg_max_iters):
            live = rr > thresh
            Hp = Hv(pdir)
            denom = dot(pdir, Hp)
            alpha = torch.where(
                live, rz / torch.where(denom == 0, 1.0, denom), 0.0)
            x = x + alpha * pdir
            r = r - alpha * Hp
            z_new = apply_P(r)
            rz_new = dot(r, z_new)
            rr = dot(r, r)
            beta = torch.where(live, rz_new / torch.where(rz == 0, 1.0, rz),
                               0.0)
            pdir = z_new + beta * pdir
            rz = torch.where(live, rz_new, rz)
        dx = x * fmask
        q_new = so3.quat_boxplus(q, dx[:, 0:3])
        p_new = p + dx[:, 3:6]

        # cost at the new state (psum of local factor costs)
        qj2, pj2 = neighbours(q_new, p_new)
        r2 = _between_residual(q_new[il], p_new[il], qj2, pj2, g.f_dq,
                               g.f_dp, w)
        rp2 = _prior_residual(q_new[pril], p_new[pril], g.pr_q, g.pr_p,
                              g.pr_sqrt_info)
        cost = axis.psum(0.5 * (torch.sum(r2 * r2) + torch.sum(rp2 * rp2)))
        return q_new, p_new, cost

    q, p = g.q, g.p
    trace = []
    for _ in range(cfg.max_iterations):
        q, p, cost = gn_step(q, p)
        trace.append(cost)
    return q, p, torch.stack(trace)


@f32_matmuls
def solve_pose_graph_blocks(g: BlockPoseGraph, mesh: Mesh,
                            cfg: PoseGraphConfig = PoseGraphConfig(),
                            axis_name: str = "sp"):
    """GN + PCG over the partitioned graph, one block per rank of the 1-D
    mesh's ``axis_name`` (e.g. ``flatten_mesh(make_mesh(), "sp")``).

    Every rank passes the same ``g`` and solves its own block on
    ``mesh.device``; the blocks all_gather at the end. Returns block-shaped
    (q (B, Nb, 4), p (B, Nb, 3), info) with the values (to float rounding)
    of ``optim.pose_graph.solve_pose_graph`` on the unpartitioned problem,
    the same on every rank.

    The number of blocks must equal the mesh's rank count: halo neighbours
    are rank-adjacent, and more blocks than ranks would drop trajectory."""
    n_blocks = g.q.shape[0]
    if n_blocks != mesh.size:
        raise ValueError(
            f"graph has {n_blocks} blocks but mesh has {mesh.size} ranks; "
            "partition_pose_graph(n_blocks=...) must match the mesh size "
            "(one block per rank: halo neighbours are rank-adjacent)")
    axis = mesh.axis(axis_name)
    me = axis.index
    shared = ("sep_block", "sep_local", "sep_mask")
    local = BlockPoseGraph(*(
        (x if name in shared else x[me]).to(mesh.device)
        for name, x in zip(BlockPoseGraph._fields, g)))
    q, p, trace = _solve_block(local, cfg, axis)
    return (axis.all_gather(q[None]), axis.all_gather(p[None]),
            {"cost_trace": trace, "final_cost": trace[-1]})


def unpartition(q_blocks, p_blocks, n: int):
    """Block-shaped (B, Nb, ...) -> flat (n, ...) trajectory."""
    q = q_blocks.reshape(-1, q_blocks.shape[-1])[:n]
    p = p_blocks.reshape(-1, p_blocks.shape[-1])[:n]
    return q, p
