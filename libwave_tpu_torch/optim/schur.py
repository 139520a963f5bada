"""Schur-complement elimination of landmarks + preconditioned CG.

Port of ``libwave_tpu.optim.schur``, the device-side analog of Ceres'
SPARSE_SCHUR with the SCHUR_JACOBI preconditioner:

- landmark blocks are eliminated with closed-form symmetric 3x3 inverses;
- the reduced camera system ``S dx_p = b̃`` is solved by PCG, either
  matrix-free (two sweeps over the observation bank per matvec) or against
  an explicit S built once per LM iteration (``dense_reduced_system``,
  whose G/A build is the CUDA kernel of ``ops.segmm`` on the card);
- the preconditioner is the block diagonal of S.

Layouts follow the reference: per-observation blocks are component-major
(``W`` is ``(D*3, ...)``, landmark blocks are 6 symmetric components
``(6, M)``), and observations sit in pose-ELL order (``Pmax`` padded slots
per pose, zero weight on padding) so pose-side reductions are dense sums
over the slot axis. The landmark-side crossings are the segment kernels of
``ops.segmm`` on the card (their plain versions on the CPU): the reduce
runs over a precomputed landmark-sorted slot list with CSR offsets
(:class:`EllLayout`), the broadcast is a gather by landmark id. The
reference's log-shift scan (``libwave_tpu.optim.schur.ell_seg_reduce``)
computes the same sums in another order.

Host-side layout functions (:func:`pack_observations`, :func:`build_ell_layout`,
:func:`compute_band_plan`) are numpy and return tensors on the requested
device (the card unless ``device="cpu"``). Loops have a fixed trip count and mask with ``torch.where``: no
device-to-host synchronization happens inside :func:`pcg`.

Sharded blocks (``axis_name``, a :class:`libwave_tpu_torch.parallel.mesh.Axis`):
each rank holds its own observation bank and every pose- and landmark-side
quantity (Hpp, bp, bl, Hll_inv, the CG vectors) replicated. Pose-ELL: the
bank covers a contiguous block of ``N / axis.size`` poses; landmark-side
sums psum over the axis, the local pose block all_gathers. Flat (the
port's counterpart of the reference's GSPMD step, which has no PyTorch
form): the bank is any slice of a pose-sorted flat bank with global pose
ids, and both sides psum. Flat with landmark chunks (``axis_name`` a
:class:`libwave_tpu_torch.parallel.mesh.Sharding`): the rank's bank holds
only observations of its chunk of landmark rows, with chunk-local ids, and
every landmark-side quantity is the chunk's; landmark-side sums psum over
the ranks of that chunk (``lm``), pose-side sums over every rank
(``pose``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as onp
import torch

from libwave_tpu_torch.ops import segmm
from libwave_tpu_torch.ops.segmm import (
    EllLayout,
    dense_g_a_window,
    project as _project,
    sym3_matvec,
    w_apply as _w_apply,
    w_t_apply as _w_t_apply,
)
from libwave_tpu_torch.utils.device import resolve
from libwave_tpu_torch.utils.precision import f32_matmuls
from libwave_tpu_torch.utils.trace import count, span


def _host(x):
    """numpy view of a tensor or array-like (host-side layout code)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return onp.asarray(x)


def _segment_sum(vals, idx, num_segments):
    """Sums of ``vals`` (C, K) over ids ``idx`` (K,) into (C, num_segments);
    duplicate ids accumulate."""
    out = vals.new_zeros(vals.shape[:-1] + (num_segments,))
    return out.index_add_(vals.dim() - 1, idx, vals)


def _segment_sum0(vals, idx, num_segments):
    """Sums of ``vals`` (F, ...) over ids ``idx`` (F,) into (num_segments, ...)."""
    out = vals.new_zeros((num_segments,) + vals.shape[1:])
    return out.index_add_(0, idx, vals)


def _einsum(eq, *ops):
    """einsum with the operands promoted to one dtype, as jnp.einsum does."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def pack_observations(pose_idx, lm_idx, num_poses, num_landmarks, *arrays,
                      min_pmax=1, device=None):
    """Host-side: reorder + pad an observation bank into pose-ELL order.

    Pads each pose's observations to the common Pmax (rectangular bank,
    ``K_ell = num_poses * Pmax``); padding rows MUST be masked by the caller
    with zero weights — the returned ``pad_mask`` is 1.0 on real rows.
    ``arrays`` are per-observation arrays (K, ...) to reorder+pad with zeros.

    Returns ``(pose_idx, lm_idx, pad_mask, ell_layout, *packed_arrays)`` as
    tensors on ``device`` (default: the card), dtypes as given (indices
    int32). The layout's landmark segments hold the real slots only: padding
    carries zero weight, so leaving it out changes no sum.

    Spanned as ``schur.pack_observations`` (host work and the copies to
    ``device``); adds the bank's slots and its padded slots to the
    counters ``schur.ell_slots`` and ``schur.ell_padding_slots``.
    """
    with span("schur.pack_observations"):
        device = resolve(device)
        pose_idx = _host(pose_idx)
        lm_idx = _host(lm_idx)
        counts = onp.bincount(pose_idx, minlength=num_poses)
        Pmax = max(int(counts.max()), min_pmax)
        K_ell = num_poses * Pmax

        # slot index of every original observation
        order = onp.argsort(pose_idx, kind="stable")
        slot = onp.full(K_ell, -1, dtype=onp.int64)  # -> original obs or -1
        pos = 0
        for n in range(num_poses):
            c = int(counts[n])
            slot[n * Pmax:n * Pmax + c] = order[pos:pos + c]
            pos += c
        count("schur.ell_slots", K_ell)
        count("schur.ell_padding_slots", K_ell - pos)
        pad_mask = (slot >= 0).astype(onp.float64)
        safe = onp.where(slot >= 0, slot, 0)

        if lm_idx.shape[0] == 0:
            lm_ell = onp.zeros(K_ell, dtype=onp.int32)
        else:
            lm_ell = onp.where(slot >= 0, lm_idx[safe], 0).astype(onp.int32)
        pose_ell = onp.repeat(onp.arange(num_poses, dtype=onp.int32), Pmax)

        packed = []
        for a in arrays:
            a = _host(a)
            if a.shape[0] == 0:
                out = onp.zeros((K_ell,) + a.shape[1:], dtype=a.dtype)
            else:
                out = a[safe] * pad_mask.reshape(
                    (K_ell,) + (1,) * (a.ndim - 1)
                ).astype(a.dtype)
            packed.append(torch.as_tensor(out, device=device))

        ell = build_ell_layout(lm_ell, num_landmarks, valid=slot >= 0,
                               device=device)
        return (
            torch.as_tensor(pose_ell, device=device),
            torch.as_tensor(lm_ell, device=device),
            torch.as_tensor(pad_mask, device=device),
            ell,
            *packed,
        )


def build_ell_layout(lm_idx, num_landmarks, valid=None,
                     device=None) -> EllLayout:
    """Host-side landmark-reduce machinery for an observation bank: the
    slots sorted by landmark (stable) and the CSR bounds of every landmark
    in that order. Slots where ``valid`` is False (ELL padding) are sorted
    after every landmark and belong to no segment; by default every slot
    counts. Tensors on ``device`` (default: the card). Spanned as
    ``schur.build_ell_layout``."""
    with span("schur.build_ell_layout"):
        lm_idx = _host(lm_idx).astype(onp.int64)
        key = lm_idx if valid is None else onp.where(
            _host(valid), lm_idx, num_landmarks)
        sigma = onp.argsort(key, kind="stable").astype(onp.int32)
        offsets = onp.searchsorted(key[sigma], onp.arange(num_landmarks + 1))
        device = resolve(device)
        return EllLayout(
            sigma=torch.as_tensor(sigma, device=device),
            offsets=torch.as_tensor(offsets.astype(onp.int32), device=device),
        )


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """Covisibility-band metadata for the explicit-S build (host data).

    ``entries`` is a tuple of ``(c0, c1, ((plo, phi), ...))``: landmark
    column range [c0, c1) is observed only by poses inside the listed
    contiguous ranges. Built by :func:`compute_band_plan`.
    """

    entries: tuple


def compute_band_plan(lm_ell, pad_mask, num_poses: int, num_landmarks: int,
                      chunk_cols: int = 1024, max_ranges: int = 4,
                      gap_tol: int = 4) -> BandPlan:
    """Host-side: partition landmark columns into ``chunk_cols``-wide
    ranges and record, per range, the contiguous pose runs that observe
    it. Runs separated by <= ``gap_tol`` poses merge; if more than
    ``max_ranges`` runs remain, the smallest gaps merge first. With no
    locality this degenerates to one full-range entry per chunk."""
    lm = _host(lm_ell).reshape(num_poses, -1)
    valid = _host(pad_mask).reshape(num_poses, -1) > 0
    entries = []
    for c0 in range(0, num_landmarks, chunk_cols):
        c1 = min(c0 + chunk_cols, num_landmarks)
        hits = ((lm >= c0) & (lm < c1) & valid).any(axis=1)
        poses = onp.nonzero(hits)[0]
        if poses.size == 0:
            continue
        breaks = onp.nonzero(onp.diff(poses) > gap_tol + 1)[0]
        runs = []
        start = 0
        for b in breaks:
            runs.append((int(poses[start]), int(poses[b]) + 1))
            start = b + 1
        runs.append((int(poses[start]), int(poses[-1]) + 1))
        while len(runs) > max_ranges:
            gaps = [runs[i + 1][0] - runs[i][1] for i in range(len(runs) - 1)]
            i = int(onp.argmin(gaps))
            runs[i] = (runs[i][0], runs[i + 1][1])
            del runs[i + 1]
        entries.append((c0, c1, tuple(runs)))
    return BandPlan(entries=tuple(entries))


def ell_seg_reduce(vals, ell: EllLayout):
    """Per-landmark sums of ``vals`` (C, K) over the layout's sorted slot
    lists: the reduce kernel of ``ops.segmm`` on the card, its plain
    version on the CPU. Deterministic. Returns (C, M)."""
    return segmm.seg_reduce_sorted(vals, ell.sigma, ell.offsets)


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant) for
    block-layout ``(..., 3, 3)`` inputs."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, 1.0, det)
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], dim=-1),
            torch.stack([A21, A22, A23], dim=-1),
            torch.stack([A31, A32, A33], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


# Symmetric-3x3 component order: [00, 01, 02, 11, 12, 22].
_SYM3 = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
_SYM3_AT = {  # (i, j) -> component index, both triangles
    (0, 0): 0, (0, 1): 1, (0, 2): 2,
    (1, 0): 1, (1, 1): 3, (1, 2): 4,
    (2, 0): 2, (2, 1): 4, (2, 2): 5,
}


def sym3_inv(s):
    """Inverse of symmetric 3x3 in component form: s, out are (6, ...)."""
    a, b, c, d, e, f = s[0], s[1], s[2], s[3], s[4], s[5]
    A11 = d * f - e * e
    A12 = c * e - b * f
    A13 = b * e - c * d
    A22 = a * f - c * c
    A23 = b * c - a * e
    A33 = a * d - b * b
    det = a * A11 + b * A12 + c * A13
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, 1.0, det)
    return torch.stack([A11, A12, A13, A22, A23, A33]) * inv_det


def _cholesky_or_nan(A):
    """Cholesky factor, NaN where a block is not positive definite (as
    jnp.linalg.cholesky); no device-to-host synchronization."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def cho_inverse(A: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse via Cholesky triangular solves (for the (N, D, D)
    preconditioner blocks)."""
    L = _cholesky_or_nan(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape
    )
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.mT @ Linv


def _tri_indices(D):
    """Upper-triangle (i, j) pairs for a DxD symmetric block."""
    return [(i, j) for i in range(D) for j in range(i, D)]


def _assemble_sym(comps, D):
    """(T, N) upper-triangle components -> (N, D, D) symmetric blocks."""
    rows = [[None] * D for _ in range(D)]
    for c, (i, j) in zip(comps, _tri_indices(D)):
        rows[i][j] = c
        rows[j][i] = c
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _embed_block(H, D):
    """Zero-pad (N, Dj, Dj) blocks into the top-left of (N, D, D)."""
    Dj = H.shape[-1]
    if Dj == D:
        return H
    return torch.nn.functional.pad(H, (0, D - Dj, 0, D - Dj))


def _pad_cols(x, D):
    """Zero-pad (N, Dj) tangent data up to (N, D)."""
    if x.shape[-1] == D:
        return x
    return torch.nn.functional.pad(x, (0, D - x.shape[-1]))


class SchurBlocks(NamedTuple):
    """Normal-equation blocks for a BA-structured problem (component-major).

    Two observation layouts share this container, distinguished by
    ``W.dim()``:
    - pose-ELL: W is (D*3, N, Pmax), ``ell`` holds the landmark-reduction
      machinery, pose reductions are dense sums;
    - flat: W is (D*3, K), reductions are segment sums over ``pose_idx`` /
      sorted ``lm_idx``.

    ``C/ci/cj`` hold pose-pose off-diagonal couplings from pose-graph
    factors: H[ci, cj] += C, H[cj, ci] += C^T (empty banks are zero-length).

    ``axis_name`` (an ``Axis``, a ``Sharding`` or None): sharded blocks
    (see the module docstring); W, pose_idx, lm_idx and lm_order are this
    rank's bank, the rest global and replicated (under a ``Sharding`` the
    landmark-side Hll_inv and bl are the rank's chunk's), pose-graph
    couplings evaluated on every rank.
    """

    Hpp: torch.Tensor  # (N, D, D) pose diagonal blocks (damped)
    Hll_inv: torch.Tensor  # (6, M) inverted landmark blocks, sym components
    W: torch.Tensor  # (D*3, N, Pmax) [ELL] or (D*3, K) [flat]
    bp: torch.Tensor  # (N, D)
    bl: torch.Tensor  # (3, M)
    pose_idx: torch.Tensor  # (K,) — non-decreasing (obs sorted by pose)
    lm_idx: torch.Tensor  # (K,)
    lm_order: EllLayout  # slots sorted by landmark: ``ell``, or the flat bank's
    free_pose: torch.Tensor  # (N,) or (N, D): 1.0 free, 0.0 gauge-fixed
    ell: object  # EllLayout | None
    C: torch.Tensor  # (F, D, D) pose-pose cross blocks
    ci: torch.Tensor  # (F,)
    cj: torch.Tensor  # (F,)
    axis_name: object = None  # Axis | Sharding | None: sharded blocks


class Window(NamedTuple):
    """One window of a disjoint union of equal pose-ELL problems (the
    batched BA solve): its poses ``[plo, phi)``, landmarks ``[c0, c1)`` and
    pose-pose coupling rows ``[f0, f1)`` in the union's blocks."""

    plo: int
    phi: int
    c0: int
    c1: int
    f0: int
    f1: int


def window_blocks(blocks: SchurBlocks, w: Window,
                  layout: EllLayout) -> SchurBlocks:
    """The blocks of window ``w`` of a disjoint union, in the window's own
    pose, landmark and slot numbering (views where they can be, copies of
    the few operands a kernel reads whole); ``layout`` is the window's
    landmark-sorted layout of its own slots. Everything downstream (the
    dense Schur solve, PCG, the G/A build) then runs on the window as on a
    problem of its own."""
    plo, phi, c0, c1, f0, f1 = w
    P = blocks.W.shape[2]
    return blocks._replace(
        Hpp=blocks.Hpp[plo:phi],
        Hll_inv=blocks.Hll_inv[:, c0:c1].contiguous(),
        W=blocks.W[:, plo:phi],
        bp=blocks.bp[plo:phi],
        bl=blocks.bl[:, c0:c1],
        pose_idx=blocks.pose_idx[:(phi - plo) * P],
        lm_idx=blocks.lm_idx[plo * P:phi * P] - c0,
        lm_order=layout,
        free_pose=blocks.free_pose[plo:phi],
        ell=layout,
        C=blocks.C[f0:f1],
        ci=blocks.ci[f0:f1] - plo,
        cj=blocks.cj[f0:f1] - plo,
    )


def _psum(x, axis):
    return x if axis is None else axis.psum(x)


def pose_axis(axis):
    """The axis that pose-side sums and the cost reduce over: ``axis``
    itself (an ``Axis`` or None), or a ``Sharding``'s ``pose``."""
    return getattr(axis, "pose", axis)


def _lm_axis(axis):
    """The axis that landmark-side sums reduce over (a ``Sharding``'s
    ``lm``: the ranks that hold the same landmark chunk)."""
    return getattr(axis, "lm", axis)


def _lm_sums(vals, lm_order, axis):
    """Reduce (C, K)/(C, N, Pmax) by landmark into (C, M). Sharded: each
    rank reduces its bank (the reduce kernel), the partials psum over the
    landmark axis."""
    out = ell_seg_reduce(vals.reshape(vals.shape[0], -1), lm_order)
    return _psum(out, _lm_axis(axis))


def _pose_sums(vals, ell, pose_idx, num_poses, axis):
    """Reduce by pose into (C, N): dense slot sum (ELL) or segment sum.
    Sharded: the local (C, Nb) ELL block all_gathers; flat partials psum
    (over every rank)."""
    axis = pose_axis(axis)
    if ell is not None:
        nb = num_poses if axis is None else num_poses // axis.size
        out = torch.sum(vals.reshape(vals.shape[0], nb, -1), dim=-1)
        return out if axis is None else axis.all_gather(out, dim=1)
    return _psum(_segment_sum(vals, pose_idx, num_poses), axis)


def _seg_lm(blocks: SchurBlocks, vals):
    return _lm_sums(vals, blocks.lm_order, blocks.axis_name)


def _seg_pose(blocks: SchurBlocks, vals):
    return _pose_sums(vals, blocks.ell, blocks.pose_idx, blocks.bp.shape[0],
                      blocks.axis_name)


def build_normal_equations(
    r, J_pose, J_lm, weights, pose_idx, lm_idx, num_poses, num_landmarks,
    damping, free_pose,
    extra_Hpp=None, extra_bp=None, couplings=None,
    ell: EllLayout | None = None, pose_dim: int | None = None,
    axis_name=None, sum_dtype=None, lm_damping=None,
) -> SchurBlocks:
    """Assemble damped normal-equation blocks from a linearized observation
    bank.

    Accepts three input layouts:
      - pose-ELL component-major (requires ``ell``): r (2, N, Pmax),
        J_pose (2, D, N, Pmax), J_lm (2, 3, N, Pmax), weights (N, Pmax);
      - flat component-major: r (2, K), J_pose (2, D, K), J_lm (2, 3, K);
      - flat block layout (converted): r (K, 2), J_pose (K, 2, D),
        J_lm (K, 2, 3).

    ``weights`` fold in validity masks, padding masks and robust-loss
    weights. ``damping`` is the LM lambda; diagonals are damped
    multiplicatively (Marquardt scaling) with an additive floor. It may
    also be a tensor that broadcasts against the (N, D) pose diagonals, and
    ``lm_damping`` one against the (M,) landmark components (a disjoint
    union of windows, each with its own lambda); ``lm_damping`` defaults
    to ``damping``.

    ``pose_dim``: full tangent dimension D of the pose blocks when the
    observation Jacobian only touches the first ``J_pose.shape[1]`` of them
    (structural zeros are never materialized).

    ``sum_dtype`` (mixed-precision stiff-Hessian path, dense solver only):
    cast the pose-block sums ``Hpp``/``bp``/``C`` to this dtype (float64)
    before folding in ``extra_Hpp``/``extra_bp``, so large pose-graph
    information does not annihilate the vision terms in f32.

    ``axis_name`` (a ``parallel.mesh.Axis``): the inputs are this rank's
    bank; with ``ell`` a contiguous block of ``num_poses / axis.size``
    poses whose pose-side sums all_gather, flat a slice of the bank with
    global pose ids whose pose-side sums psum; landmark-side sums psum. A
    ``parallel.mesh.Sharding`` (flat only): ``lm_idx`` and
    ``num_landmarks`` are the rank's chunk's, the landmark-side sums psum
    over its ``lm`` axis and the pose-side sums over its ``pose`` axis.
    ``extra_Hpp``/``extra_bp``/``couplings`` and ``free_pose`` are global
    and replicated, added once after the collectives.
    """
    K = pose_idx.shape[0]
    if r.dim() == 2 and r.shape[0] == K and J_pose.shape[0] == K:
        # block layout -> flat component-major
        r = r.T  # (2, K)
        J_pose = J_pose.movedim(0, -1)  # (2, Dj, K)
        J_lm = J_lm.movedim(0, -1)  # (2, 3, K)
    Dj = J_pose.shape[1]  # tangent dims touched by observations
    D = pose_dim if pose_dim is not None else Dj
    dtype = r.dtype

    # the landmark-side reduce's slot order: the ELL layout's (host-built),
    # or the flat bank's, sorted on the device
    lm_order = ell if ell is not None else segmm.sorted_layout(
        lm_idx, num_landmarks)

    w = weights
    wJp = J_pose * w  # (2, Dj, ...)

    # W[i*3+j] = sum_a Jp[a, i] w Jl[a, j]  (only the Dj touched rows)
    W = torch.stack(
        [
            wJp[0, i] * J_lm[0, j] + wJp[1, i] * J_lm[1, j]
            for i in range(Dj)
            for j in range(3)
        ]
    )  # (Dj*3, ...)

    tri_p = _tri_indices(Dj)
    Hpp_k = torch.stack(
        [wJp[0, i] * J_pose[0, j] + wJp[1, i] * J_pose[1, j] for i, j in tri_p]
    )
    Hll_k = torch.stack(
        [
            w * (J_lm[0, i] * J_lm[0, j] + J_lm[1, i] * J_lm[1, j])
            for i, j in _SYM3
        ]
    )
    bp_k = -(wJp[0] * r[0] + wJp[1] * r[1])  # (Dj, ...)
    wJl = J_lm * w
    bl_k = -(wJl[0] * r[0] + wJl[1] * r[1])  # (3, ...)

    axis = axis_name

    def seg_pose(vals):
        return _pose_sums(vals, ell, pose_idx, num_poses, axis)

    Hpp = _embed_block(_assemble_sym(seg_pose(Hpp_k), Dj), D)  # (N, D, D)
    Hll = _lm_sums(Hll_k, lm_order, axis)  # (6, M)
    bp = _pad_cols(seg_pose(bp_k).T, D)  # (N, D)
    bl = _lm_sums(bl_k, lm_order, axis)  # (3, M)

    if ell is not None:
        nb = num_poses if axis is None else num_poses // pose_axis(axis).size
        W = W.reshape(Dj * 3, nb, -1)  # matvec broadcasting layout

    if sum_dtype is not None:
        Hpp = Hpp.to(sum_dtype)
        bp = bp.to(sum_dtype)
    if extra_Hpp is not None:
        Hpp = Hpp + extra_Hpp.to(Hpp.dtype)
    if extra_bp is not None:
        bp = bp + extra_bp.to(bp.dtype)

    # Additive damping floor: must sit well above the dtype's cancellation
    # noise or degenerate blocks (unobserved landmarks) make the Schur
    # complement numerically indefinite and Cholesky NaNs out.
    floor = 1e-6 if dtype == torch.float32 else 1e-10

    # Marquardt scaling on pose blocks: diag *= (1 + lambda) + floor.
    eye = torch.eye(D, dtype=Hpp.dtype, device=Hpp.device)
    diag = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hpp = Hpp + eye * (damping * diag + floor)[..., None, :]

    # Same damping on the landmark blocks, in component form (diagonal
    # components are 0, 3, 5). Built by rows, not with an index list, which
    # would copy the list to the device and synchronize.
    zero = torch.zeros_like(Hll[0])
    lm_damping = damping if lm_damping is None else lm_damping
    Hll_add = torch.stack(
        [lm_damping * Hll[i] + floor if i in (0, 3, 5) else zero
         for i in range(6)]
    )
    Hll_inv = sym3_inv(Hll + Hll_add)

    if couplings is None:
        C = torch.zeros((0, D, D), dtype=Hpp.dtype, device=Hpp.device)
        ci = torch.zeros((0,), dtype=torch.int32, device=Hpp.device)
        cj = torch.zeros((0,), dtype=torch.int32, device=Hpp.device)
    else:
        C, ci, cj = couplings
        C = C.to(Hpp.dtype)
    return SchurBlocks(
        Hpp=Hpp, Hll_inv=Hll_inv, W=W, bp=bp, bl=bl,
        pose_idx=pose_idx, lm_idx=lm_idx, lm_order=lm_order,
        free_pose=free_pose, ell=ell,
        C=C, ci=ci, cj=cj, axis_name=axis,
    )


def local_pose_block(x, num_poses: int, axis_name):
    """(x_local, nb): this rank's contiguous pose block of replicated
    (N, ...) data under sharded ELL blocks; identity when axis_name is
    None."""
    if axis_name is None:
        return x, num_poses
    axis_name = pose_axis(axis_name)
    nb = num_poses // axis_name.size
    lo = axis_name.index * nb
    return x[lo:lo + nb], nb


def _broadcast_pose(blocks: SchurBlocks, x):
    """Per-observation view of per-pose data x (N, D): a free broadcast
    (D, N, 1) on the ELL path, a gather on the flat path. Sharded ELL:
    this rank's contiguous pose block of the replicated x."""
    if blocks.ell is not None:
        if blocks.axis_name is not None:
            x, _ = local_pose_block(x, x.shape[0], blocks.axis_name)
        return x.T[:, :, None]  # (D, Nb, 1) broadcasts over Pmax
    return x.T[:, blocks.pose_idx]  # (D, K)


def _gather_lm(blocks: SchurBlocks, y):
    """Per-observation view of per-landmark data y (3, M): the broadcast
    kernel of ``ops.segmm`` on the card."""
    yk = segmm.seg_broadcast(y, blocks.lm_idx)  # (3, K)
    if blocks.ell is not None:
        return yk.reshape((3,) + tuple(blocks.W.shape[1:]))  # (3, N, Pmax)
    return yk


def _add_couplings(blocks: SchurBlocks, out, x):
    """``out`` plus the pose-pose couplings' products with the projected
    ``x``: C x_j into row i, C^T x_i into row j."""
    cx_j = _einsum("fij,fj->fi", blocks.C, x[blocks.cj])  # (F, D)
    cx_i = _einsum("fji,fj->fi", blocks.C, x[blocks.ci])  # C^T x_i
    out = out + _segment_sum0(cx_j, blocks.ci, x.shape[0])
    return out + _segment_sum0(cx_i, blocks.cj, x.shape[0])


def _takes_fused_matvec(blocks: SchurBlocks, x) -> bool:
    """Whether :func:`schur_matvec` runs as the four kernels of
    :func:`_fused_matvec`: unsharded pose-ELL blocks whose operands
    ``ops.segmm.takes_matvec`` accepts (on the card, float32, W touching 6
    pose coordinates: 18 rows). Elsewhere (the CPU, the flat layout, sharded
    blocks, f64 or widened pose sums) it runs the composition of PyTorch
    operations."""
    return (blocks.ell is not None and blocks.axis_name is None
            and segmm.takes_matvec(blocks.W, x, blocks.free_pose,
                                   blocks.Hpp, blocks.Hll_inv))


def _fused_matvec(blocks: SchurBlocks, x: torch.Tensor) -> torch.Tensor:
    """S x in four launches of ``ops.segmm``'s kernels: ``W^T x`` per slot
    (the projection folded in), the landmark reduce, the ``Hll^-1`` step,
    and the pose side (gather, W y, slot sums, ``Hpp x``, projection); the
    pose-pose couplings then in PyTorch, as in :func:`schur_matvec`. On CPU
    blocks the wrappers run their plain versions: the same numbers as
    :func:`schur_matvec`'s composition, bit for bit."""
    x = x.contiguous()
    t = segmm.matvec_wt_slots(blocks.W, x, blocks.free_pose)  # (3, K)
    utx = ell_seg_reduce(t, blocks.lm_order)  # (3, M)
    y = segmm.matvec_landmark_step(blocks.Hll_inv, utx)  # (3, M)
    out = segmm.matvec_pose_side(blocks.W, blocks.lm_idx, y, blocks.Hpp, x,
                                 blocks.free_pose)  # (N, D), projected
    if blocks.C.shape[0] > 0:
        out = _project(_add_couplings(
            blocks, out, _project(x, blocks.free_pose)), blocks.free_pose)
    return out


def schur_matvec(blocks: SchurBlocks, x: torch.Tensor) -> torch.Tensor:
    """S x = Hpp x - U Hll^-1 U^T x, matrix-free. x: (N, D) -> (N, D).

    Unsharded f32 pose-ELL blocks on the card take :func:`_fused_matvec`
    (counted as ``schur.matvec_fused``); every other case
    :func:`_plain_matvec`."""
    if _takes_fused_matvec(blocks, x):
        count("schur.matvec_fused")
        return _fused_matvec(blocks, x)
    return _plain_matvec(blocks, x)


def _plain_matvec(blocks: SchurBlocks, x: torch.Tensor) -> torch.Tensor:
    """S x as a composition of PyTorch operations and the segment
    kernels, for every layout, dtype and sharding."""
    D = blocks.bp.shape[1]
    x = _project(x, blocks.free_pose)
    out = _einsum("nij,nj->ni", blocks.Hpp, x)
    # U^T x: per observation W_k^T x[pose_k], summed by landmark
    xk = _broadcast_pose(blocks, x)
    utx = _seg_lm(blocks, _w_t_apply(blocks.W, xk))  # (3, M)
    y = sym3_matvec(blocks.Hll_inv, utx)  # (3, M)
    # U y: per observation W_k y[lm_k], summed by pose
    yk = _gather_lm(blocks, y)
    uy = _seg_pose(blocks, _w_apply(blocks.W, yk))  # (Dj, N)
    out = out - _pad_cols(uy.T, D)
    # pose-pose couplings from pose-graph factors
    if blocks.C.shape[0] > 0:
        out = _add_couplings(blocks, out, x)
    return _project(out, blocks.free_pose)


def schur_rhs(blocks: SchurBlocks) -> torch.Tensor:
    """b̃ = bp - U Hll^-1 bl."""
    with span("schur.rhs"):
        D = blocks.bp.shape[1]
        y = sym3_matvec(blocks.Hll_inv, blocks.bl)  # (3, M)
        yk = _gather_lm(blocks, y)
        uy = _seg_pose(blocks, _w_apply(blocks.W, yk))  # (Dj, N)
        return _project(blocks.bp - _pad_cols(uy.T, D), blocks.free_pose)


def _schur_self_blocks(blocks: SchurBlocks) -> torch.Tensor:
    """Exact per-pose self terms ``sum_k W_k Hll_inv[lm_k] W_k^T`` as
    (N, Dj, Dj) blocks — one sweep over the observation bank."""
    W = blocks.W
    Dj = W.shape[0] // 3
    hk = segmm.seg_broadcast(blocks.Hll_inv, blocks.lm_idx)  # (6, K)
    if blocks.ell is not None:
        hk = hk.reshape((6,) + tuple(W.shape[1:]))
    # T[i, l] = sum_j W[i, j] Hinv[j, l]
    T = [
        [
            sum(W[i * 3 + j] * hk[_SYM3_AT[(j, l)]] for j in range(3))
            for l in range(3)
        ]
        for i in range(Dj)
    ]
    # self[i, i'] = sum_l T[i, l] W[i', l]
    self_k = torch.stack(
        [
            sum(T[i][l] * W[i2 * 3 + l] for l in range(3))
            for i, i2 in _tri_indices(Dj)
        ]
    )
    return _assemble_sym(_seg_pose(blocks, self_k), Dj)  # (N, Dj, Dj)


def _free_mask(blocks: SchurBlocks, N, D):
    """(N, D) 1.0/0.0 mask of free tangent coordinates."""
    if blocks.free_pose.dim() == 1:
        return blocks.free_pose[:, None].expand(N, D)
    return blocks.free_pose


def schur_jacobi_preconditioner(blocks: SchurBlocks) -> torch.Tensor:
    """Inverted block diagonal of S (the SCHUR_JACOBI preconditioner):
    P_i = (Hpp_i - sum_k W_k Hll_inv[lm_k] W_k^T)^{-1}, self-terms only."""
    D = blocks.bp.shape[1]
    sub = _embed_block(_schur_self_blocks(blocks), D)  # (N, D, D)
    S_diag = blocks.Hpp - sub
    # Gauge-fixed coordinates get identity rows/cols so CG stays
    # well-defined on their (projected-out) subspace.
    eye = torch.eye(D, dtype=S_diag.dtype, device=S_diag.device)
    m = _free_mask(blocks, S_diag.shape[0], D)
    S_diag = m[:, :, None] * S_diag * m[:, None, :]
    S_diag = S_diag + eye * (1.0 - m)[..., None, :] * eye
    # small diagonal lift for safety
    S_diag = S_diag + 1e-10 * eye
    return cho_inverse(S_diag)


def _sym3_full(s):
    """(6, M) symmetric components -> (M, 3, 3) full blocks."""
    return torch.stack(
        [
            torch.stack([s[0], s[1], s[2]], dim=-1),
            torch.stack([s[1], s[3], s[4]], dim=-1),
            torch.stack([s[2], s[4], s[5]], dim=-1),
        ],
        dim=-2,
    )


def _mm_f32(a, g):
    """``a @ g.T`` rounded to f32, the reference's f32 S_sub contract. Its
    callers run it under :func:`f32_matmuls`, so it is full f32 whatever
    TF32 setting the caller left."""
    return (a @ g.T).to(torch.float32)


@f32_matmuls
def dense_reduced_system(blocks: SchurBlocks,
                         max_g_bytes: float | None = None,
                         bands: BandPlan | None = None,
                         _force_path: str | None = None) -> torch.Tensor:
    """Materialize the reduced camera matrix S = Hpp - U Hll^-1 U^T plus
    pose-pose couplings as one dense (N, D, N, D) tensor.

    U rides in a dense (N*Dj, 3M) scatter G; the subtraction is one matmul
    A @ G^T with A = G Hll^-1. No gauge projection is applied.

    G/A path (pose-ELL blocks on a CUDA device): G and A come from
    :func:`libwave_tpu_torch.ops.segmm.dense_g_a_window`, the CUDA kernel,
    one launch per build call, each reading the full W, the ELL layout and
    Hll^-1 through its window bounds (no per-call copy), and ``S_sub``
    accumulates in f32. On the card W and Hll^-1 are cast to f32 once per
    call of this function (the kernel's f32 contract). ``bands`` (a
    :class:`BandPlan`) contracts only (pose-run x landmark-column-range)
    blocks, with static slice adds into ``S_sub`` and explicit cross blocks
    between the runs of one range. Without bands, ``max_g_bytes`` caps G:
    above it the build runs chunked over landmark column ranges and
    ``S_sub`` accumulates.

    Otherwise G is a plain scatter-add and ``S_sub`` stays in W's dtype.

    ``_force_path`` ("kernel" | "scatter", tests only) overrides the device
    gate so the banded and chunked code runs on CPU through the plain G/A.

    Single-device only: sharded blocks raise (S couples poses across
    ranks; the sharded solvers take PCG).
    """
    if blocks.axis_name is not None:
        raise ValueError("dense_reduced_system: the blocks are sharded "
                         "(axis_name); use PCG")
    D = blocks.bp.shape[1]
    N = blocks.Hpp.shape[0]
    M = blocks.bl.shape[-1]
    Dj = blocks.W.shape[0] // 3
    # S inherits the (possibly widened) pose-block dtype; the G/A work
    # stays in the observation bank's dtype.
    dtype = blocks.bp.dtype
    wdtype = blocks.W.dtype
    dev = blocks.W.device

    use_kernel = blocks.ell is not None and (
        _force_path == "kernel"
        or (_force_path is None and blocks.W.is_cuda)
    )
    if use_kernel:
        W, hinv = blocks.W, blocks.Hll_inv
        if W.is_cuda:
            W = W.to(torch.float32).contiguous()
            hinv = hinv.to(torch.float32).contiguous()

        def g_a(c0, c1, plo, phi):
            return dense_g_a_window(W, blocks.ell, hinv, c0, c1, plo, phi)

        g_bytes = blocks.W.element_size() * N * Dj * 3 * M
        S_sub = torch.zeros((N * Dj, N * Dj), dtype=torch.float32, device=dev)
        if bands is not None:
            for (c0, c1, ranges) in bands.entries:
                ga = []
                for (plo, phi) in ranges:
                    g3, a3 = g_a(c0, c1, plo, phi)
                    R = phi - plo
                    ga.append(
                        ((plo, phi), g3.reshape(R * Dj, -1),
                         a3.reshape(R * Dj, -1))
                    )
                for i, ((alo, ahi), Gi, Ai) in enumerate(ga):
                    for ((blo, bhi), Gj, _) in ga[i:]:
                        blk = _mm_f32(Ai, Gj)
                        S_sub[alo * Dj:ahi * Dj, blo * Dj:bhi * Dj] += blk
                        if (blo, bhi) != (alo, ahi):
                            S_sub[blo * Dj:bhi * Dj, alo * Dj:ahi * Dj] += (
                                blk.T
                            )
        elif max_g_bytes is not None and g_bytes > max_g_bytes:
            chunks = int(-(-g_bytes // max_g_bytes))
            CM = -(-M // chunks)
            for c in range(0, M, CM):
                cm = min(CM, M - c)
                g3, a3 = g_a(c, c + cm, 0, N)
                S_sub += _mm_f32(
                    a3.reshape(N * Dj, 3 * cm), g3.reshape(N * Dj, 3 * cm)
                )
        else:
            g3, a3 = g_a(0, M, 0, N)
            # rows are (dj, j)-ordered: the 2D flatten is transpose-free
            S_sub = _mm_f32(
                a3.reshape(N * Dj, 3 * M), g3.reshape(N * Dj, 3 * M)
            )
    else:
        if blocks.ell is not None:
            Pmax = blocks.W.shape[2]
            Wb = blocks.W.reshape(Dj, 3, N, Pmax).permute(2, 3, 0, 1)
            rows = torch.arange(N, device=dev)[:, None].expand(N, Pmax)
            cols = blocks.lm_idx.reshape(N, Pmax).long()
        else:
            K = blocks.lm_idx.shape[0]
            Wb = blocks.W.reshape(Dj, 3, K).permute(2, 0, 1)  # (K, Dj, 3)
            rows = blocks.pose_idx.long()
            cols = blocks.lm_idx.long()
        G4 = torch.zeros((N, M, Dj, 3), dtype=wdtype, device=dev)
        G4.index_put_((rows, cols), Wb, accumulate=True)
        G = G4.permute(0, 2, 1, 3).reshape(N * Dj, M * 3)
        Hinv = _sym3_full(blocks.Hll_inv)  # (M, 3, 3)
        A = _einsum(
            "amj,mjk->amk", G.reshape(N * Dj, M, 3), Hinv
        ).reshape(N * Dj, M * 3)
        S_sub = A @ G.T  # (N*Dj, N*Dj)

    # embed into the full system, built pose-pair-major (N, N, D, D) so the
    # block-diagonal and coupling adds are plain (accumulating) index puts
    S = torch.zeros((N, N, D, D), dtype=dtype, device=dev)
    S[:, :, :Dj, :Dj] -= S_sub.reshape(N, Dj, N, Dj).permute(0, 2, 1, 3).to(
        dtype
    )
    ar = torch.arange(N, device=dev)
    S[ar, ar] += blocks.Hpp
    if blocks.C.shape[0] > 0:
        ci, cj = blocks.ci.long(), blocks.cj.long()
        S.index_put_((ci, cj), blocks.C.to(dtype), accumulate=True)
        S.index_put_((cj, ci), blocks.C.mT.to(dtype), accumulate=True)
    return S.permute(0, 2, 1, 3).contiguous()  # (N, D, N, D)


def chol_solve_mixed(Se, rhs):
    """SPD solve ``Se X = rhs`` by an exact Cholesky in Se's dtype (the
    reference measured that f32 factorization + f64 refinement diverges on
    stiff windows). ``rhs`` is (n, k); returns (n, k) in Se's dtype. A
    matrix that is not positive definite gives NaN."""
    L = _cholesky_or_nan(Se)
    y = torch.linalg.solve_triangular(L, rhs.to(Se.dtype), upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


@f32_matmuls
def dense_schur_solve(blocks: SchurBlocks, b: torch.Tensor) -> torch.Tensor:
    """Explicit reduced camera system + dense Cholesky (Ceres DENSE_SCHUR
    analog). x: (N, D) solution of S x = b with gauge-fixed coordinates
    pinned. Both this and :func:`dense_reduced_system` turn TF32 off
    themselves (the reference pins ``Precision.HIGHEST`` on its
    contraction), so a direct caller gets full f32 whatever it set."""
    D = blocks.bp.shape[1]
    N = blocks.Hpp.shape[0]
    dtype = blocks.bp.dtype
    S = dense_reduced_system(blocks)

    # gauge projection: pinned coordinates get identity rows/cols
    mf = _free_mask(blocks, N, D).reshape(-1)
    Sf = S.reshape(N * D, N * D)
    Sf = mf[:, None] * Sf * mf[None, :]
    Sf = Sf + torch.diag(1.0 - mf)

    # Jacobi equilibration before the Cholesky: stiff chains put ~1e9
    # entries next to ~1e2 vision information; scaling to a unit diagonal
    # restores the conditioning headroom.
    dg = torch.diagonal(Sf)
    d = 1.0 / torch.sqrt(torch.where(dg > 0, dg, 1.0))
    Se = d[:, None] * Sf * d[None, :]
    Se = Se + (1e-7 if dtype == torch.float32 else 1e-14) * torch.eye(
        N * D, dtype=Se.dtype, device=Se.device
    )

    bf = (b.reshape(-1) * mf) * d
    x = chol_solve_mixed(Se, bf[:, None])
    return (x[:, 0] * d * mf).reshape(N, D)


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor
    residual_norm: torch.Tensor


def _vdot(a, b):
    return torch.sum(a * b)


def _takes_fused_cg(b, P, free_pose) -> bool:
    """Whether :func:`pcg`'s trips run as ``ops.segmm.pcg_trip``'s kernel
    (:func:`_fused_cg`): ``ops.segmm.takes_pcg_trip``, float32 (N, D)
    vectors on the card with D <= 15, float32 (N, D, D) preconditioner
    blocks and float32 free_pose (N,) or (N, D). Elsewhere (the CPU, f64)
    each trip runs ``ops.segmm.pcg_trip_reference``."""
    return segmm.takes_pcg_trip(b, P, free_pose)


def _fused_cg(matvec, P, free_pose, x, r, z, rz, rr, thresh_sq,
              max_iters: int) -> CGResult:
    """:func:`pcg`'s loop from its set-up's x, r, z and scalars, each trip
    its matvec and one host call of ``ops.segmm.pcg_trip``, which updates
    x, r, z, p and the state (rz, rr, thresh_sq, it) in place on the
    device. Counted as ``schur.cg_fused`` beside ``schur.cg_trips``."""
    x = x.contiguous()
    r, z = r.contiguous(), z.contiguous()
    p = z.clone()
    # it starts at 0: the int32 in the fourth float's bits
    state = torch.stack([rz, rr, thresh_sq, torch.zeros_like(rz)])
    trip = segmm.pcg_trip(P.contiguous(), free_pose.contiguous(), x, r, z,
                          p, state)
    for _ in range(max_iters):
        count("schur.cg_trips")
        count("schur.cg_fused")
        with span("schur.matvec"):
            Sp = matvec(p)
        trip(Sp)
    return CGResult(x=x, iterations=state[3:].view(torch.int32)[0],
                    residual_norm=torch.sqrt(state[1]))


def pcg(blocks: SchurBlocks, b, max_iters: int = 100, tol: float = 1e-8,
        S4: torch.Tensor | None = None) -> CGResult:
    """Preconditioned conjugate gradients on the reduced camera system.

    Runs exactly ``max_iters`` iterations with convergence *masking* on the
    scalar step sizes (alpha/beta -> 0 freezes x, r, rz) instead of a
    data-dependent exit: the loop never reads a device value on the host.
    Each trip is its matvec, then ``ops.segmm.pcg_trip_reference``, or, for
    the float32 vectors on the card that :func:`_takes_fused_cg` names, the
    kernel of ``ops.segmm.pcg_trip`` in one host call (:func:`_fused_cg`).

    ``S4`` (explicit-S mode): the materialized reduced system from
    :func:`dense_reduced_system`. The Krylov iterates match the
    matrix-free path (same operator, same SCHUR_JACOBI preconditioner, here
    read off S's block diagonal); each matvec is one dense GEMV.
    """
    if S4 is not None:
        N, D = b.shape
        ar = torch.arange(N, device=S4.device)
        Pd = S4[ar, :, ar, :]  # (N, D, D)
        eye = torch.eye(D, dtype=S4.dtype, device=S4.device)
        m = _free_mask(blocks, N, D)
        Pd = m[:, :, None] * Pd * m[:, None, :]
        Pd = Pd + eye * (1.0 - m)[..., None, :] + 1e-10 * eye
        P = cho_inverse(Pd)
        S2 = S4.reshape(N * D, N * D)

        def matvec(x):
            x = _project(x, blocks.free_pose)
            y = S2 @ x.reshape(-1).to(S2.dtype)
            return _project(y.reshape(N, D), blocks.free_pose)
    else:
        P = schur_jacobi_preconditioner(blocks)

        def matvec(x):
            return schur_matvec(blocks, x)

    free = blocks.free_pose
    b = _project(b, free)
    x = torch.zeros_like(b)
    r = b
    z = segmm.block_jacobi_apply(P, r, free)
    p = z
    rz = _vdot(r, z)
    rr = _vdot(b, b)
    thresh_sq = (tol * tol) * rr
    if _takes_fused_cg(b, P, free):
        return _fused_cg(matvec, P, free, x, r, z, rz, rr, thresh_sq,
                         max_iters)
    it = torch.zeros((), dtype=torch.int32, device=b.device)
    for _ in range(max_iters):
        count("schur.cg_trips")
        with span("schur.matvec"):
            Sp = matvec(p)
        x, r, z, p, rz, rr, it = segmm.pcg_trip_reference(
            P, free, x, r, p, Sp, rz, rr, thresh_sq, it)
    return CGResult(x=x, iterations=it, residual_norm=torch.sqrt(rr))


def back_substitute(blocks: SchurBlocks, dx_pose: torch.Tensor) -> torch.Tensor:
    """dx_lm = Hll^-1 (bl - U^T dx_pose). Returns (M, 3)."""
    with span("schur.back_substitute"):
        xk = _broadcast_pose(blocks, _project(dx_pose, blocks.free_pose))
        utx = _seg_lm(blocks, _w_t_apply(blocks.W, xk))  # (3, M)
        return sym3_matvec(blocks.Hll_inv, blocks.bl - utx).T
