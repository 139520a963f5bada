"""Segment kernels of the Schur system (port of ``libwave_tpu.ops.segmm``).

Hand-written Hopper kernels, built with ``nvcc`` for ``sm_90a`` at first
use and bound with ``ctypes``:

- :func:`dense_g_a_window` (``csrc/segmm_g_a.cu``): the fused dense-Schur
  G/A build. The dense reduced camera system (``optim.schur.
  dense_reduced_system``) needs the scatter G of per-observation W blocks
  into landmark columns and A = G Hll^-1 for a window of poses and columns
  (a band, a chunk or everything); both come out of one pass driven by the
  landmark-sorted layout (:class:`EllLayout`), reading the full W and Hinv
  through offsets. :func:`dense_g_a` keeps the reference's signature
  (``dense_g_a_onehot``) and goes through the same kernel;
- :func:`seg_reduce_sorted` / :func:`seg_reduce` (``csrc/segmm_seg.cu``):
  per-landmark sums, the landmark-side reduce of the Schur system;
- :func:`seg_broadcast` (``csrc/segmm_seg.cu``): the gather ``y[:, idx]``,
  the landmark-side broadcast;
- :func:`matvec_wt_slots`, :func:`matvec_landmark_step` and
  :func:`matvec_pose_side` (``csrc/schur_matvec.cu``): with
  :func:`seg_reduce_sorted` between the first two, the matrix-free Schur
  matvec ``optim.schur.schur_matvec`` on pose-ELL blocks in four launches:
  ``W^T x`` per slot, the landmark reduce, the ``Hll^-1`` step, and one
  pose-side pass that gathers ``y``, applies W and sums a pose's slots;
- :func:`schur_self_blocks` (``csrc/schur_precond.cu``): the per-pose self
  terms ``sum W_s Hll^-1 W_s^T`` of the SCHUR_JACOBI preconditioner
  (``optim.schur.schur_jacobi_preconditioner``) in one pass over W;
- :func:`pcg_trip` (``csrc/schur_pcg.cu``): one trip of ``optim.schur.pcg``'s
  loop after its matvec (the step sizes, the x, r and p updates, the
  block-Jacobi apply and the dots) in one host call, the state kept on the
  device.

Each wrapper launches its kernel on a CUDA tensor through ``_build``'s
launcher (or raises on inputs the kernel does not take) and counts the
launch in its ``launches`` attribute, registered with
``utils.trace.counts_launches``; on a CPU tensor it runs the plain PyTorch
version beside it (``*_reference``), which nothing on the card path calls.

The G/A kernel and its plain version follow the reference kernel's f32
contract (``libwave_tpu/ops/segmm.py:213-241``): G is summed and rounded to f32 and A is formed in f32
from f32 G and Hinv, whatever the storage dtype. The output layout is
(N, Dj*3, M) with rows ordered (dj, j), so that
``x.reshape(N*Dj, 3*M)`` is the 2D operand of ``S_sub = A2 @ G2.T``.

The reference's segment reduce and broadcast run as one-hot K x M matmuls on
the MXU, which its own docstring says loses at map-scale M. Here they are
index operations again: the reduce sums each landmark's run of a
landmark-sorted slot list (``sigma`` plus CSR ``offsets``, built host-side
with the ELL layout) in slot order, one thread per (channel, landmark) with
eight slots' gathers in flight, without atomics, so kernel and plain
version add in the same order.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from libwave_tpu_torch.ops import _build
from libwave_tpu_torch.utils.trace import counts_launches

# symmetric-3x3 component index for (j, l), both triangles
_SYM3_AT = {
    (0, 0): 0, (0, 1): 1, (0, 2): 2,
    (1, 0): 1, (1, 1): 3, (1, 2): 4,
    (2, 0): 2, (2, 1): 4, (2, 2): 5,
}


class EllLayout(NamedTuple):
    """A landmark-sorted slot list: landmark ``m``'s slots are
    ``sigma[offsets[m]:offsets[m+1]]``, ascending. Built host-side with the
    pose-ELL pack (``optim.schur.build_ell_layout``) or on the device
    (:func:`sorted_layout`)."""

    sigma: torch.Tensor  # (K,) int32 slots sorted by landmark, stable
    offsets: torch.Tensor  # (M+1,) int32 CSR bounds of each landmark in sigma


_KERNEL_ROWS = 18  # Dj * 3 rows the CUDA kernel is instantiated for
_TILE_POSES = 4  # poses per block of the G/A kernel (kTP in segmm_g_a.cu)
_SEG_TYPES = {torch.float32: "f32", torch.float64: "f64"}
_MATVEC_ROWS = 18  # Dj * 3 rows of W the matvec kernels take
PCG_MAX_D = 15  # pose coordinates the CG trip kernel takes at most (kMaxD)
_INT32_MAX = 2**31 - 1
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def dense_g_a_reference(W: torch.Tensor, lm_slot: torch.Tensor,
                        hinv: torch.Tensor):
    """Plain PyTorch G/A build: ``W`` (Dj*3, N, Pmax), ``lm_slot`` (N, Pmax)
    landmark ids, ``hinv`` (6, M) symmetric inverse landmark blocks ->
    ``(G, A)`` each (N, Dj*3, M) in ``W``'s dtype. Ids outside ``[0, M)``
    are masked out before any indexing and contribute zeros.

    A (pose, column) cell with several slots sums them in slot order from
    zero, as the kernel does, on every device: slots are ranked among the
    slots of their pose that share their id, and pass ``r`` adds the rank-r
    slots (no two of which meet in one cell; the others add exact zeros).
    The pass count is the largest multiplicity, read on the host: the plain
    version synchronizes."""
    C, N, P = W.shape
    M = hinv.shape[1]
    Dj = C // 3
    ok = (lm_slot >= 0) & (lm_slot < M)
    idx = torch.where(ok, lm_slot, 0).long()
    vals = torch.where(ok[None], W, 0.0).permute(1, 0, 2)  # (N, C, P)
    G = torch.zeros((N, C, M), dtype=W.dtype, device=W.device)
    # a slot outside [0, M) gets a key of its own: its rank stays 0, so the
    # pass count is the largest multiplicity of a real id
    pos = torch.arange(P, device=W.device)
    rank = _duplicate_rank(torch.where(ok, lm_slot.long(), M + pos))
    passes = int(rank.max()) + 1 if rank.numel() else 0
    for r in range(passes):
        G.scatter_add_(2, idx[:, None, :].expand(N, C, P),
                       torch.where((rank == r)[:, None, :], vals, 0.0))
    g = G.to(torch.float32).view(N, Dj, 3, M)
    h = hinv.to(W.dtype).to(torch.float32)
    A = torch.stack(
        [
            sum(g[:, :, j] * h[_SYM3_AT[(j, l)]] for j in range(3))
            for l in range(3)
        ],
        dim=2,
    )  # (N, Dj, 3, M)
    return g.reshape(N, C, M).to(W.dtype), A.reshape(N, C, M).to(W.dtype)


def _duplicate_rank(key: torch.Tensor) -> torch.Tensor:
    """(N, P) rank of each slot among the slots of its row that share its
    key, in slot order (0 for the first): a stable sort and run offsets."""
    order = torch.argsort(key, dim=1, stable=True)
    sk = torch.gather(key, 1, order)
    pos = torch.arange(key.shape[1], device=key.device).expand_as(key)
    new = torch.ones_like(sk, dtype=torch.bool)
    new[:, 1:] = sk[:, 1:] != sk[:, :-1]
    start = torch.cummax(torch.where(new, pos, 0), dim=1).values
    return torch.empty_like(order).scatter_(1, order, pos - start)


def layout_ids(ell: EllLayout, K: int) -> torch.Tensor:
    """(K,) int32 landmark id of every slot the layout lists in a run, -1
    for the slots it lists in none; on the layout's device, without a host
    read."""
    sigma, offsets = ell
    dev = sigma.device
    pos = torch.arange(K, dtype=torch.int32, device=dev)
    lm = torch.searchsorted(offsets[1:], pos, right=True).to(torch.int32)
    listed = (pos >= offsets[0]) & (pos < offsets[-1])
    ids = torch.empty(K, dtype=torch.int32, device=dev)
    return ids.scatter_(0, sigma.long(), torch.where(listed, lm, -1))


def dense_g_a_window_reference(W: torch.Tensor, ell: EllLayout,
                               hinv: torch.Tensor, c0: int, c1: int,
                               plo: int, phi: int):
    """Plain PyTorch version of :func:`dense_g_a_window`: the slots' ids
    from the layout, then the window's slice of W, ids (shifted by ``c0``)
    and hinv through :func:`dense_g_a_reference`."""
    _, N, P = W.shape
    ids = layout_ids(ell, N * P).reshape(N, P)
    return dense_g_a_reference(W[:, plo:phi], ids[plo:phi] - c0,
                               hinv[:, c0:c1])


_G_A_LIB = _build.library("segmm_g_a", ("segmm_g_a.cu",), {
    "segmm_g_a_window_f32": dict(argtypes=[_P] * 6 + [_I] * 8 + [_P],
                                 restype=_I)})


def _check_rows(W):
    if W.dim() != 3 or W.shape[0] != _KERNEL_ROWS:
        raise ValueError(
            f"dense_g_a on CUDA is built for W (Dj*3 = {_KERNEL_ROWS} rows, "
            f"N, Pmax), got shape {tuple(W.shape)}"
        )


def _check_cuda_inputs(W, lm_slot, hinv):
    if not (lm_slot.device == W.device and hinv.device == W.device):
        raise ValueError(
            f"dense_g_a: W, lm_slot and hinv must share one device, got "
            f"{W.device}, {lm_slot.device}, {hinv.device}"
        )
    if W.dtype != torch.float32 or hinv.dtype != torch.float32:
        raise TypeError(
            f"dense_g_a on CUDA takes float32 W and hinv, got {W.dtype} "
            f"and {hinv.dtype}"
        )
    if lm_slot.dtype != torch.int32:
        raise TypeError(f"dense_g_a: lm_slot must be int32, got {lm_slot.dtype}")
    if W.dim() != 3 or lm_slot.dim() != 2 or hinv.dim() != 2:
        raise ValueError("dense_g_a: expected W (C, N, P), lm_slot (N, P), "
                         "hinv (6, M)")
    _check_rows(W)
    _, N, P = W.shape
    if tuple(lm_slot.shape) != (N, P) or hinv.shape[0] != 6:
        raise ValueError(
            f"dense_g_a: shapes W {tuple(W.shape)}, lm_slot "
            f"{tuple(lm_slot.shape)}, hinv {tuple(hinv.shape)} disagree"
        )
    for name, t in (("W", W), ("lm_slot", lm_slot), ("hinv", hinv)):
        if not t.is_contiguous():
            raise ValueError(f"dense_g_a: {name} must be contiguous")


def _check_window_inputs(W, ell, hinv, c0, c1, plo, phi):
    sigma, offsets = ell
    for name, t in (("sigma", sigma), ("offsets", offsets), ("hinv", hinv)):
        if t.device != W.device:
            raise ValueError(f"dense_g_a_window: {name} is on {t.device}, W "
                             f"on {W.device}; they must share one device")
    if W.dtype != torch.float32 or hinv.dtype != torch.float32:
        raise TypeError(f"dense_g_a_window on CUDA takes float32 W and hinv, "
                        f"got {W.dtype} and {hinv.dtype}")
    if sigma.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise TypeError(f"dense_g_a_window: sigma and offsets must be int32, "
                        f"got {sigma.dtype} and {offsets.dtype}")
    _check_rows(W)
    _, N, P = W.shape
    M = hinv.shape[1] if hinv.dim() == 2 else -1
    if (hinv.dim() != 2 or hinv.shape[0] != 6
            or tuple(sigma.shape) != (N * P,)
            or tuple(offsets.shape) != (M + 1,)):
        raise ValueError(
            f"dense_g_a_window: W {tuple(W.shape)}, sigma "
            f"{tuple(sigma.shape)}, offsets {tuple(offsets.shape)} and hinv "
            f"{tuple(hinv.shape)} do not fit (sigma (N*Pmax,), offsets "
            f"(M+1,), hinv (6, M))")
    if not (0 <= c0 <= c1 <= M and 0 <= plo <= phi <= N):
        raise ValueError(f"dense_g_a_window: window columns [{c0}, {c1}) "
                         f"poses [{plo}, {phi}) outside M={M}, N={N}")
    if N * P > _INT32_MAX or -(-(phi - plo) // _TILE_POSES) > 65535:
        raise ValueError(f"dense_g_a_window: at most 2^31 - 1 slots and "
                         f"{65535 * _TILE_POSES} poses per call, got N={N}, "
                         f"Pmax={P}, poses [{plo}, {phi})")
    for name, t in (("W", W), ("sigma", sigma), ("offsets", offsets),
                    ("hinv", hinv)):
        if not t.is_contiguous():
            raise ValueError(f"dense_g_a_window: {name} must be contiguous")


@counts_launches
def dense_g_a_window(W: torch.Tensor, ell: EllLayout, hinv: torch.Tensor,
                     c0: int, c1: int, plo: int, phi: int):
    """Fused dense-Schur G/A build of the poses ``[plo, phi)`` and landmark
    columns ``[c0, c1)``: ``W`` (Dj*3, N, Pmax) pose-ELL blocks
    (component-major), ``ell`` the landmark-sorted layout of its N*Pmax
    slots, ``hinv`` (6, M) inverted landmark blocks (symmetric components).
    Returns ``(G, A)``, each (phi - plo, Dj*3, c1 - c0).

    Only the slots the layout lists in landmark ``m``'s run go to column
    ``m``; the package's layouts leave out only slots of zero weight.

    On CUDA this launches ``csrc/segmm_g_a.cu`` on the current stream,
    reading the full W, layout and hinv (float32 values, int32 layout,
    contiguous; no copy), and counts the launch in
    ``dense_g_a_window.launches``; inputs it does not take raise. On CPU it
    returns :func:`dense_g_a_window_reference`.
    """
    if W.device.type == "cpu":
        return dense_g_a_window_reference(W, ell, hinv, c0, c1, plo, phi)
    if W.device.type != "cuda":
        raise ValueError(f"dense_g_a_window: unsupported device {W.device}")
    _check_window_inputs(W, ell, hinv, c0, c1, plo, phi)
    C, N, P = W.shape
    M = hinv.shape[1]
    G = torch.empty((phi - plo, C, c1 - c0), dtype=W.dtype, device=W.device)
    A = torch.empty_like(G)
    if phi == plo or c1 == c0:
        return G, A
    _build.launch(_G_A_LIB, "segmm_g_a_window_f32", W, ell.sigma,
                  ell.offsets, hinv, G, A, N, P, M, C, c0, c1, plo, phi)
    dense_g_a_window.launches += 1
    return G, A


def dense_g_a(W: torch.Tensor, lm_slot: torch.Tensor, hinv: torch.Tensor):
    """Fused dense-Schur G/A build with the reference's signature: ``W``
    (Dj*3, N, Pmax) pose-ELL blocks (component-major, padding slots zero),
    ``lm_slot`` (N, Pmax) landmark ids, ``hinv`` (6, M) inverted landmark
    blocks (symmetric components) -> ``(G, A)`` each (N, Dj*3, M).

    Entries of ``lm_slot`` outside ``[0, M)`` contribute zeros.

    On CUDA the landmark-sorted layout of the ids is built on the device
    (stable sort, then a search of every landmark's bound; no host read) and
    :func:`dense_g_a_window` launches the kernel over every pose and column;
    inputs it does not take raise. On CPU it returns
    :func:`dense_g_a_reference`.
    """
    if W.device.type == "cpu":
        return dense_g_a_reference(W, lm_slot, hinv)
    if W.device.type != "cuda":
        raise ValueError(f"dense_g_a: unsupported device {W.device}")
    _check_cuda_inputs(W, lm_slot, hinv)
    _, N, _ = W.shape
    M = hinv.shape[1]
    return dense_g_a_window(W, sorted_layout(lm_slot.reshape(-1), M), hinv,
                            0, M, 0, N)


# ---------------------------------------------------------------------------
# Segment reduce and broadcast (csrc/segmm_seg.cu)
# ---------------------------------------------------------------------------


def seg_reduce_sorted_reference(vals: torch.Tensor, sigma: torch.Tensor,
                                offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch sorted segment reduce: ``out[c, m]`` is the sum of
    ``vals[c, sigma[p]]`` for p in ``[offsets[m], offsets[m+1])``, added one
    slot at a time from zero in that order (the kernel's order). ``vals``
    (C, K), ``sigma`` (K,), ``offsets`` (M+1,) -> (C, M) in ``vals``' dtype.
    Reads the longest run on the host: the plain version synchronizes."""
    C = vals.shape[0]
    M = offsets.shape[0] - 1
    start = offsets[:-1].long()
    count = offsets[1:].long() - start
    out = vals.new_zeros((C, M))
    if M == 0:
        return out
    v = vals[:, sigma.long()]  # landmark-sorted order
    for j in range(int(count.max())):
        live = j < count
        out = out + torch.where(live, v[:, torch.where(live, start + j, 0)], 0)
    return out


def sorted_layout(idx: torch.Tensor, num_segments: int) -> EllLayout:
    """:class:`EllLayout` (sigma, offsets; int32) of ids ``idx`` (K,): a
    stable sort and the CSR bounds of every segment in
    ``[0, num_segments)``, on ``idx``'s device and without a host read. Ids
    outside the range fall outside every segment."""
    ids, sigma = torch.sort(idx.to(torch.int32), stable=True)
    bounds = torch.arange(num_segments + 1, dtype=torch.int32,
                          device=idx.device)
    offsets = torch.searchsorted(ids, bounds)
    return EllLayout(sigma.to(torch.int32), offsets.to(torch.int32))


def seg_reduce_reference(vals: torch.Tensor, idx: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """Plain PyTorch segment reduce with the reference's signature: ``vals``
    (C, K) summed by ids ``idx`` (K,) into (C, num_segments), slot order
    within each segment. Ids outside ``[0, num_segments)`` contribute
    nothing."""
    return seg_reduce_sorted_reference(vals, *sorted_layout(idx, num_segments))


def seg_broadcast_reference(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch segment broadcast: ``out[c, k] = y[c, idx[k]]`` where
    ``0 <= idx[k] < M``, else 0. ``y`` (C, M), ``idx`` (K,) -> (C, K)."""
    C, M = y.shape
    if M == 0:
        return y.new_zeros((C, idx.shape[0]))
    ok = (idx >= 0) & (idx < M)
    return torch.where(ok, y[:, torch.where(ok, idx, 0).long()], 0)


_SEG_LIB = _build.library("segmm_seg", ("segmm_seg.cu",), {
    f"{kind}_{t}": dict(argtypes=[_P] * pointers + [_I] * 3 + [_P],
                        restype=_I)
    for t in _SEG_TYPES.values()
    for kind, pointers in (("seg_reduce_sorted", 4), ("seg_broadcast", 3))})


def _check_seg(what, x, ids, C, K):
    """Common checks of a segment kernel's inputs on CUDA: ``x`` the float
    operand, ``ids`` the int32 index tensors, all on one device."""
    for name, t in ids:
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, the values "
                             f"on {x.device}; they must share one device")
    if x.dtype not in _SEG_TYPES:
        raise TypeError(f"{what} on CUDA takes float32 or float64 values, "
                        f"got {x.dtype}")
    for name, t in ids:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{what}: {name} must be 1-D, got shape "
                             f"{tuple(t.shape)}")
    if x.dim() != 2:
        raise ValueError(f"{what}: values must be 2-D (C, ...), got shape "
                         f"{tuple(x.shape)}")
    if C > 65535 or K > _INT32_MAX:
        raise ValueError(f"{what}: at most 65535 channels and 2^31 - 1 "
                         f"slots, got C={C}, K={K}")
    for name, t in (("values", x), *ids):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


@counts_launches
def seg_reduce_sorted(vals: torch.Tensor, sigma: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """Per-segment sums over a sorted slot list: ``vals`` (C, K), ``sigma``
    (K,) slots ordered by segment, ``offsets`` (M+1,) non-decreasing CSR
    bounds of each segment in ``sigma`` (``offsets[M] <= K``; slots after
    it belong to no segment). Returns (C, M) in ``vals``' dtype.

    On CUDA this launches ``csrc/segmm_seg.cu``'s reduce on the current
    stream (float32 or float64 values, int32 ids, contiguous) and counts it
    in ``seg_reduce_sorted.launches``; other inputs raise. On CPU it
    returns :func:`seg_reduce_sorted_reference`."""
    if vals.device.type == "cpu":
        return seg_reduce_sorted_reference(vals, sigma, offsets)
    if vals.device.type != "cuda":
        raise ValueError(f"seg_reduce_sorted: unsupported device {vals.device}")
    C, K = vals.shape if vals.dim() == 2 else (0, 0)
    _check_seg("seg_reduce_sorted", vals,
               (("sigma", sigma), ("offsets", offsets)), C, K)
    M = offsets.shape[0] - 1
    if sigma.shape[0] != K or M < 0:
        raise ValueError(f"seg_reduce_sorted: sigma {tuple(sigma.shape)} and "
                         f"offsets {tuple(offsets.shape)} do not fit values "
                         f"{tuple(vals.shape)}")
    out = torch.empty((C, M), dtype=vals.dtype, device=vals.device)
    if C == 0 or M == 0:
        return out
    _build.launch(_SEG_LIB, f"seg_reduce_sorted_{_SEG_TYPES[vals.dtype]}",
                  vals, sigma, offsets, out, C, K, M)
    seg_reduce_sorted.launches += 1
    return out


def seg_reduce(vals: torch.Tensor, idx: torch.Tensor,
               num_segments: int) -> torch.Tensor:
    """(C, K) values + (K,) segment ids -> (C, num_segments) per-segment
    sums (the reference's ``seg_reduce_onehot``). Ids outside
    ``[0, num_segments)`` contribute nothing.

    On CUDA the sorted order and CSR offsets are built on the device
    (stable sort, then a search of every segment's bound; no host read) and
    :func:`seg_reduce_sorted` launches the kernel. On CPU it returns
    :func:`seg_reduce_reference`."""
    if vals.device.type == "cpu":
        return seg_reduce_reference(vals, idx, num_segments)
    return seg_reduce_sorted(vals, *sorted_layout(idx, num_segments))


@counts_launches
def seg_broadcast(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(C, M) per-segment values + (K,) segment ids -> (C, K) gathered view
    ``y[:, idx]``; ids outside ``[0, M)`` give zeros (the reference's
    ``seg_broadcast_onehot``).

    On CUDA this launches ``csrc/segmm_seg.cu``'s broadcast on the current
    stream (float32 or float64 ``y``, int32 ``idx``, contiguous) and counts
    it in ``seg_broadcast.launches``; other inputs raise. On CPU it returns
    :func:`seg_broadcast_reference`."""
    if y.device.type == "cpu":
        return seg_broadcast_reference(y, idx)
    if y.device.type != "cuda":
        raise ValueError(f"seg_broadcast: unsupported device {y.device}")
    C, M = y.shape if y.dim() == 2 else (0, 0)
    K = idx.shape[0] if idx.dim() == 1 else 0
    _check_seg("seg_broadcast", y, (("idx", idx),), C, K)
    out = torch.empty((C, K), dtype=y.dtype, device=y.device)
    if C == 0 or K == 0:
        return out
    if M == 0:
        return out.zero_()
    _build.launch(_SEG_LIB, f"seg_broadcast_{_SEG_TYPES[y.dtype]}", y, idx,
                  out, C, K, M)
    seg_broadcast.launches += 1
    return out


# ---------------------------------------------------------------------------
# The matrix-free Schur matvec on pose-ELL blocks (csrc/schur_matvec.cu)
# ---------------------------------------------------------------------------


def project(x: torch.Tensor, free_pose: torch.Tensor) -> torch.Tensor:
    """Zero out gauge-fixed coordinates. ``free_pose`` is (N,) to fix whole
    blocks, or (N, D) to fix individual tangent columns."""
    if free_pose.dim() == 1:
        return x * free_pose[:, None]
    return x * free_pose


def w_t_apply(W: torch.Tensor, xk: torch.Tensor) -> torch.Tensor:
    """utx[j] = sum_i W[i*3+j] xk[i] over the Dj observation-touched rows."""
    Dj = W.shape[0] // 3
    return torch.stack(
        [sum(W[i * 3 + j] * xk[i] for i in range(Dj)) for j in range(3)]
    )


def w_apply(W: torch.Tensor, yk: torch.Tensor) -> torch.Tensor:
    """uy[i] = sum_j W[i*3+j] yk[j] -> (Dj, ...)."""
    Dj = W.shape[0] // 3
    return torch.stack(
        [sum(W[i * 3 + j] * yk[j] for j in range(3)) for i in range(Dj)]
    )


def sym3_matvec(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = S v for symmetric components s (6, ...) and v (3, ...)."""
    return torch.stack(
        [
            s[0] * v[0] + s[1] * v[1] + s[2] * v[2],
            s[1] * v[0] + s[3] * v[1] + s[4] * v[2],
            s[2] * v[0] + s[4] * v[1] + s[5] * v[2],
        ]
    )


def matvec_wt_slots_reference(W: torch.Tensor, x: torch.Tensor,
                              free_pose: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``W^T x`` per slot: ``t[j, n*P + p] = sum_i W[3i+j, n,
    p] x̂[n, i]`` with ``x̂ = project(x, free_pose)``; ``W`` (Dj*3, N, P),
    ``x`` (N, D) -> (3, N*P)."""
    xk = project(x, free_pose).T[:, :, None]  # (D, N, 1) over the slots
    return w_t_apply(W, xk).reshape(3, -1)


def matvec_landmark_step_reference(hinv: torch.Tensor,
                                   utx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``Hll^-1`` step: ``y[:, m] = Hll^-1[m] utx[:, m]``
    from the symmetric components ``hinv`` (6, M); ``utx`` (3, M) -> (3, M)."""
    return sym3_matvec(hinv, utx)


def matvec_pose_side_reference(W: torch.Tensor, lm_idx: torch.Tensor,
                               y: torch.Tensor, Hpp: torch.Tensor,
                               x: torch.Tensor,
                               free_pose: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch pose side of the matvec: ``out[n] = project(Hpp[n] x̂[n]
    - pad(sum_p W[:, n, p] y[:, lm_idx[n*P + p]]))``, each slot's W block
    (Dj x 3) applied to its landmark's ``y`` and padded from Dj to D; ids
    outside ``[0, M)`` gather zeros. ``W`` (Dj*3, N, P), ``lm_idx`` (N*P,),
    ``y`` (3, M), ``Hpp`` (N, D, D), ``x`` (N, D) -> (N, D)."""
    D, Dj = Hpp.shape[-1], W.shape[0] // 3
    out = torch.einsum("nij,nj->ni", Hpp, project(x, free_pose))
    yk = seg_broadcast_reference(y, lm_idx).reshape((3,) + tuple(W.shape[1:]))
    uy = torch.sum(w_apply(W, yk), dim=-1)  # (Dj, N)
    return project(out - torch.nn.functional.pad(uy.T, (0, D - Dj)),
                   free_pose)


_MATVEC_LIB = _build.library("schur_matvec", ("schur_matvec.cu",), {
    "matvec_wt_slots_f32": dict(
        argtypes=[_P, _LL, _P, _P, _I, _P, _I, _I, _I, _P], restype=_I),
    "matvec_landmark_step_f32": dict(argtypes=[_P, _P, _P, _I, _P],
                                     restype=_I),
    "matvec_pose_side_f32": dict(
        argtypes=[_P, _LL, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P],
        restype=_I)})


def _check_f32(what, named, device):
    """Every tensor of ``named`` float32 on ``device``, contiguous."""
    for name, t in named:
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, W on "
                             f"{device}; they must share one device")
        if t.dtype != torch.float32:
            raise TypeError(f"{what} on CUDA takes float32 values, got "
                            f"{name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _w_shape_fault(W):
    """What of W's shape the kernels that sweep pose-ELL blocks do not
    take, as a message, or None: (18, N, Pmax) with N * Pmax < 2^31."""
    if W.dim() != 3 or W.shape[0] != _MATVEC_ROWS:
        return (f"W must be (Dj*3 = {_MATVEC_ROWS} rows, N, Pmax), got "
                f"shape {tuple(W.shape)}")
    _, N, P = W.shape
    if N * P > _INT32_MAX:
        return f"at most 2^31 - 1 slots, got N={N}, Pmax={P}"
    return None


def _pose_shape_fault(W, x, free_pose):
    """What of the pose-side shapes the matvec kernels do not take, as a
    message, or None: W as :func:`_w_shape_fault` takes it, x (N, D) with
    D >= 6, free_pose (N,) or (N, D)."""
    fault = _w_shape_fault(W)
    if fault is not None:
        return fault
    _, N, _ = W.shape
    D = x.shape[-1] if x.dim() == 2 else -1
    if x.dim() != 2 or x.shape[0] != N or D < _MATVEC_ROWS // 3:
        return (f"x must be (N={N}, D >= {_MATVEC_ROWS // 3}), got "
                f"{tuple(x.shape)}")
    if tuple(free_pose.shape) not in ((N,), (N, D)):
        return (f"free_pose must be ({N},) or ({N}, {D}), got "
                f"{tuple(free_pose.shape)}")
    return None


def takes_matvec(W, x, free_pose, Hpp, Hll_inv) -> bool:
    """Whether the matvec kernels take ``S x`` on pose-ELL blocks ``W``,
    ``Hpp``, ``Hll_inv`` and ``free_pose``: on the card, float32, in the
    shapes the wrappers check (W (18, N, Pmax), x (N, D) with D >= 6,
    free_pose (N,) or (N, D), Hpp (N, D, D), Hll_inv (6, M))."""
    return (W.is_cuda and _pose_shape_fault(W, x, free_pose) is None
            and Hpp.shape == (*x.shape, x.shape[1])
            and Hll_inv.dim() == 2 and Hll_inv.shape[0] == 6
            and Hll_inv.shape[1] <= _INT32_MAX
            and all(t.dtype == torch.float32
                    for t in (W, x, free_pose, Hpp, Hll_inv)))


def _check_w(what, W, fault):
    """W float32, its shape without ``fault`` (a message or None), its
    (N, Pmax) planes contiguous at any plane stride."""
    if W.dtype != torch.float32:
        raise TypeError(f"{what} on CUDA takes float32 W, got {W.dtype}")
    if fault is not None:
        raise ValueError(f"{what}: {fault}")
    _, N, P = W.shape
    if W.stride(2) != 1 or W.stride(1) != P or W.stride(0) < N * P:
        raise ValueError(f"{what}: W's (N, Pmax) planes must be contiguous "
                         f"(strides (>= N*Pmax, Pmax, 1)), got strides "
                         f"{W.stride()}")


def _check_ids(what, lm_idx, K, device):
    """Slot ids ``lm_idx`` (K,) int32, contiguous, on ``device``."""
    if tuple(lm_idx.shape) != (K,):
        raise ValueError(f"{what}: lm_idx must be ({K},), got "
                         f"{tuple(lm_idx.shape)}")
    if lm_idx.dtype != torch.int32:
        raise TypeError(f"{what}: lm_idx must be int32, got {lm_idx.dtype}")
    if lm_idx.device != device or not lm_idx.is_contiguous():
        raise ValueError(f"{what}: lm_idx must be contiguous on W's device "
                         f"{device}")


def _check_pose_inputs(what, W, x, free_pose):
    """W (18, N, P) float32 with contiguous (N, P) planes at any plane
    stride, x and free_pose in the shapes :func:`_pose_shape_fault` takes,
    float32, contiguous, on W's device. Returns (N, P, D, free_cols)."""
    _check_w(what, W, _pose_shape_fault(W, x, free_pose))
    _, N, P = W.shape
    _check_f32(what, (("x", x), ("free_pose", free_pose)), W.device)
    D = x.shape[1]
    return N, P, D, 0 if free_pose.dim() == 1 else D


@counts_launches
def matvec_wt_slots(W: torch.Tensor, x: torch.Tensor,
                    free_pose: torch.Tensor) -> torch.Tensor:
    """``W^T x`` per slot, the projection folded in: ``W`` (18, N, Pmax)
    pose-ELL blocks, ``x`` (N, D), ``free_pose`` (N,) or (N, D) -> ``t``
    (3, N*Pmax), ``t[j, n*Pmax + p] = sum_i W[3i+j, n, p] x[n, i]
    free_pose[n(, i)]``.

    On CUDA this launches ``csrc/schur_matvec.cu``'s ``wt_slots`` on the
    current stream (float32; W's planes contiguous at any plane stride, so
    a batched window's view is read in place; x and free_pose contiguous)
    and counts it in ``matvec_wt_slots.launches``; other inputs raise. On
    CPU it returns :func:`matvec_wt_slots_reference`."""
    if W.device.type == "cpu":
        return matvec_wt_slots_reference(W, x, free_pose)
    N, P, D, free_cols = _check_pose_inputs("matvec_wt_slots", W, x,
                                            free_pose)
    if W.device.type != "cuda":
        raise ValueError(f"matvec_wt_slots: unsupported device {W.device}")
    t = torch.empty((3, N * P), dtype=W.dtype, device=W.device)
    if N * P == 0:
        return t
    _build.launch(_MATVEC_LIB, "matvec_wt_slots_f32", W, W.stride(0), x,
                  free_pose, free_cols, t, N, P, D)
    matvec_wt_slots.launches += 1
    return t


@counts_launches
def matvec_landmark_step(hinv: torch.Tensor,
                         utx: torch.Tensor) -> torch.Tensor:
    """The ``Hll^-1`` step: ``hinv`` (6, M) symmetric components of the
    inverted landmark blocks, ``utx`` (3, M) -> ``y`` (3, M), ``y[:, m] =
    Hll^-1[m] utx[:, m]``.

    On CUDA this launches ``csrc/schur_matvec.cu``'s ``landmark_step`` on
    the current stream (float32, contiguous) and counts it in
    ``matvec_landmark_step.launches``; other inputs raise. On CPU it returns
    :func:`matvec_landmark_step_reference`."""
    if hinv.device.type == "cpu":
        return matvec_landmark_step_reference(hinv, utx)
    M = hinv.shape[1] if hinv.dim() == 2 else -1
    if hinv.dim() != 2 or hinv.shape[0] != 6 or tuple(utx.shape) != (3, M):
        raise ValueError(f"matvec_landmark_step: hinv (6, M) and utx (3, M) "
                         f"expected, got {tuple(hinv.shape)} and "
                         f"{tuple(utx.shape)}")
    if M > _INT32_MAX:
        raise ValueError(f"matvec_landmark_step: at most 2^31 - 1 "
                         f"landmarks, got {M}")
    _check_f32("matvec_landmark_step", (("hinv", hinv), ("utx", utx)),
               hinv.device)
    if hinv.device.type != "cuda":
        raise ValueError(f"matvec_landmark_step: unsupported device "
                         f"{hinv.device}")
    y = torch.empty((3, M), dtype=hinv.dtype, device=hinv.device)
    if M == 0:
        return y
    _build.launch(_MATVEC_LIB, "matvec_landmark_step_f32", hinv, utx, y, M)
    matvec_landmark_step.launches += 1
    return y


@counts_launches
def matvec_pose_side(W: torch.Tensor, lm_idx: torch.Tensor, y: torch.Tensor,
                     Hpp: torch.Tensor, x: torch.Tensor,
                     free_pose: torch.Tensor) -> torch.Tensor:
    """The pose side of the matvec in one pass: ``W`` (18, N, Pmax), slot
    ids ``lm_idx`` (N*Pmax,), ``y`` (3, M), ``Hpp`` (N, D, D), ``x`` (N, D),
    ``free_pose`` (N,) or (N, D) -> ``out`` (N, D), ``out[n] =
    project(Hpp[n] x̂[n] - pad(sum_p W[:, n, p] y[:, lm_idx[n*Pmax + p]]))``
    with ``x̂ = project(x, free_pose)``; ids outside ``[0, M)`` gather
    zeros.

    On CUDA this launches ``csrc/schur_matvec.cu``'s ``pose_side`` on the
    current stream (float32 values, int32 ids; W as for
    :func:`matvec_wt_slots`, the rest contiguous) and counts it in
    ``matvec_pose_side.launches``; other inputs raise. A pose's slots add
    in the kernel's fixed order, not ``torch.sum``'s. On CPU it returns
    :func:`matvec_pose_side_reference`."""
    if W.device.type == "cpu":
        return matvec_pose_side_reference(W, lm_idx, y, Hpp, x, free_pose)
    what = "matvec_pose_side"
    N, P, D, free_cols = _check_pose_inputs(what, W, x, free_pose)
    M = y.shape[1] if y.dim() == 2 else -1
    if y.dim() != 2 or y.shape[0] != 3 or M > _INT32_MAX:
        raise ValueError(f"{what}: y must be (3, M < 2^31), got "
                         f"{tuple(y.shape)}")
    if tuple(Hpp.shape) != (N, D, D):
        raise ValueError(f"{what}: Hpp must be ({N}, {D}, {D}), got "
                         f"{tuple(Hpp.shape)}")
    _check_ids(what, lm_idx, N * P, W.device)
    _check_f32(what, (("y", y), ("Hpp", Hpp)), W.device)
    if W.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {W.device}")
    out = torch.empty((N, D), dtype=W.dtype, device=W.device)
    if N == 0:
        return out
    _build.launch(_MATVEC_LIB, "matvec_pose_side_f32", W, W.stride(0),
                  lm_idx, y, M, Hpp, x, free_pose, free_cols, out, N, P, D)
    matvec_pose_side.launches += 1
    return out


# ---------------------------------------------------------------------------
# The SCHUR_JACOBI preconditioner's self-blocks (csrc/schur_precond.cu)
# ---------------------------------------------------------------------------


def tri_indices(D):
    """Upper-triangle (i, j) pairs of a DxD symmetric block, row by row."""
    return [(i, j) for i in range(D) for j in range(i, D)]


def assemble_sym(comps, D):
    """(T, ...) upper-triangle components in :func:`tri_indices` order ->
    (..., D, D) symmetric blocks."""
    rows = [[None] * D for _ in range(D)]
    for c, (i, j) in zip(comps, tri_indices(D)):
        rows[i][j] = c
        rows[j][i] = c
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def self_terms(W: torch.Tensor, hk: torch.Tensor) -> torch.Tensor:
    """Each slot's upper-triangle terms of ``W_s Hinv_s W_s^T``: ``W``
    (Dj*3, ...) slot blocks, ``hk`` (6, ...) the slots' symmetric 3x3
    components -> (Dj(Dj+1)/2, ...) in :func:`tri_indices` order, with T =
    W Hinv formed first."""
    Dj = W.shape[0] // 3
    # T[i][l] = sum_j W[i, j] Hinv[j, l]
    T = [
        [
            sum(W[i * 3 + j] * hk[_SYM3_AT[(j, l)]] for j in range(3))
            for l in range(3)
        ]
        for i in range(Dj)
    ]
    # self[i, i'] = sum_l T[i, l] W[i', l]
    return torch.stack(
        [
            sum(T[i][l] * W[i2 * 3 + l] for l in range(3))
            for i, i2 in tri_indices(Dj)
        ]
    )


def schur_self_blocks_reference(W: torch.Tensor, lm_idx: torch.Tensor,
                                Hll_inv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch per-pose Schur self-terms: ``out[n] = sum_p W_s
    Hll_inv[lm_idx[s]] W_s^T``, ``s = n*Pmax + p``, ``W_s`` the slot's Dj x 3
    block; ids outside ``[0, M)`` gather zeros. ``W`` (Dj*3, N, Pmax),
    ``lm_idx`` (N*Pmax,), ``Hll_inv`` (6, M) symmetric components -> (N, Dj,
    Dj), a pose's slots summed by ``torch.sum``."""
    hk = seg_broadcast_reference(Hll_inv, lm_idx).reshape(
        (6,) + tuple(W.shape[1:]))
    return assemble_sym(torch.sum(self_terms(W, hk), dim=-1),
                        W.shape[0] // 3)


_PRECOND_LIB = _build.library("schur_precond", ("schur_precond.cu",), {
    "schur_self_blocks_f32": dict(
        argtypes=[_P, _LL, _P, _P, _I, _P, _I, _I, _P], restype=_I)})


def takes_self_blocks(W, lm_idx, Hll_inv) -> bool:
    """Whether the self-blocks kernel takes pose-ELL blocks ``W``, their
    slot ids ``lm_idx`` and ``Hll_inv``: on the card, float32 W and Hll_inv,
    W (18, N, Pmax) with N * Pmax < 2^31, int32 ids (N*Pmax,), Hll_inv (6, M)
    with M < 2^31."""
    return (W.is_cuda and _w_shape_fault(W) is None
            and lm_idx.dtype == torch.int32
            and tuple(lm_idx.shape) == (W.shape[1] * W.shape[2],)
            and Hll_inv.dim() == 2 and Hll_inv.shape[0] == 6
            and Hll_inv.shape[1] <= _INT32_MAX
            and W.dtype == Hll_inv.dtype == torch.float32)


@counts_launches
def schur_self_blocks(W: torch.Tensor, lm_idx: torch.Tensor,
                      Hll_inv: torch.Tensor) -> torch.Tensor:
    """The per-pose Schur self-terms ``sum_p W_s Hll_inv[lm_idx[s]] W_s^T``
    of the SCHUR_JACOBI preconditioner in one pass over W: ``W`` (18, N,
    Pmax) pose-ELL blocks, slot ids ``lm_idx`` (N*Pmax,), ``Hll_inv`` (6, M)
    -> (N, 6, 6), both triangles; ids outside ``[0, M)`` add nothing.

    On CUDA this launches ``csrc/schur_precond.cu``'s kernel on the current
    stream (float32; W as for :func:`matvec_wt_slots`, int32 ids and
    Hll_inv contiguous) and counts it in ``schur_self_blocks.launches``;
    other inputs raise. Each slot's terms round as the plain version's; a
    pose's slots add in the kernel's fixed order, not ``torch.sum``'s. On
    CPU it returns :func:`schur_self_blocks_reference`."""
    if W.device.type == "cpu":
        return schur_self_blocks_reference(W, lm_idx, Hll_inv)
    what = "schur_self_blocks"
    _check_w(what, W, _w_shape_fault(W))
    _, N, P = W.shape
    M = Hll_inv.shape[1] if Hll_inv.dim() == 2 else -1
    if Hll_inv.dim() != 2 or Hll_inv.shape[0] != 6 or M > _INT32_MAX:
        raise ValueError(f"{what}: Hll_inv must be (6, M < 2^31), got "
                         f"{tuple(Hll_inv.shape)}")
    _check_ids(what, lm_idx, N * P, W.device)
    _check_f32(what, (("Hll_inv", Hll_inv),), W.device)
    if W.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {W.device}")
    out = torch.empty((N, 6, 6), dtype=W.dtype, device=W.device)
    if N == 0:
        return out
    _build.launch(_PRECOND_LIB, "schur_self_blocks_f32", W, W.stride(0),
                  lm_idx, Hll_inv, M, out, N, P)
    schur_self_blocks.launches += 1
    return out


# ---------------------------------------------------------------------------
# One trip of the preconditioned CG loop (csrc/schur_pcg.cu)
# ---------------------------------------------------------------------------


def block_jacobi_apply(P: torch.Tensor, v: torch.Tensor,
                       free_pose: torch.Tensor) -> torch.Tensor:
    """The block-Jacobi preconditioner's apply, ``project(P project(v))``
    per pose: ``P`` (N, D, D), ``v`` (N, D) -> (N, D), the product in the
    operands' promoted dtype."""
    v = project(v, free_pose)
    dt = torch.promote_types(P.dtype, v.dtype)
    return project(torch.einsum("nij,nj->ni", P.to(dt), v.to(dt)),
                   free_pose)


def pcg_trip_reference(P, free_pose, x, r, p, Sp, rz, rr, thresh_sq, it):
    """Plain PyTorch CG trip: the body of ``optim.schur.pcg``'s loop after
    its matvec ``Sp = S p``, operation for operation. ``P`` (N, D, D)
    inverted preconditioner blocks, ``free_pose`` (N,) or (N, D), vectors
    ``x``, ``r``, ``p``, ``Sp`` (N, D), scalars ``rz``, ``rr``,
    ``thresh_sq`` and the int32 ``it`` (0-d tensors) -> the trip's ``(x, r,
    z, p, rz, rr, it)``, new tensors. Convergence masks the step sizes: a
    trip that starts with ``rr <= thresh_sq`` moves neither x, r nor rz."""
    live = rr > thresh_sq
    denom = torch.sum(p * Sp)
    alpha = torch.where(live, rz / torch.where(denom == 0, 1.0, denom), 0.0)
    x = x + alpha * p
    r = r - alpha * Sp
    z = block_jacobi_apply(P, r, free_pose)
    rz_new = torch.sum(r * z)
    rr = torch.sum(r * r)
    beta = torch.where(live, rz_new / torch.where(rz == 0, 1.0, rz), 0.0)
    p = z + beta * p
    rz = torch.where(live, rz_new, rz)
    it = it + live.to(torch.int32)
    return x, r, z, p, rz, rr, it


_PCG_LIB = _build.library("schur_pcg", ("schur_pcg.cu",), {
    "pcg_trip_f32": dict(argtypes=[_P] * 7 + [_I, _P, _P, _I, _I, _I, _P],
                         restype=_I),
    "pcg_trip_scratch_floats": dict(argtypes=[_I, _I], restype=_LL)})


def _pcg_shape_fault(x, P, free_pose):
    """What of a CG solve's shapes the trip kernel does not take, as a
    message, or None: ``x`` (N, D) with 0 < D <= PCG_MAX_D and N * D <
    2^31, ``P`` (N, D, D), ``free_pose`` (N,) or (N, D)."""
    N, D = x.shape if x.dim() == 2 else (-1, -1)
    if x.dim() != 2 or not 0 < D <= PCG_MAX_D or N * D > _INT32_MAX:
        return (f"x must be (N, D) with 0 < D <= {PCG_MAX_D} and N * D < "
                f"2^31, got {tuple(x.shape)}")
    if tuple(P.shape) != (N, D, D):
        return f"P must be ({N}, {D}, {D}), got {tuple(P.shape)}"
    if tuple(free_pose.shape) not in ((N,), (N, D)):
        return (f"free_pose must be ({N},) or ({N}, {D}), got "
                f"{tuple(free_pose.shape)}")
    return None


def takes_pcg_trip(b, P, free_pose) -> bool:
    """Whether :func:`pcg_trip`'s kernel takes a CG solve of ``b`` (N, D)
    under the preconditioner blocks ``P`` and ``free_pose``: on the card,
    float32, in the shapes :func:`pcg_trip` checks (0 < D <= PCG_MAX_D, P
    (N, D, D), free_pose (N,) or (N, D))."""
    return (b.is_cuda and _pcg_shape_fault(b, P, free_pose) is None
            and all(t.dtype == torch.float32 for t in (b, P, free_pose)))


def _check_pcg_inputs(P, free_pose, vectors, state):
    """The CG trip's operands on one CUDA device, float32, contiguous:
    ``vectors`` (name, (N, D)) in the shapes :func:`_pcg_shape_fault`
    takes, with ``P`` and ``free_pose``; ``state`` (4,). Returns (N, D,
    free_cols)."""
    x = vectors[0][1]
    fault = _pcg_shape_fault(x, P, free_pose)
    if fault is not None:
        raise ValueError(f"pcg_trip: {fault}")
    N, D = x.shape
    for name, t in vectors:
        if tuple(t.shape) != (N, D):
            raise ValueError(f"pcg_trip: {name} must be ({N}, {D}), got "
                             f"{tuple(t.shape)}")
    if tuple(state.shape) != (4,):
        raise ValueError(f"pcg_trip: state must be (4,), got "
                         f"{tuple(state.shape)}")
    named = (*vectors, ("P", P), ("free_pose", free_pose), ("state", state))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"pcg_trip: {name} is on {t.device}, x on "
                             f"{x.device}; they must share one device")
    _check_f32("pcg_trip", named, x.device)
    return N, D, 0 if free_pose.dim() == 1 else D


@counts_launches
def pcg_trip(P: torch.Tensor, free_pose: torch.Tensor, x: torch.Tensor,
             r: torch.Tensor, z: torch.Tensor, p: torch.Tensor,
             state: torch.Tensor):
    """The trips of one preconditioned CG solve, each after its matvec:
    returns ``trip(Sp)``, which runs one trip of
    :func:`pcg_trip_reference` on ``Sp = S p`` and writes its results in
    place: x, r, z and p into their buffers, rz, rr and it into ``state``.

    ``P`` (N, D, D) inverted preconditioner blocks, ``free_pose`` (N,) or
    (N, D), the vectors ``x``, ``r``, ``z``, ``p`` (N, D), ``state`` (4,)
    float32: rz, rr, thresh_sq and the int32 iteration count in the bits
    of the fourth float (``state[3:].view(torch.int32)``).

    On CUDA the operands are checked here, once a solve (float32, 0 < D <=
    15, contiguous, one device, distinct vector buffers; other inputs
    raise), and the device's current stream taken, on which every trip
    launches; each ``trip(Sp)`` then
    checks ``Sp`` (float32, (N, D), contiguous, none of the four vectors)
    and makes one ctypes call into ``csrc/schur_pcg.cu``, three launches
    that read nothing back to the host, counted in ``pcg_trip.launches``
    (one a trip); a launch the card refuses raises. The three dots add in
    the kernel's fixed order, not ``torch.sum``'s. On CPU tensors each trip
    runs :func:`pcg_trip_reference` and copies its results in, bit for bit
    its numbers."""
    if x.device.type == "cpu":
        it = state[3:].view(torch.int32)[0]

        def plain_trip(Sp):
            out = pcg_trip_reference(P, free_pose, x, r, p, Sp, state[0],
                                     state[1], state[2], it)
            for buf, v in zip((x, r, z, p, state[0], state[1], it), out):
                buf.copy_(v)
        return plain_trip
    vectors = (("x", x), ("r", r), ("z", z), ("p", p))
    N, D, free_cols = _check_pcg_inputs(P, free_pose, vectors, state)
    if x.device.type != "cuda":
        raise ValueError(f"pcg_trip: unsupported device {x.device}")
    owned = frozenset(t.data_ptr() for _, t in vectors)
    if len(owned) != len(vectors):
        raise ValueError("pcg_trip: x, r, z and p must be distinct buffers")
    lib, _ = _build.load(_PCG_LIB)
    fn = lib.pcg_trip_f32
    scratch = torch.empty(lib.pcg_trip_scratch_floats(N, D),
                          dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    device = x.device.index
    shape = x.shape
    bufs = (p, x, r, z, P, free_pose, state, scratch)
    p_, x_, r_, z_, P_, free_, state_, scratch_ = (t.data_ptr() for t in bufs)

    def trip(Sp):
        if (Sp.dtype != torch.float32 or Sp.shape != shape
                or not Sp.is_contiguous() or Sp.get_device() != device
                or Sp.data_ptr() in owned):
            raise ValueError(f"pcg_trip: Sp must be a float32 ({N}, {D}) "
                             f"contiguous tensor on cuda:{device}, apart "
                             f"from x, r, z and p")
        err = fn(p_, Sp.data_ptr(), x_, r_, z_, P_, free_, free_cols, state_,
                 scratch_, N, D, device, stream)
        if err != 0:
            raise RuntimeError(f"pcg_trip_f32 launch failed: CUDA error "
                               f"{err}")
        pcg_trip.launches += 1

    trip.buffers = bufs  # alive while the kernel may use them
    return trip
