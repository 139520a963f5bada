"""Segment kernels of the Schur system (port of ``libwave_tpu.ops.segmm``).

Three kernels, each a hand-written Hopper kernel built with ``nvcc`` for
``sm_90a`` at first use and bound with ``ctypes``:

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
  the landmark-side broadcast.

Each wrapper launches its kernel on a CUDA tensor (or raises on inputs the
kernel does not take) and counts the launch in its ``launches`` attribute;
on a CPU tensor it runs the plain PyTorch version beside it
(``*_reference``), which nothing on the card path calls.

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
import functools
from typing import NamedTuple

import torch

from libwave_tpu_torch.ops import _build

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


_KERNEL_SOURCES = ["segmm_g_a.cu"]
_KERNEL_ROWS = 18  # Dj * 3 rows the CUDA kernel is instantiated for
_TILE_POSES = 4  # poses per block of the G/A kernel (kTP in segmm_g_a.cu)
_SEG_SOURCES = ["segmm_seg.cu"]
_SEG_TYPES = {torch.float32: "f32", torch.float64: "f64"}
_INT32_MAX = 2**31 - 1


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


@functools.cache
def _library() -> tuple[ctypes.CDLL, str]:
    lib, log = _build.load("segmm_g_a", _KERNEL_SOURCES)
    fn = lib.segmm_g_a_window_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, log


def build() -> str:
    """Build (or reuse) and load the CUDA library; returns the compiler's
    ``-Xptxas -v`` report."""
    return _library()[1]


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
    lib, _ = _library()
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = lib.segmm_g_a_window_f32(
            W.data_ptr(), ell.sigma.data_ptr(), ell.offsets.data_ptr(),
            hinv.data_ptr(), G.data_ptr(), A.data_ptr(), N, P, M, C, c0, c1,
            plo, phi, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"segmm_g_a_window_f32 launch failed: CUDA error {err}")
    dense_g_a_window.launches += 1
    return G, A


# Kernel launches since the count was last reset (the CPU path adds nothing).
dense_g_a_window.launches = 0


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


@functools.cache
def _seg_library() -> tuple[ctypes.CDLL, str]:
    lib, log = _build.load("segmm_seg", _SEG_SOURCES)
    for t in _SEG_TYPES.values():
        fn = getattr(lib, f"seg_reduce_sorted_{t}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"seg_broadcast_{t}")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, log


def build_seg() -> str:
    """Build (or reuse) and load the segment reduce/broadcast library;
    returns the compiler's ``-Xptxas -v`` report."""
    return _seg_library()[1]


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


def _launch(fn_name, *args):
    lib, _ = _seg_library()
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")


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
    _launch(f"seg_reduce_sorted_{_SEG_TYPES[vals.dtype]}", vals, sigma,
            offsets, out, C, K, M)
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
    _launch(f"seg_broadcast_{_SEG_TYPES[y.dtype]}", y, idx, out, C, K, M)
    seg_broadcast.launches += 1
    return out


# Kernel launches since the counts were last reset (CPU paths add nothing).
seg_reduce_sorted.launches = 0
seg_broadcast.launches = 0
