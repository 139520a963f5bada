"""Segment kernels of the Schur system (port of ``libwave_tpu.ops.segmm``).

Three kernels, each a hand-written Hopper kernel built with ``nvcc`` for
``sm_90a`` at first use and bound with ``ctypes``:

- :func:`dense_g_a` (``csrc/segmm_g_a.cu``): the fused dense-Schur G/A
  build. The dense reduced camera system (``optim.schur.
  dense_reduced_system``) needs the scatter G of per-observation W blocks
  into landmark columns and A = G Hll^-1; both come out of one pass;
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
with the ELL layout) sequentially, one thread per (channel, landmark),
without atomics, so kernel and plain version add in the same order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from libwave_tpu_torch.ops import _build

# symmetric-3x3 component index for (j, l), both triangles
_SYM3_AT = {
    (0, 0): 0, (0, 1): 1, (0, 2): 2,
    (1, 0): 1, (1, 1): 3, (1, 2): 4,
    (2, 0): 2, (2, 1): 4, (2, 2): 5,
}

_KERNEL_SOURCES = ["segmm_g_a.cu"]
_KERNEL_ROWS = 18  # Dj * 3 rows the CUDA kernel is instantiated for
_SEG_SOURCES = ["segmm_seg.cu"]
_SEG_TYPES = {torch.float32: "f32", torch.float64: "f64"}
_INT32_MAX = 2**31 - 1


def dense_g_a_reference(W: torch.Tensor, lm_slot: torch.Tensor,
                        hinv: torch.Tensor):
    """Plain PyTorch G/A build: ``W`` (Dj*3, N, Pmax), ``lm_slot`` (N, Pmax)
    landmark ids, ``hinv`` (6, M) symmetric inverse landmark blocks ->
    ``(G, A)`` each (N, Dj*3, M) in ``W``'s dtype. Ids outside ``[0, M)``
    are masked out before any indexing and contribute zeros."""
    C, N, P = W.shape
    M = hinv.shape[1]
    Dj = C // 3
    ok = (lm_slot >= 0) & (lm_slot < M)
    idx = torch.where(ok, lm_slot, 0).long()
    vals = torch.where(ok[None], W, 0.0).permute(1, 0, 2)  # (N, C, P)
    G = torch.zeros((N, C, M), dtype=W.dtype, device=W.device)
    G.scatter_add_(2, idx[:, None, :].expand(N, C, P), vals)
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


@functools.cache
def _library() -> tuple[ctypes.CDLL, str]:
    lib, log = _build.load("segmm_g_a", _KERNEL_SOURCES)
    fn = lib.segmm_g_a_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, log


def build() -> str:
    """Build (or reuse) and load the CUDA library; returns the compiler's
    ``-Xptxas -v`` report."""
    return _library()[1]


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
    C, N, P = W.shape
    if C != _KERNEL_ROWS:
        raise ValueError(
            f"dense_g_a on CUDA is built for Dj*3 = {_KERNEL_ROWS} rows, "
            f"got {C}"
        )
    if tuple(lm_slot.shape) != (N, P) or hinv.shape[0] != 6:
        raise ValueError(
            f"dense_g_a: shapes W {tuple(W.shape)}, lm_slot "
            f"{tuple(lm_slot.shape)}, hinv {tuple(hinv.shape)} disagree"
        )
    if N > 65535:
        raise ValueError(f"dense_g_a: at most 65535 pose rows per call, got {N}")
    for name, t in (("W", W), ("lm_slot", lm_slot), ("hinv", hinv)):
        if not t.is_contiguous():
            raise ValueError(f"dense_g_a: {name} must be contiguous")


def dense_g_a(W: torch.Tensor, lm_slot: torch.Tensor, hinv: torch.Tensor):
    """Fused dense-Schur G/A build: ``W`` (Dj*3, N, Pmax) pose-ELL blocks
    (component-major, padding slots zero), ``lm_slot`` (N, Pmax) landmark
    ids, ``hinv`` (6, M) inverted landmark blocks (symmetric components).

    Entries of ``lm_slot`` outside ``[0, M)`` contribute zeros: chunked and
    banded callers pass ``lm_slot - c0`` with a ``hinv`` column slice.

    On CUDA this launches ``csrc/segmm_g_a.cu`` on the current stream and
    counts the launch in ``dense_g_a.launches``; inputs it does not take
    raise. On CPU it returns :func:`dense_g_a_reference`.
    """
    if W.device.type == "cpu":
        return dense_g_a_reference(W, lm_slot, hinv)
    if W.device.type != "cuda":
        raise ValueError(f"dense_g_a: unsupported device {W.device}")
    _check_cuda_inputs(W, lm_slot, hinv)
    C, N, P = W.shape
    M = hinv.shape[1]
    G = torch.empty((N, C, M), dtype=W.dtype, device=W.device)
    A = torch.empty_like(G)
    if N == 0 or M == 0:
        return G, A
    lib, _ = _library()
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = lib.segmm_g_a_f32(
            W.data_ptr(), lm_slot.data_ptr(), hinv.data_ptr(),
            G.data_ptr(), A.data_ptr(), N, P, M, C, stream,
        )
    if err != 0:
        raise RuntimeError(f"segmm_g_a_f32 launch failed: CUDA error {err}")
    dense_g_a.launches += 1
    return G, A


# Kernel launches since the count was last reset (the CPU path adds nothing).
dense_g_a.launches = 0


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


def sorted_layout(idx: torch.Tensor, num_segments: int):
    """(sigma, offsets) int32 of ids ``idx`` (K,): a stable sort and the
    CSR bounds of every segment in ``[0, num_segments)``, on ``idx``'s
    device and without a host read. Ids outside the range fall outside
    every segment."""
    ids, sigma = torch.sort(idx.to(torch.int32), stable=True)
    bounds = torch.arange(num_segments + 1, dtype=torch.int32,
                          device=idx.device)
    offsets = torch.searchsorted(ids, bounds)
    return sigma.to(torch.int32), offsets.to(torch.int32)


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
