"""Hamming distances over packed binary descriptors (port of
``libwave_tpu.ops.hamming``).

Descriptors are (N, W) ``torch.int32`` tensors holding the reference's
uint32 bit patterns (``vision.descriptor``). Two functions, each a
hand-written Hopper kernel in ``csrc/hamming.cu`` beside its plain PyTorch
version:

- :func:`hamming_top2`: per query row, the best distance, the second-best
  distance and the first index reaching the best, without the (N1, N2)
  table: the knnMatch(k=2) of the ratio test. Replaces the Pallas
  ``_top2_kernel``.
- :func:`hamming_distance`: the full (N1, N2) int32 table, as a 1-bit
  matrix product on the tensor cores. Replaces the Pallas ``_kernel``.

On a CUDA tensor each wrapper launches its kernel (built with ``nvcc`` for
``sm_90a`` at first use, bound with ``ctypes``) or raises; on a CPU tensor it
returns the plain version. Each wrapper counts its launches in
``<wrapper>.launches``, registered with ``utils.trace.counts_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from libwave_tpu_torch.ops import _build
from libwave_tpu_torch.utils.trace import counts_launches

BIG = 1 << 24  # distance of a masked reference row
_WORDS = (1, 2, 4, 8, 16, 32)  # descriptor widths the kernels are built for
_CHUNK_BYTES = 1 << 26  # bytes of XOR words per chunk of the plain versions


def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 words -> (...) int32 count of set bits: a bitwise
    popcount of every byte of a uint8 view (no sign extension), summed."""
    x = x.contiguous().view(torch.uint8)
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    x = (x + (x >> 4)) & 0x0F
    return x.sum(-1, dtype=torch.int32)


def _popcount_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(c, W) x (N2, W) int32 words -> (c, N2) int32 Hamming distances."""
    return popcount_words(torch.bitwise_xor(a[:, None, :], b[None, :, :]))


def _row_chunks(n1: int, n2: int, w: int):
    step = max(1, _CHUNK_BYTES // max(1, n2 * w * 4))
    return [(i, min(n1, i + step)) for i in range(0, n1, step)]


def hamming_distance_reference(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch (N1, W) x (N2, W) -> (N1, N2) int32 table, in chunks of
    query rows so that the (N1, N2, W) XOR never exists whole."""
    n1, w = d1.shape
    out = torch.empty((n1, d2.shape[0]), dtype=torch.int32, device=d1.device)
    for lo, hi in _row_chunks(n1, d2.shape[0], w):
        out[lo:hi] = _popcount_rows(d1[lo:hi], d2)
    return out


def hamming_top2_reference(d1: torch.Tensor, d2: torch.Tensor,
                           mask2: torch.Tensor | None = None):
    """Plain PyTorch top-2: ``argmin`` (first occurrence) of each row's
    masked distances, then the minimum with that one column masked.
    Returns (best, second, idx), each (N1,) int32."""
    n1, w = d1.shape
    n2 = d2.shape[0]
    dev = d1.device
    best = torch.full((n1,), BIG, dtype=torch.int32, device=dev)
    second = torch.full((n1,), BIG, dtype=torch.int32, device=dev)
    idx = torch.zeros((n1,), dtype=torch.int32, device=dev)
    if n2 == 0:
        return best, second, idx
    big = torch.full((), BIG, dtype=torch.int32, device=dev)
    for lo, hi in _row_chunks(n1, n2, w):
        dist = _popcount_rows(d1[lo:hi], d2)
        if mask2 is not None:
            dist = torch.where(mask2[None, :].bool(), dist, big)
        i1 = torch.argmin(dist, dim=1)
        best[lo:hi] = torch.gather(dist, 1, i1[:, None])[:, 0]
        second[lo:hi] = dist.scatter(1, i1[:, None], big.expand(hi - lo, 1)).min(1)[0]
        idx[lo:hi] = i1.to(torch.int32)
    return best, second, idx


_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = _build.library("hamming", ("hamming.cu",), {
    "hamming_top2_i32": dict(argtypes=[_P] * 6 + [_I] * 3 + [_P],
                             restype=_I),
    "hamming_table_i32": dict(argtypes=[_P] * 3 + [_I] * 3 + [_P],
                              restype=_I)})


def _check_cuda_inputs(fn: str, d1: torch.Tensor, d2: torch.Tensor,
                       mask2: torch.Tensor | None = None):
    for name, t in (("d2", d2), ("mask2", mask2)):
        if t is not None and t.device != d1.device:
            raise ValueError(
                f"{fn}: d1 and {name} must share one device, got {d1.device} "
                f"and {t.device}"
            )
    if d1.dtype != torch.int32 or d2.dtype != torch.int32:
        raise TypeError(
            f"{fn} on CUDA takes int32 descriptor words, got {d1.dtype} and "
            f"{d2.dtype}"
        )
    if d1.dim() != 2 or d2.dim() != 2 or d1.shape[1] != d2.shape[1]:
        raise ValueError(
            f"{fn}: expected d1 (N1, W) and d2 (N2, W), got "
            f"{tuple(d1.shape)} and {tuple(d2.shape)}"
        )
    if d1.shape[1] not in _WORDS:
        raise ValueError(
            f"{fn} on CUDA is built for W in {_WORDS} words, got {d1.shape[1]}"
        )
    if mask2 is not None and (mask2.dtype != torch.bool
                              or tuple(mask2.shape) != (d2.shape[0],)):
        raise ValueError(f"{fn}: mask2 must be a bool (N2,) tensor")
    for name, t in (("d1", d1), ("d2", d2), ("mask2", mask2)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


@counts_launches
def hamming_top2(d1: torch.Tensor, d2: torch.Tensor,
                 mask2: torch.Tensor | None = None):
    """Fused Hamming + per-row top-2: (N1, W) x (N2, W) int32 words ->
    (best (N1,), second (N1,), idx (N1,)) int32, the knnMatch(k=2) the ratio
    test needs, without the (N1, N2) table. ``mask2`` (N2,) bool invalidates
    reference rows (their distance reads ``BIG``).

    On CUDA this launches ``csrc/hamming.cu``'s top-2 kernel on the current
    stream and counts the launch in ``hamming_top2.launches``; inputs it
    does not take raise. On CPU it returns :func:`hamming_top2_reference`.
    """
    if d1.device.type == "cpu":
        return hamming_top2_reference(d1, d2, mask2)
    if d1.device.type != "cuda":
        raise ValueError(f"hamming_top2: unsupported device {d1.device}")
    _check_cuda_inputs("hamming_top2", d1, d2, mask2)
    n1, w = d1.shape
    outs = [torch.empty((n1,), dtype=torch.int32, device=d1.device)
            for _ in range(3)]
    if n1 == 0:
        return tuple(outs)
    _build.launch(_LIB, "hamming_top2_i32", d1, d2, mask2, *outs, n1,
                  d2.shape[0], w)
    hamming_top2.launches += 1
    return tuple(outs)


@counts_launches
def hamming_distance(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(N1, W) x (N2, W) int32 words -> (N1, N2) int32 Hamming distances.

    On CUDA this launches ``csrc/hamming.cu``'s table kernel on the current
    stream and counts the launch in ``hamming_distance.launches``; inputs it
    does not take raise. On CPU it returns
    :func:`hamming_distance_reference`.
    """
    if d1.device.type == "cpu":
        return hamming_distance_reference(d1, d2)
    if d1.device.type != "cuda":
        raise ValueError(f"hamming_distance: unsupported device {d1.device}")
    _check_cuda_inputs("hamming_distance", d1, d2)
    n1, w = d1.shape
    n2 = d2.shape[0]
    out = torch.empty((n1, n2), dtype=torch.int32, device=d1.device)
    if n1 == 0 or n2 == 0:
        return out
    _build.launch(_LIB, "hamming_table_i32", d1, d2, out, n1, n2, w)
    hamming_distance.launches += 1
    return out
