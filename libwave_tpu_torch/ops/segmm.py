"""Fused dense-Schur G/A build (port of ``libwave_tpu.ops.segmm``'s G/A kernel).

The dense reduced camera system (``optim.schur.dense_reduced_system``) needs
the scatter G of per-observation W blocks into landmark columns and
A = G Hll^-1. :func:`dense_g_a` builds both in one pass:

- on a CUDA tensor it launches the hand-written Hopper kernel
  ``csrc/segmm_g_a.cu`` (built with ``nvcc`` for ``sm_90a`` at first use,
  bound with ``ctypes``), or raises;
- on a CPU tensor it runs :func:`dense_g_a_reference`, the plain PyTorch
  version of the same function.

Both follow the reference kernel's f32 contract (``libwave_tpu/ops/
segmm.py:213-241``): G is summed and rounded to f32 and A is formed in f32
from f32 G and Hinv, whatever the storage dtype. The output layout is
(N, Dj*3, M) with rows ordered (dj, j), so that
``x.reshape(N*Dj, 3*M)`` is the 2D operand of ``S_sub = A2 @ G2.T``.

The reference's one-hot segment reduce and broadcast kernels are not on the
bundle-adjustment path and are not ported yet (see ROADMAP.md, section B).
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
