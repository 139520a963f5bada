"""Full-f32 matmul accumulation for numerics-critical code.

Counterpart of ``libwave_tpu.utils.precision.f32_matmuls``. On an NVIDIA
card a float32 matmul may run in TF32 (about three decimal digits) when a
caller allowed it, and cuDNN convolutions default to TF32. Solver-grade
linear algebra cannot take that: normal equations and CG dot products lose
the digits Levenberg-Marquardt acceptance depends on, and a
reduced-precision pass in the G/A build broke LM steps in the reference
(``libwave_tpu/ops/segmm.py:213-220``).

Decorate the entry points of solver code with :func:`f32_matmuls`; every
call beneath runs with TF32 off in cuBLAS and cuDNN, and the caller's
settings come back on return. PyTorch releases with per-backend
``fp32_precision`` settings get those set to "ieee"; older ones get
``allow_tf32 = False`` and float32 matmul precision "highest". The two
APIs are never mixed, since newer releases refuse reads after a mix.
"""

from __future__ import annotations

import contextlib
import functools

import torch


def _new_api() -> bool:
    return hasattr(torch.backends.cuda.matmul, "fp32_precision")


def _cudnn_conv():
    return torch.backends.cudnn.conv


@contextlib.contextmanager
def full_f32():
    """Turn TF32 off in cuBLAS and cuDNN for the body; restore the
    previous settings after."""
    if _new_api():
        mm, conv = torch.backends.cuda.matmul, _cudnn_conv()
        saved = (mm.fp32_precision, conv.fp32_precision)
        mm.fp32_precision = "ieee"
        conv.fp32_precision = "ieee"
        try:
            yield
        finally:
            mm.fp32_precision, conv.fp32_precision = saved
    else:
        saved = (
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision(),
        )
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(saved[2])
            torch.backends.cuda.matmul.allow_tf32 = saved[0]
            torch.backends.cudnn.allow_tf32 = saved[1]


def tf32_enabled() -> bool:
    """True if a float32 CUDA matmul or cuDNN convolution issued now may
    use TF32."""
    if _new_api():
        # "none" inherits the parent setting: conv -> cudnn -> global
        root = torch.backends.fp32_precision

        def effective(*chain):
            return next((p for p in chain if p != "none"), root)

        return "tf32" in (
            effective(torch.backends.cuda.matmul.fp32_precision),
            effective(_cudnn_conv().fp32_precision,
                      torch.backends.cudnn.fp32_precision),
        )
    return (
        torch.backends.cuda.matmul.allow_tf32
        or torch.backends.cudnn.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    )


def f32_matmuls(fn):
    """Run ``fn`` under :func:`full_f32`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with full_f32():
            return fn(*args, **kwargs)

    return wrapped
