"""Test predicates for numerical assertions (port of
``libwave_tpu.testing``).

Capability parity with the reference's gtest helper header ``wave/wave_test.hpp``
(wave_utils/include/wave/wave_test.hpp:17-30): ``VectorsNear``, ``MatricesNear``,
``VectorsNearPrec`` — promoted to framework-level helpers so downstream users
of the port get the same one-line comparisons in pytest that reference users
get in gtest. All helpers accept tensors (on any device: pulled to the host)
or numpy arrays and work on batches.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "vectors_near",
    "vectors_near_prec",
    "matrices_near",
    "assert_vectors_near",
    "assert_matrices_near",
]

_DEFAULT_PREC = 1e-4  # matches wave_test.hpp VectorsNear default tolerance


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)


def vectors_near(v1, v2, prec: float = _DEFAULT_PREC) -> bool:
    """True if ``max |v1 - v2| <= prec`` (wave_test.hpp:17 ``VectorsNear``)."""
    a, b = _host(v1), _host(v2)
    return a.shape == b.shape and bool(np.all(np.abs(a - b) <= prec))


def vectors_near_prec(v1, v2, prec: float) -> bool:
    """Explicit-precision variant (wave_test.hpp ``VectorsNearPrec``)."""
    return vectors_near(v1, v2, prec)


def matrices_near(m1, m2, prec: float = _DEFAULT_PREC) -> bool:
    """True if matrices match elementwise within prec (wave_test.hpp:24)."""
    return vectors_near(m1, m2, prec)


def assert_vectors_near(v1, v2, prec: float = _DEFAULT_PREC, msg: str = ""):
    """Assert with a diff report (pytest-friendly form of VectorsNear)."""
    a, b = _host(v1), _host(v2)
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {a.shape} vs {b.shape} {msg}")
    err = np.max(np.abs(a - b)) if a.size else 0.0
    if not err <= prec:  # NaN-safe: NaN fails
        raise AssertionError(
            f"max |diff| = {err:.3e} > {prec:.3e} {msg}\n a={a}\n b={b}"
        )


def assert_matrices_near(m1, m2, prec: float = _DEFAULT_PREC, msg: str = ""):
    assert_vectors_near(m1, m2, prec, msg)
