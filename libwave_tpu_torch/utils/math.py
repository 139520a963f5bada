"""Small math helpers (port of ``libwave_tpu.utils.math``).

``fltcmp``, ``median`` (even length: the mean of the two middle values,
as ``jnp.median``; ``torch.median`` returns the lower one), ``vec2mat`` /
``mat2vec`` (column-major), ``randf`` / ``randi`` from an explicit
``torch.Generator`` (the reference takes a JAX key; the two give other
numbers from one seed).
"""

from __future__ import annotations

import numpy as np
import torch


def host_or_tensor(x, device=None) -> torch.Tensor:
    """A tensor stays as it is (moved to ``device`` when given); anything
    else goes through numpy (Python floats stay float64) to ``device``
    (default: the CPU)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def fltcmp(f1, f2, threshold: float = 1e-4):
    """-1/0/+1 comparison with tolerance: 0 where |f1 - f2| <= threshold."""
    f1 = host_or_tensor(f1, getattr(f2, "device", None))
    f2 = host_or_tensor(f2, f1.device)
    eq = torch.abs(f1 - f2) <= threshold
    one = torch.ones((), dtype=torch.int64, device=f1.device)
    return torch.where(eq, 0 * one, torch.where(f1 > f2, one, -one))


def median(v) -> torch.Tensor:
    """Median of all elements; an even count gives the mean of the two
    middle values."""
    v = host_or_tensor(v).reshape(-1)
    s = torch.sort(v).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) / 2


def vec2mat(x, rows: int, cols: int) -> torch.Tensor:
    """Column-major reshape of a vector into (rows, cols)."""
    return torch.as_tensor(x).reshape(cols, rows).T


def mat2vec(A) -> torch.Tensor:
    """Column-major flatten."""
    return torch.as_tensor(A).T.reshape(-1)


def randf(generator: torch.Generator, lo: float, hi: float, shape=()):
    """Uniform floats in [lo, hi), drawn from ``generator`` on its
    device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def randi(generator: torch.Generator, lo: int, hi: int, shape=()):
    """Uniform ints in [lo, hi), drawn from ``generator`` on its device."""
    return torch.randint(lo, hi, shape, generator=generator,
                         device=generator.device)
