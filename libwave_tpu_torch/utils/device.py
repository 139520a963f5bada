"""The device a public entry point of the port runs on.

Entry points take ``device=None`` and then run on the current CUDA device;
the CPU only when the caller asks for it (``device="cpu"``, as the tests
do). Nothing falls back to the CPU when there is no card: allocating on
``"cuda"`` then raises.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; None is ``"cuda"``."""
    return torch.device("cuda" if device is None else device)


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor for an entry point that takes ``device=None``. A
    tensor stays on its own device unless ``device`` names one; anything
    else (a list, a numpy array, a number) goes to :func:`resolve`'s
    device. ``dtype``, if given, is the result's."""
    if isinstance(x, torch.Tensor):
        if device is None:
            return x if dtype is None else x.to(dtype)
        return x.to(device=resolve(device), dtype=dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve(device))
