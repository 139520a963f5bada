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
