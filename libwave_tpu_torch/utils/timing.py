"""Wall-clock timers (port of ``libwave_tpu.utils.timing``).

Parity with the reference's matlab-style timers (tic/toc/mtoc/time_now).
:class:`Timer` waits for the card's outstanding work before it reads the
clock (CUDA launches return before the work is done).
"""

from __future__ import annotations

import time
from typing import Optional

import torch


def time_now() -> float:
    return time.monotonic()


def tic() -> float:
    """Start a timer; returns an opaque tick to pass to :func:`toc`."""
    return time.monotonic()


def toc(t: float) -> float:
    """Seconds since ``tic()``."""
    return time.monotonic() - t


def mtoc(t: float) -> float:
    """Milliseconds since ``tic()``."""
    return (time.monotonic() - t) * 1e3


def _devices(tree, out):
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _devices(v, out)
    return out


class Timer:
    """Context-manager timer that waits for the device work it times.

    >>> with Timer() as t:
    ...     result = fn(x)
    ...     t.block_on(result)
    >>> t.elapsed  # seconds

    On exit, the card of every CUDA tensor in what :meth:`block_on` was
    given is synchronized before the clock is read."""

    def __init__(self) -> None:
        self.elapsed: Optional[float] = None
        self._result = None

    def __enter__(self) -> "Timer":
        self._start = time.monotonic()
        return self

    def block_on(self, tree) -> None:
        self._result = tree

    def __exit__(self, *exc) -> bool:
        if self._result is not None:
            for dev in _devices(self._result, set()):
                torch.cuda.synchronize(dev)
        self.elapsed = time.monotonic() - self._start
        return False
