"""Tracing and profiling utilities (port of ``libwave_tpu.utils.trace``).

- :func:`profile_trace` records a ``torch.profiler`` trace (CPU and, when
  a card is present, CUDA activity) and writes it under ``log_dir`` as a
  Chrome trace (``trace.json``) readable in Perfetto or TensorBoard;
- :func:`annotate` names a region for the profiler
  (``torch.profiler.record_function``);
- :class:`Counters` carries named diagnostic counters as a dict of 0-d
  tensors: the port's pytree of counters, read on the host only by
  :meth:`Counters.as_floats`.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Record a profiler trace of the block and write it to
    ``log_dir/trace.json``. Yields the ``torch.profiler.profile`` object
    (``key_averages()`` for sums by kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named profiler region (``with annotate("detect"): ...``)."""
    return torch.profiler.record_function(name)


class Counters(dict):
    """Named scalar counters accumulated through a pipeline, as 0-d
    tensors (adding never reads a device value on the host).

    >>> c = Counters.zeros("keypoints", "matches")
    >>> c = c.add(keypoints=mask.sum())
    """

    @staticmethod
    def zeros(*names: str, dtype=torch.int32, device=None) -> "Counters":
        return Counters({n: torch.zeros((), dtype=dtype, device=device)
                         for n in names})

    def add(self, **updates) -> "Counters":
        out = Counters(self)
        for k, v in updates.items():
            out[k] = out.get(k, 0) + v
        return out

    def as_floats(self) -> Dict[str, float]:
        return {k: float(v) for k, v in self.items()}
