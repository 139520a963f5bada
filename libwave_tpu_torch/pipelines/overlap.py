"""Pipelined front-end / back-end overlap.

Port of ``libwave_tpu.pipelines.overlap``. The reference overlaps the two
stages through JAX's asynchronous dispatch, optionally on different
devices: window t's back-end solve is dispatched, window t+1's front end
runs while it does, and only then is the solve's result waited on.

On one card the counterpart of another device is another CUDA stream:
``frontend_stream`` and ``backend_stream`` (``torch.cuda.Stream``) put the
stages on separate streams of one card, ``frontend_device`` and
``backend_device`` on separate devices. A hand-off between streams makes
the consuming stream wait for the producing one (``wait_stream``) and
marks every handed tensor as used there (``record_stream``), so the
caching allocator cannot reuse its memory while the other stream still
reads it. Stage functions that read a device value on the host block the
host, and with it the enqueueing of the other stage.

Results are bit-identical to the serial schedule: the same functions run
on the same inputs, only the order in which they are enqueued changes.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch


def _map(fn, x):
    """``fn`` on every tensor of a nest of tuples, NamedTuples, lists and
    dicts."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_map(fn, v) for v in x)
    return x


def _put(tree, device):
    if device is None:
        return tree
    return _map(lambda t: t.to(device), tree)


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()


def _hand_off(tree, src, dst):
    """Make stream ``dst`` wait for ``src``'s work so far and mark every
    tensor of ``tree`` as used on ``dst`` (None: the current stream)."""
    if src is None and dst is None:
        return tree
    src = src or torch.cuda.current_stream()
    dst = dst or torch.cuda.current_stream()
    if src == dst:
        return tree
    dst.wait_stream(src)

    def mark(t):
        if t.is_cuda:
            t.record_stream(dst)
        return t

    return _map(mark, tree)


def _wait(stream):
    """Block the host until ``stream`` (None: nothing to wait for on the
    CPU; the current CUDA stream when one is in use) has finished."""
    if stream is not None:
        stream.synchronize()
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


def pipelined_windows(
    frontend: Callable,
    backend: Callable,
    frames: Sequence,
    frontend_device=None,
    backend_device=None,
    frontend_stream: torch.cuda.Stream | None = None,
    backend_stream: torch.cuda.Stream | None = None,
):
    """Software-pipelined window processing.

    ``frontend(frame) -> features`` and ``backend(features) -> result`` are
    functions of tensors (or nests of them). For each window ``t`` the
    schedule enqueues ``backend(features_t)`` and, before waiting on it,
    ``frontend(frames[t+1])``: the classic two-stage pipeline. With the
    stages on their own streams (or devices) the card can run both at once.

    Returns the list of back-end results, one per frame, each ready for
    the caller's current stream."""
    results = []
    if len(frames) == 0:
        return results
    fs, bs = frontend_stream, backend_stream
    with _on(fs):
        feats = frontend(_put(frames[0], frontend_device))
    for t in range(len(frames)):
        handed = _put(_hand_off(feats, fs, bs), backend_device)
        with _on(bs):
            pending = backend(handed)
        if t + 1 < len(frames):
            # overlap: next window's front end while the solve runs
            with _on(fs):
                feats = frontend(_put(frames[t + 1], frontend_device))
        _wait(bs)
        results.append(_hand_off(pending, bs, None))
    return results


def serial_windows(frontend: Callable, backend: Callable, frames: Sequence,
                   frontend_device=None, backend_device=None):
    """The unpipelined schedule, on the current stream (for equivalence
    checks and timing baselines)."""
    results = []
    for f in frames:
        feats = frontend(_put(f, frontend_device))
        _wait(None)
        out = backend(_put(feats, backend_device))
        _wait(None)
        results.append(out)
    return results
