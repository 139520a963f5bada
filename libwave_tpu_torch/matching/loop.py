"""Static-control-flow iteration for the registration solvers.

Port of ``libwave_tpu.matching.loop``. The reference runs ``max_iter``
trips of ``lax.scan`` with the body under ``lax.cond`` on a carried
``live`` flag; under ``vmap`` that ``cond`` is a select, so every pair's
body runs on every trip. Here the trips are a Python loop over a batch of
registrations: each trip runs the body for every batch element and
freezes the converged ones with ``torch.where`` on a device ``live`` mask.
Nothing is read back to the host inside the loop, so the trips stay
queued on the card.
"""

from __future__ import annotations

import torch


def select(live: torch.Tensor, new, old):
    """``new`` where ``live`` else ``old``, leaf by leaf over a tensor or a
    (named) tuple of tensors whose leading dimensions are ``live``'s."""
    if isinstance(new, torch.Tensor):
        cond = live.reshape(live.shape + (1,) * (new.dim() - live.dim()))
        return torch.where(cond, new, old)
    return type(new)(*(select(live, a, b) for a, b in zip(new, old)))


def converged_scan(body, init_state, max_iter: int, t_eps: float, live):
    """While-loop semantics with static control flow, over a batch.

    ``body(state) -> (new_state, delta)`` with ``delta`` of ``live``'s
    shape (the batch). A batch element's state stops changing after the
    first trip on which its ``delta <= t_eps`` (the reference's
    transform-epsilon rule); ``live`` is the initial mask (all True).
    Returns ``(state, iterations)``, ``iterations`` (int32, ``live``'s
    shape) counting each element's body executions."""
    state = init_state
    it = torch.zeros(live.shape, dtype=torch.int32, device=live.device)
    for _ in range(max_iter):
        new, delta = body(state)
        state = select(live, new, state)
        it = it + live.to(torch.int32)
        live = live & (delta > t_eps)
    return state, it
