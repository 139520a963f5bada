"""Functional PID controller (port of ``libwave_tpu.controls.pid``).

The reference's scalar PID (wave_controls/include/wave/controls/pid.hpp:12,
src/pid.cpp:5 ``update``): proportional + integral(error·dt) +
derivative((e - e_prev)/dt). The state is an explicit tuple of tensors, so
controllers nest in simulation loops and broadcast over a batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libwave_tpu_torch.utils.device import resolve


class PIDGains(NamedTuple):
    k_p: torch.Tensor
    k_i: torch.Tensor
    k_d: torch.Tensor


class PIDState(NamedTuple):
    error_prev: torch.Tensor
    error_sum: torch.Tensor


def pid_init(shape=(), dtype=torch.float32, device=None) -> PIDState:
    z = torch.zeros(shape, dtype=dtype, device=resolve(device))
    return PIDState(error_prev=z, error_sum=z)


def pid_update(gains: PIDGains, state: PIDState, setpoint, actual, dt):
    """One PID step; returns (output, new_state). Broadcasts over batch."""
    error = setpoint - actual
    error_sum = state.error_sum + error * dt
    p = gains.k_p * error
    i = gains.k_i * error_sum
    d = gains.k_d * (error - state.error_prev) / dt
    return p + i + d, PIDState(error_prev=error, error_sum=error_sum)


def select(ready: torch.Tensor, new: PIDState, old: PIDState) -> PIDState:
    """Field-wise ``torch.where(ready, new, old)`` (a rate-limited
    controller keeps its old state between updates)."""
    return PIDState(*(torch.where(ready, n, o) for n, o in zip(new, old)))
