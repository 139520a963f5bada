"""Angle wrapping (port of ``libwave_tpu.utils.angles``): ``wrap_to_pi``
maps any angle into (-pi, pi], ``wrap_to_two_pi`` into [0, 2*pi).
Elementwise over any shape, on the input's device."""

import math

import torch

from libwave_tpu_torch.utils.math import host_or_tensor

__all__ = ["wrap_to_pi", "wrap_to_two_pi"]


def wrap_to_pi(theta):
    """Wrap angle(s) to (-pi, pi]: pi stays pi, -pi becomes pi (the
    reference's stated interval; its code sends both to -pi)."""
    theta = host_or_tensor(theta)
    two_pi = 2.0 * math.pi
    return theta + two_pi * torch.floor((math.pi - theta) / two_pi)


def wrap_to_two_pi(theta):
    """Wrap angle(s) to [0, 2*pi)."""
    theta = host_or_tensor(theta)
    two_pi = 2.0 * math.pi
    return theta - two_pi * torch.floor(theta / two_pi)
