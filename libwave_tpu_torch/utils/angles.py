"""Angle wrapping (port of ``libwave_tpu.utils.angles``): ``wrap_to_pi``
maps any angle into [-pi, pi), ``wrap_to_two_pi`` into [0, 2*pi).
Elementwise over any shape, on the input's device."""

import math

import torch

from libwave_tpu_torch.utils.math import host_or_tensor

__all__ = ["wrap_to_pi", "wrap_to_two_pi"]


def wrap_to_pi(theta):
    """Wrap angle(s) to [-pi, pi): pi and -pi both become -pi. This is
    what the reference's code computes; its docstring states (-pi, pi],
    which its code does not give (a fault of the reference, kept)."""
    theta = host_or_tensor(theta)
    two_pi = 2.0 * math.pi
    return theta - two_pi * torch.floor((theta + math.pi) / two_pi)


def wrap_to_two_pi(theta):
    """Wrap angle(s) to [0, 2*pi)."""
    theta = host_or_tensor(theta)
    two_pi = 2.0 * math.pi
    return theta - two_pi * torch.floor(theta / two_pi)
