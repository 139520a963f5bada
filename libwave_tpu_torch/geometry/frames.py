"""Axis-permutation conversions between body/world frame conventions (port
of ``libwave_tpu.geometry.frames``).

The reference's frame helpers (wave_utils/src/math.cpp:258-303:
``enu2nwu``, ``ned2enu``, ``ned2nwu``, ``nwu2enu``, ``nwu2ned``,
``nwu2edn``), batched over leading dims.

Frame axis meanings:
- ENU: x-east(right), y-north(forward), z-up
- NWU: x-forward, y-left, z-up
- NED: x-forward, y-right, z-down
- EDN: x-right, y-down, z-forward (camera convention)
"""

from __future__ import annotations

import torch


def enu2nwu(enu: torch.Tensor) -> torch.Tensor:
    return torch.stack([enu[..., 1], -enu[..., 0], enu[..., 2]], dim=-1)


def nwu2enu(nwu: torch.Tensor) -> torch.Tensor:
    return torch.stack([-nwu[..., 1], nwu[..., 0], nwu[..., 2]], dim=-1)


def ned2enu(ned: torch.Tensor) -> torch.Tensor:
    return torch.stack([ned[..., 1], ned[..., 0], -ned[..., 2]], dim=-1)


def nwu2edn(nwu: torch.Tensor) -> torch.Tensor:
    return torch.stack([-nwu[..., 1], -nwu[..., 2], nwu[..., 0]], dim=-1)


def _flip_yz(q: torch.Tensor) -> torch.Tensor:
    """q * [1, 1, -1, -1] (negation is exact, and no host constant is
    copied to the device)."""
    return torch.cat([q[..., :2], -q[..., 2:]], dim=-1)


def ned2nwu_quat(q: torch.Tensor) -> torch.Tensor:
    """NED-frame attitude quaternion -> NWU (negate y, z components)."""
    return _flip_yz(q)


def nwu2ned_quat(q: torch.Tensor) -> torch.Tensor:
    """NWU-frame attitude quaternion -> NED (involution of ned2nwu_quat)."""
    return _flip_yz(q)
