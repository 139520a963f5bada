"""Euler-angle conversions (sequences 321 and 123) and angle wrapping.

Port of ``libwave_tpu.geometry.euler``; every function broadcasts over
leading batch dimensions. The euler vector is ``[phi, theta, psi]``
(rotations about x, y, z); sequence ``321`` composes
``Rz(psi) @ Ry(theta) @ Rx(phi)``, sequence ``123`` is its transpose.
"""

from __future__ import annotations

import math

import torch

from libwave_tpu_torch.geometry import so3


def wrap_to_pi(angle: torch.Tensor) -> torch.Tensor:
    """Wrap radians to (-pi, pi]."""
    return math.pi - torch.remainder(math.pi - angle, 2.0 * math.pi)


def wrap_to_two_pi(angle: torch.Tensor) -> torch.Tensor:
    """Wrap radians to [0, 2*pi)."""
    return torch.remainder(angle, 2.0 * math.pi)


def wrap_to_180(deg: torch.Tensor) -> torch.Tensor:
    """Wrap degrees to [-180, 180)."""
    return torch.remainder(deg + 180.0, 360.0) - 180.0


def wrap_to_360(deg: torch.Tensor) -> torch.Tensor:
    """Wrap degrees to [0, 360)."""
    return torch.remainder(deg, 360.0)


def deg2rad(d):
    return torch.as_tensor(d) * (math.pi / 180.0)


def rad2deg(r):
    return torch.as_tensor(r) * (180.0 / math.pi)


def _rot(a, rows):
    """Stack a (..., 3, 3) rotation from row templates over c, s, 0, 1."""
    v = {"c": torch.cos(a), "s": torch.sin(a), "-s": -torch.sin(a),
         "0": torch.zeros_like(a), "1": torch.ones_like(a)}
    return torch.stack(
        [torch.stack([v[k] for k in row], dim=-1) for row in rows], dim=-2)


def _rot_x(a):
    return _rot(a, (("1", "0", "0"), ("0", "c", "-s"), ("0", "s", "c")))


def _rot_y(a):
    return _rot(a, (("c", "0", "s"), ("0", "1", "0"), ("-s", "0", "c")))


def _rot_z(a):
    return _rot(a, (("c", "-s", "0"), ("s", "c", "0"), ("0", "0", "1")))


def _check_seq(seq):
    if seq not in (321, 123):
        raise ValueError(f"unsupported euler sequence {seq}; use 321 or 123")


def euler2rot(euler: torch.Tensor, seq: int = 321) -> torch.Tensor:
    """Euler [phi, theta, psi] -> rotation matrix. seq in {321, 123}."""
    _check_seq(seq)
    phi, theta, psi = euler[..., 0], euler[..., 1], euler[..., 2]
    R = _rot_z(psi) @ _rot_y(theta) @ _rot_x(phi)
    return R if seq == 321 else R.transpose(-1, -2)


def euler2quat(euler: torch.Tensor, seq: int = 321) -> torch.Tensor:
    """Euler [phi, theta, psi] -> unit quaternion [w, x, y, z]."""
    _check_seq(seq)
    half = 0.5 * euler
    c1, c2, c3 = (torch.cos(half[..., k]) for k in range(3))
    s1, s2, s3 = (torch.sin(half[..., k]) for k in range(3))
    q = torch.stack(
        [
            c1 * c2 * c3 + s1 * s2 * s3,
            s1 * c2 * c3 - c1 * s2 * s3,
            c1 * s2 * c3 + s1 * c2 * s3,
            c1 * c2 * s3 - s1 * s2 * c3,
        ],
        dim=-1,
    )
    if seq == 123:
        # euler2rot(e, 123) == euler2rot(e, 321).T, hence the conjugate.
        q = so3.quat_conjugate(q)
    return so3.quat_normalize(q)


def quat2euler(q: torch.Tensor, seq: int = 321) -> torch.Tensor:
    """Unit quaternion -> euler [phi, theta, psi] for seq in {321, 123}."""
    _check_seq(seq)
    if seq == 123:
        q = so3.quat_conjugate(q)  # inverse of the conjugation in euler2quat
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    phi = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    theta = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    psi = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([phi, theta, psi], dim=-1)
