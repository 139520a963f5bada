"""Pinhole camera model (port of ``libwave_tpu.vision.camera``'s
``pinhole_project`` and ``in_image``): project world points through
``K [R_CG | -R_CG p]`` with a cheirality flag, batched over any leading
dimensions of points and camera poses."""

from __future__ import annotations

import torch

from libwave_tpu_torch.geometry import so3


def pinhole_project(K, q_GC, p_GC, points_G):
    """Project world points into the image. ``K`` (3, 3), ``q_GC`` (..., 4)
    camera-to-world orientation, ``p_GC`` (..., 3) camera position,
    ``points_G`` (..., 3) broadcast against the cameras. Returns pixel
    coordinates (..., 2) and in-front flags (...,)."""
    pc = so3.quat_rotate(so3.quat_inverse(q_GC), points_G - p_GC)
    h = torch.einsum("ij,...j->...i", K.to(pc.dtype), pc)
    z = h[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    return h[..., :2] / safe_z[..., None], z > 0


def in_image(uv, image_width, image_height):
    """Strict interior test: 0 < u < W and 0 < v < H."""
    u, v = uv[..., 0], uv[..., 1]
    return (u > 0) & (u < image_width) & (v > 0) & (v < image_height)
