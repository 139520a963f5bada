"""Pinhole camera model (port of ``libwave_tpu.vision.camera``): project
world points through ``K [R_CG | -R_CG p]`` with a cheirality flag, batched
over any leading dimensions of points and camera poses; the focal length of
a field of view; back-projection at a depth."""

from __future__ import annotations

import torch

from libwave_tpu_torch.geometry import so3


def focal_length(fov, image_size):
    """Focal length from field of view (radians) and image size in pixels
    (utils.hpp:25); elementwise for 2-vector hfov/vfov."""
    fov = torch.as_tensor(fov)
    return torch.as_tensor(image_size, dtype=fov.dtype) / (
        2.0 * torch.tan(fov / 2.0))


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


def pinhole_project_frames(K, q_GC, p_GC, points_G):
    """All-pairs projection: cameras (T, ...) x points (M, 3) -> uv
    (T, M, 2), in_front (T, M)."""
    return pinhole_project(
        K, q_GC[:, None, :], p_GC[:, None, :], points_G[None, :, :]
    )


def in_image(uv, image_width, image_height):
    """Strict interior test: 0 < u < W and 0 < v < H."""
    u, v = uv[..., 0], uv[..., 1]
    return (u > 0) & (u < image_width) & (v > 0) & (v < image_height)


def backproject(K, q_GC, p_GC, uv, depth):
    """Image point -> world point at the given camera-frame depth (gtsam
    SimpleCamera::backproject); broadcasts over leading dimensions."""
    K = torch.as_tensor(K)
    uv = torch.as_tensor(uv)
    x = (uv[..., 0] - K[0, 2]) / K[0, 0]
    y = (uv[..., 1] - K[1, 2]) / K[1, 1]
    depth = torch.as_tensor(depth, dtype=x.dtype, device=x.device)
    pc = torch.stack([x, y, torch.ones_like(x)], dim=-1) * depth[..., None]
    return so3.quat_rotate(q_GC, pc) + p_GC
