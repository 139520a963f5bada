"""Fixed-capacity masked point clouds and voxel downsampling.

Port of ``libwave_tpu.matching.pointcloud``. A cloud is a fixed
``(..., N, 3)`` tensor with an ``(..., N)`` validity mask; leading
dimensions batch clouds (scan pairs, a sequence). The voxel filter is a
sort-based exact segment mean (points in one voxel average to one point),
keeping the input capacity and masking the tail.

The segment sums run over the sorted order as a log-depth segmented scan
(:func:`sorted_segment_sum`): no atomics, so two runs on the card give the
same bits, where ``index_add_`` would add floats in no fixed order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.utils.device import resolve

INT32_MAX = 0x7FFFFFFF


class PointCloud(NamedTuple):
    points: torch.Tensor  # (..., N, 3)
    mask: torch.Tensor  # (..., N) bool

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def count(self):
        return self.mask.to(torch.int32).sum(-1)


def make_cloud(points, mask=None, device=None) -> PointCloud:
    """A cloud of ``points``; every point valid unless ``mask`` says
    otherwise. A tensor stays on its device; numpy data goes to ``device``
    (default: the card)."""
    if not isinstance(points, torch.Tensor) or device is not None:
        points = torch.as_tensor(points, device=resolve(device))
    if mask is None:
        mask = torch.ones(points.shape[:-1], dtype=torch.bool,
                          device=points.device)
    return PointCloud(points=points,
                      mask=torch.as_tensor(mask, device=points.device))


def apply_points(T: SE3, points: torch.Tensor) -> torch.Tensor:
    """``T`` (batch shape ``(...)``) applied to ``points`` (``(..., N, 3)``)."""
    return SE3(q=T.q[..., None, :], t=T.t[..., None, :]).apply(points)


def transform_cloud(T: SE3, cloud: PointCloud) -> PointCloud:
    return PointCloud(points=apply_points(T, cloud.points), mask=cloud.mask)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points[..., idx, :]`` per batch element: (..., M, C) points by
    (..., N, ...) indices."""
    idx = idx.to(torch.int64)
    flat = idx.reshape(idx.shape[:points.dim() - 2] + (-1,))
    out = torch.take_along_dim(points, flat[..., None], dim=-2)
    return out.reshape(idx.shape + points.shape[-1:])


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` rounded as IEEE division on every device. PyTorch's CUDA
    kernel divides by a host scalar as a product with its reciprocal,
    which can round across an integer; a 0-d tensor of ``x``'s dtype on
    its device is divided exactly, as on the CPU and in XLA."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def _voxel_hash(pts: torch.Tensor, leaf: float) -> torch.Tensor:
    """Spatial hash of voxel coordinates (int32) with the JAX package's
    bits: the int32 products and XORs wrap in two's complement, so they are
    taken in int64 and folded to the low 32 bits as a signed value."""
    ijk = torch.floor(div(pts, leaf)).to(torch.int32).to(torch.int64)
    h = (ijk[..., 0] * 73856093) ^ (ijk[..., 1] * 19349663) \
        ^ (ijk[..., 2] * 83492791)
    h = h & 0xFFFFFFFF
    return torch.where(h > INT32_MAX, h - (1 << 32), h).to(torch.int32)


def sorted_segment_sum(x: torch.Tensor, seg: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Sums of ``x`` (..., N, C) over runs of equal ``seg`` (..., N),
    which is non-decreasing along N, into (..., num_segments, C).

    A Hillis-Steele segmented scan (log2 N steps: each element adds the
    partial sum ``d`` places back while that is in its run), then the last
    element of each run is written to its segment. The order of the
    additions is fixed, so the result is the same bits on every run."""
    N = x.shape[-2]
    s = x
    d = 1
    while d < N:
        same = (seg[..., d:] == seg[..., :-d])[..., None]
        s = torch.cat([s[..., :d, :],
                       s[..., d:, :] + torch.where(same, s[..., :-d, :], 0)],
                      dim=-2)
        d *= 2
    last = torch.ones_like(seg, dtype=torch.bool)
    last[..., :-1] = seg[..., 1:] != seg[..., :-1]
    idx = torch.where(last, seg, num_segments).to(torch.int64)
    out = s.new_zeros(s.shape[:-2] + (num_segments + 1, s.shape[-1]))
    out.scatter_(-2, idx[..., None].expand(s.shape), s)
    return out[..., :num_segments, :]


# matrices per torch.linalg.eigh call: cuSOLVER's batched symmetric
# eigensolver (torch 2.11, CUDA 12.8, H100) takes batches of 3x3 matrices
# up to 16,384 and refuses 32,768 and more (49 clouds of 4,096 points are
# 200,704)
EIGH_CHUNK = 8192


def eigh3(C: torch.Tensor):
    """``torch.linalg.eigh`` of (..., 3, 3) symmetric matrices, in chunks
    of at most :data:`EIGH_CHUNK` matrices. Eigenvalues ascending, as
    ``jnp.linalg.eigh``'s."""
    flat = C.reshape(-1, 3, 3)
    parts = [torch.linalg.eigh(flat[k:k + EIGH_CHUNK])
             for k in range(0, flat.shape[0], EIGH_CHUNK)]
    vals = torch.cat([p[0] for p in parts]).reshape(C.shape[:-1])
    vecs = torch.cat([p[1] for p in parts]).reshape(C.shape)
    return vals, vecs


def sort_segments(key: torch.Tensor, valid: torch.Tensor):
    """Stable sort of ``key`` (..., N) (``torch.argsort(stable=True)``, as
    ``jnp.argsort``). Returns (order, sorted keys, sorted valid, first, seg):
    ``first`` marks the first valid element of each run of equal keys,
    ``seg`` is each element's run index, N - 1 for invalid elements."""
    N = key.shape[-1]
    ks, order = torch.sort(key, dim=-1, stable=True)
    vs = torch.take_along_dim(valid, order, dim=-1)
    first = torch.ones_like(vs)
    first[..., 1:] = ks[..., 1:] != ks[..., :-1]
    first = first & vs
    seg = torch.cumsum(first.to(torch.int64), dim=-1) - 1
    seg = torch.where(vs, seg, N - 1)
    return order, ks, vs, first, seg


def voxel_downsample(cloud: PointCloud, leaf: float) -> PointCloud:
    """Average points within each voxel of side ``leaf`` (pcl::VoxelGrid
    semantics). Output keeps capacity N with a mask over unique voxels."""
    N = cloud.capacity
    h = _voxel_hash(cloud.points, leaf)
    key = torch.where(cloud.mask, h, INT32_MAX)
    order, _, valid_sorted, first, seg = sort_segments(key, cloud.mask)
    pts_sorted = torch.take_along_dim(cloud.points, order[..., None], dim=-2)
    sums = sorted_segment_sum(
        torch.where(valid_sorted[..., None], pts_sorted, 0.0), seg, N)
    counts = sorted_segment_sum(
        valid_sorted.to(pts_sorted.dtype)[..., None], seg, N)[..., 0]
    num_voxels = first.to(torch.int64).sum(-1)
    mask = torch.arange(N, device=seg.device) < num_voxels[..., None]
    means = sums / torch.clamp(counts, min=1.0)[..., None]
    return PointCloud(points=torch.where(mask[..., None], means, 0.0),
                      mask=mask)


def synthetic_scan(seed: int, n: int = 4096, dtype=torch.float32,
                   device=None) -> PointCloud:
    """Structured synthetic lidar scan: room walls, ground plane with gentle
    slope, and scattered box obstacles. The JAX package draws ``seed`` as
    ``int(jax.random.randint(key, (), 0, 2**31 - 1))``; here the caller
    passes that integer. As in the JAX package, when ``n % 8 != 0`` the
    zero points that pad the scan to ``n`` stay valid."""
    rng = np.random.default_rng(seed)
    pts = []
    per = n // 8
    g = np.stack(
        [
            rng.uniform(-10, 10, 2 * per),
            rng.uniform(-10, 10, 2 * per),
            np.zeros(2 * per),
        ],
        axis=-1,
    )
    g[:, 2] = 0.02 * g[:, 0] + 0.01 * g[:, 1] + rng.normal(0, 0.01, 2 * per)
    pts.append(g)
    for axis, pos in ((0, -10.0), (1, 10.0)):
        w = np.stack(
            [
                rng.uniform(-10, 10, per),
                rng.uniform(-10, 10, per),
                rng.uniform(0, 4, per),
            ],
            axis=-1,
        )
        w[:, axis] = pos + rng.normal(0, 0.01, per)
        pts.append(w)
    for _ in range(4):
        c = rng.uniform(-8, 8, 2)
        size = rng.uniform(0.5, 1.5)
        face = rng.integers(0, 3, per)
        b = np.stack(
            [
                c[0] + rng.uniform(-size, size, per),
                c[1] + rng.uniform(-size, size, per),
                rng.uniform(0, 2 * size, per),
            ],
            axis=-1,
        )
        b[face == 0, 0] = c[0] + size
        b[face == 1, 1] = c[1] - size
        b[face == 2, 2] = 2 * size
        pts.append(b)
    all_pts = np.concatenate(pts, axis=0)[:n]
    if all_pts.shape[0] < n:
        all_pts = np.concatenate(
            [all_pts, np.zeros((n - all_pts.shape[0], 3))], axis=0)
    return make_cloud(torch.as_tensor(all_pts).to(dtype).to(resolve(device)))
