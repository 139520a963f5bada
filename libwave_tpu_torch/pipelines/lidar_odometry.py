"""Lidar odometry: sequence-level scan registration -> trajectory.

Port of ``libwave_tpu.pipelines.lidar_odometry``:

1. **all pairs at once**: every (scan_t, scan_{t+1}) pair goes through the
   matcher as one batch (the matchers take a leading batch dimension);
2. **trajectory composition as a parallel prefix**: absolute poses are the
   running product T_0 ∘ Δ_1 ∘ ... ∘ Δ_t, a log-depth doubling scan of
   batched quaternion products on the device (:func:`_compose_scan`);
3. **optional pose-graph refinement**: per-pair LUM information weights a
   between-factor chain solved by
   :func:`libwave_tpu_torch.optim.pose_graph.solve_pose_graph`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.matching.icp import (
    ICPParams,
    estimate_info_lum,
    icp_match,
)
from libwave_tpu_torch.matching.pointcloud import PointCloud
from libwave_tpu_torch.optim.pose_graph import (
    BetweenBank,
    PoseGraphConfig,
    PriorBank,
    solve_pose_graph,
)

__all__ = ["LidarOdometryConfig", "LidarOdometryResult", "lidar_odometry"]


@dataclass(frozen=True)
class LidarOdometryConfig:
    """Pipeline knobs. ``matcher`` follows the reference's Matcher<T> family:
    any ``(ref, target, params) -> result-with-.transform`` callable
    (icp_match / gicp_match / ndt_match); ``icp`` holds its parameters."""

    icp: ICPParams = ICPParams()
    estimate_information: bool = True
    refine_pose_graph: bool = False
    pose_graph: PoseGraphConfig = PoseGraphConfig(max_iterations=8)


class LidarOdometryResult(NamedTuple):
    trajectory: SE3          # (T,) absolute poses, frame 0 = identity
    relative: SE3            # (T-1,) scan-to-scan transforms
    information: torch.Tensor  # (T-1, 6, 6) per-edge information or eye
    converged: torch.Tensor   # (T-1,) bool per pair
    iterations: torch.Tensor  # (T-1,) matcher iterations per pair


def _combine(a: SE3, b: SE3) -> SE3:
    return SE3(q=so3.quat_multiply(a.q, b.q),
               t=so3.quat_rotate(a.q, b.t) + a.t)


def _compose_scan(rel: SE3, T0: Optional[SE3] = None) -> SE3:
    """Absolute trajectory from relative transforms: an inclusive prefix
    product in log2(T) doubling steps (each step composes every element
    with the partial product ``d`` places back), then the start pose."""
    prefix = rel
    n = rel.q.shape[0]
    d = 1
    while d < n:
        head = SE3(q=prefix.q[:d], t=prefix.t[:d])
        tail = _combine(SE3(q=prefix.q[:-d], t=prefix.t[:-d]),
                        SE3(q=prefix.q[d:], t=prefix.t[d:]))
        prefix = SE3(q=torch.cat([head.q, tail.q]),
                     t=torch.cat([head.t, tail.t]))
        d *= 2
    first = SE3.identity(dtype=rel.t.dtype, device=rel.t.device) \
        if T0 is None else T0
    # prepend the pose of frame 0 and left-compose the start pose
    q = torch.cat([first.q[None], so3.quat_multiply(first.q, prefix.q)])
    t = torch.cat([first.t[None], so3.quat_rotate(first.q, prefix.t)
                   + first.t])
    return SE3(q=so3.quat_normalize(q), t=t)


def lidar_odometry(
    scans: PointCloud,
    config: LidarOdometryConfig = LidarOdometryConfig(),
    matcher=icp_match,
    T0: Optional[SE3] = None,
) -> LidarOdometryResult:
    """Estimate a trajectory from a sequence of lidar scans.

    ``scans`` carries a leading time axis: points (T, N, 3), mask (T, N);
    it runs on the tensors' device. ``matcher(ref, target).transform``
    maps ref (scan t) coordinates into target (scan t+1) coordinates; the
    relative sensor motion is its inverse, Δ_t = T_t⁻¹ T_{t+1}, and
    absolute poses are the running product T_{t+1} = T_t ∘ Δ_t.
    """
    pts, mask = scans.points, scans.mask
    res = matcher(PointCloud(points=pts[:-1], mask=mask[:-1]),
                  PointCloud(points=pts[1:], mask=mask[1:]), config.icp)
    rel = res.transform.inverse()
    if config.estimate_information and hasattr(res, "correspondences"):
        info = estimate_info_lum(res)
    else:
        info = torch.eye(6, dtype=pts.dtype, device=pts.device).expand(
            rel.t.shape[:-1] + (6, 6))
    traj = _compose_scan(rel, T0)

    if config.refine_pose_graph:
        # diagonal sqrt-information from the information matrices, as the
        # JAX package passes them (ROADMAP.md §C: LUM orders its 6 DOF
        # translation first, the between bank rotation first)
        diag = torch.clamp(torch.diagonal(info, dim1=-2, dim2=-1), 1e-6, 1e8)
        n = traj.q.shape[0]
        i = torch.arange(0, n - 1, dtype=torch.int32, device=pts.device)
        bank = BetweenBank(i=i, j=i + 1, dq=rel.q, dp=rel.t,
                           sqrt_info=torch.sqrt(diag))
        prior = PriorBank(
            i=torch.zeros((1,), dtype=torch.int32, device=pts.device),
            q=traj.q[:1],
            p=traj.t[:1],
            sqrt_info=torch.full((1, 6), 1e3, dtype=traj.t.dtype,
                                 device=pts.device),
        )
        q, p, _ = solve_pose_graph(traj.q, traj.t, bank, prior,
                                   cfg=config.pose_graph)
        traj = SE3(q=q, t=p)

    return LidarOdometryResult(
        trajectory=traj,
        relative=rel,
        information=info,
        converged=res.converged,
        iterations=res.iterations,
    )
