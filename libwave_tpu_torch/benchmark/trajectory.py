"""Trajectory comparison: interpolation, pose error, ATE / RPE.

Port of ``libwave_tpu.benchmark.trajectory``: geodesic interpolation of a
time-stamped pose stream, per-pose translation and so(3) errors with CSV
export, Umeyama SE(3) alignment, absolute trajectory error (ATE RMSE) and
relative pose error (RPE) over an index delta.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libwave_tpu_torch.geometry import se3, so3
from libwave_tpu_torch.geometry.se3 import SE3


class Trajectory(NamedTuple):
    """Time-stamped pose stream."""

    times: torch.Tensor  # (T,)
    poses: SE3  # q (T, 4), t (T, 3)


def interpolate_at(traj: Trajectory, query_times: torch.Tensor) -> SE3:
    """Geodesic interpolation of the pose stream at query times. Queries
    outside the time range clamp to the end poses."""
    t = traj.times
    qt = torch.clip(torch.as_tensor(query_times, dtype=t.dtype,
                                    device=t.device), t[0], t[-1])
    hi = torch.clip(torch.searchsorted(t, qt, right=True), 1, t.shape[0] - 1)
    lo = hi - 1
    denom = t[hi] - t[lo]
    alpha = (qt - t[lo]) / torch.where(denom == 0, 1.0, denom)
    P_lo = SE3(q=traj.poses.q[lo], t=traj.poses.t[lo])
    P_hi = SE3(q=traj.poses.q[hi], t=traj.poses.t[hi])
    return se3.interpolate(P_lo, P_hi, alpha)


def pose_error(truth: SE3, estimate: SE3):
    """(translation error (.., 3), rotation error (.., 3) in so(3))."""
    return estimate.t - truth.t, so3.quat_boxminus(estimate.q, truth.q)


def trajectory_error(truth: Trajectory, measured: Trajectory):
    """Interpolate truth at the measurement times and difference. Returns
    (trans_err (T, 3), rot_err (T, 3))."""
    return pose_error(interpolate_at(truth, measured.times), measured.poses)


def write_error_csv(path: str, times, trans_err, rot_err) -> None:
    """CSV export: time, translation error xyz, so(3) error xyz."""
    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    data = np.concatenate(
        [host(times)[:, None], host(trans_err), host(rot_err)], axis=-1
    )
    np.savetxt(path, data, delimiter=",")


def align_trajectories_umeyama(truth_t: torch.Tensor, est_t: torch.Tensor):
    """SE(3) Umeyama alignment of estimate positions onto truth. Returns the
    aligning SE3 (applied to the estimate)."""
    cp = torch.mean(est_t, dim=0)
    cq = torch.mean(truth_t, dim=0)
    H = (est_t - cp).T @ (truth_t - cq)
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = Vt.T @ D @ U.T
    return SE3(q=so3.rot_to_quat(R), t=cq - R @ cp)


def absolute_trajectory_error(truth: Trajectory, estimate: Trajectory,
                              align: bool = True):
    """ATE: RMSE of translation error after (optional) SE3 alignment, with
    truth interpolated at the estimate's times. Returns (ate_rmse,
    per-pose errors)."""
    truth_at = interpolate_at(truth, estimate.times)
    est = estimate.poses
    if align:
        T = align_trajectories_umeyama(truth_at.t, est.t)
        est = SE3(q=so3.quat_multiply(T.q.expand(est.q.shape), est.q),
                  t=T.apply(est.t))
    err = torch.linalg.norm(est.t - truth_at.t, dim=-1)
    return torch.sqrt(torch.mean(err * err)), err


def relative_pose_error(truth: Trajectory, estimate: Trajectory,
                        delta: int = 1):
    """RPE over an index delta: the error of relative motions
    truth_i -> truth_{i+d} against est_i -> est_{i+d}. Returns (trans_rmse,
    rot_rmse, (per-pair translation errors, per-pair rotation errors))."""
    truth_at = interpolate_at(truth, estimate.times)

    def rel(P: SE3, d):
        A = SE3(q=P.q[:-d], t=P.t[:-d])
        B = SE3(q=P.q[d:], t=P.t[d:])
        return A.inverse().compose(B)

    err = rel(truth_at, delta).inverse().compose(rel(estimate.poses, delta))
    terr = torch.linalg.norm(err.t, dim=-1)
    rerr = torch.linalg.norm(so3.log_quat(err.q), dim=-1)
    return (
        torch.sqrt(torch.mean(terr * terr)),
        torch.sqrt(torch.mean(rerr * rerr)),
        (terr, rerr),
    )
