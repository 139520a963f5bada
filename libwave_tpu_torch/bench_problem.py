"""The headline bundle-adjustment problem and its LM timing, without JAX.

:func:`make_problem` is a numpy-only copy of ``bench.py``'s ``make_problem``
(200 poses on a circle, 10,000 landmarks in a ring with ids ordered by
bearing, 300 genuinely visible observations per pose, f32, pose-ELL layout
plus a covisibility :class:`~libwave_tpu_torch.optim.schur.BandPlan`). For
the same arguments it gives bit-identical arrays. The problem is built on
the host, outside any timed window, and moved to ``device``.

:func:`bench_backend` times full LM iterations with ``bench.py``'s
``bench_backend`` configuration (10 iterations, 20 CG steps, tolerance
1e-5, convergence freeze off).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from libwave_tpu_torch.optim import schur
from libwave_tpu_torch.optim.ba import BAConfig, BAProblem, BAState, solve_ba


def _quat_multiply_np(a, b):
    w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def _quat_to_rot_np(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    R = np.empty(q.shape[:-1] + (3, 3), dtype=q.dtype)
    R[..., 0, 0] = 1 - 2 * (yy + zz)
    R[..., 0, 1] = 2 * (xy - wz)
    R[..., 0, 2] = 2 * (xz + wy)
    R[..., 1, 0] = 2 * (xy + wz)
    R[..., 1, 1] = 1 - 2 * (xx + zz)
    R[..., 1, 2] = 2 * (yz - wx)
    R[..., 2, 0] = 2 * (xz - wy)
    R[..., 2, 1] = 2 * (yz + wx)
    R[..., 2, 2] = 1 - 2 * (xx + yy)
    return R


def _q_bc_np(dtype=np.float64):
    """Body->camera mount: Rz(-90deg) * Rx(-90deg)."""
    c = np.cos(np.pi / 4).astype(dtype)
    s = np.sin(np.pi / 4).astype(dtype)
    qz = np.array([c, 0, 0, -s], dtype=dtype)
    qx = np.array([c, -s, 0, 0], dtype=dtype)
    return _quat_multiply_np(qz, qx)


def make_problem(num_poses=200, num_landmarks=10_000, obs_per_pose=300,
                 seed=0, device="cpu"):
    """Synthetic BA problem with ~num_poses*obs_per_pose observations,
    built on the host from ``seed`` and returned on ``device``."""
    rng = np.random.default_rng(seed)
    # landmarks in a ring around a circular trajectory; ids ordered by
    # bearing, the id order a real mapper produces, which gives the
    # pose/landmark incidence the locality every SLAM map has
    lm = np.stack(
        [
            rng.uniform(-50, 50, num_landmarks),
            rng.uniform(-50, 50, num_landmarks),
            rng.uniform(-2, 2, num_landmarks),
        ],
        axis=-1,
    ).astype(np.float64)
    lm = lm[np.argsort(np.arctan2(lm[:, 1], lm[:, 0]), kind="stable")]
    theta = np.linspace(0, 2 * np.pi, num_poses, endpoint=False)
    p = np.stack(
        [10 * np.cos(theta), 10 * np.sin(theta), np.zeros_like(theta)],
        axis=-1,
    )
    # camera yaw follows the tangent; q = exp([0,0,yaw]) * q_BC
    yaw = theta + np.pi / 2
    q_yaw = np.stack(
        [
            np.cos(yaw / 2),
            np.zeros_like(yaw),
            np.zeros_like(yaw),
            np.sin(yaw / 2),
        ],
        axis=-1,
    )
    q = _quat_multiply_np(q_yaw, _q_bc_np())

    Kmat = np.array(
        [[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]], dtype=np.float64
    )

    # observations must be genuinely visible (inside the image, sane depth)
    R = _quat_to_rot_np(q)  # (N, 3, 3) camera-to-world
    d = lm[None, :, :] - p[:, None, :]  # (N, M, 3)
    pc = np.einsum("nji,nmj->nmi", R, d)  # R^T (X - p)
    h = np.einsum("ij,nmj->nmi", Kmat, pc)
    z = h[..., 2]
    in_front = z > 0
    uv_all = h[..., :2] / np.where(np.abs(z) < 1e-12, 1e-12, z)[..., None]
    depth_ok = np.linalg.norm(d, axis=-1) > 1.0
    in_img = (
        in_front
        & depth_ok
        & (uv_all[..., 0] >= 0) & (uv_all[..., 0] < 640)
        & (uv_all[..., 1] >= 0) & (uv_all[..., 1] < 480)
    )

    pose_idx_l, lm_idx_l, uv_l, w_l = [], [], [], []
    for n in range(num_poses):
        ids = np.nonzero(in_img[n])[0]
        rng.shuffle(ids)
        take = ids[:obs_per_pose]
        pad = obs_per_pose - take.size
        pose_idx_l.append(np.full(obs_per_pose, n, dtype=np.int32))
        lm_idx_l.append(
            np.concatenate([take, np.zeros(pad, dtype=np.int64)]).astype(
                np.int32
            )
        )
        uv_l.append(
            np.concatenate(
                [uv_all[n, take], np.zeros((pad, 2))]
            ).astype(np.float32)
        )
        w_l.append(
            np.concatenate(
                [np.ones(take.size, np.float32), np.zeros(pad, np.float32)]
            )
        )
    pose_idx = np.concatenate(pose_idx_l)
    lm_idx = np.concatenate(lm_idx_l)
    uv = np.concatenate(uv_l, axis=0)
    weight = np.concatenate(w_l)

    free = np.ones(num_poses, dtype=np.float32)
    free[:2] = 0
    pose_ell, lm_ell, pad_mask, ell, uv_p, w_p = schur.pack_observations(
        pose_idx, lm_idx, num_poses, num_landmarks, uv, weight, device=device
    )
    bands = schur.compute_band_plan(
        lm_ell, pad_mask, num_poses, num_landmarks
    )

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x, dtype=dtype), device=device)

    problem = BAProblem(
        K=t(Kmat, np.float32),
        pose_idx=pose_ell,
        lm_idx=lm_ell,
        uv=uv_p,
        weight=w_p,
        free_pose=t(free, np.float32),
        ell=ell,
        bands=bands,
    )
    state = BAState(
        q=t(q, np.float32),
        p=t(p, np.float32),
        lm=t(lm + 0.1, np.float32),
    )
    return problem, state


def bench_config(iters: int = 10) -> BAConfig:
    """``bench.py``'s ``bench_backend`` configuration: ``iters`` LM
    iterations, 20 CG steps at tolerance 1e-5, convergence freeze off so
    every iteration does full work."""
    return BAConfig(
        max_iterations=iters,
        cg_max_iters=20,
        cg_tol=1e-5,
        relative_decrease_tol=0.0,
        absolute_decrease_tol=0.0,
    )


def _median(times):
    times = sorted(times)
    m = len(times) // 2
    return times[m] if len(times) % 2 else 0.5 * (times[m - 1] + times[m])


def bench_backend(problem, state, iters=10, repeats=3):
    """Time full LM solves: one warm-up, then the median of ``repeats``
    solves, each stopped after the device finished and the final cost was
    fetched to the host. Returns (LM iterations/s, final cost)."""
    cfg = bench_config(iters)

    def run_once():
        if state.p.is_cuda:
            torch.cuda.synchronize(state.p.device)
        t0 = time.perf_counter()
        _, info = solve_ba(problem, state, cfg)
        if state.p.is_cuda:
            torch.cuda.synchronize(state.p.device)
        cost = float(info["final_cost"])
        return time.perf_counter() - t0, cost

    run_once()  # warm-up: kernel build and library load, allocator
    times = []
    cost = 0.0
    for _ in range(repeats):
        dt, cost = run_once()
        times.append(dt)
    return iters / _median(times), cost
