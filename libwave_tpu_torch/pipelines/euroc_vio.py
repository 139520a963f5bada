"""End-to-end VIO on an EuRoC (ASL-format) sequence.

Port of ``libwave_tpu.pipelines.euroc_vio`` (BASELINE.md: EuRoC MH_01
ATE): load IMU + camera feature tracks through ``datasets.euroc``,
preintegrate every keyframe interval, triangulate an initial map from
dead-reckoned poses, solve the full VIO factor graph (Huber-robust against
track outliers) and report ATE against the dataset's ground truth.

What runs where:

- the loaders, the track bank, the landmark triangulation (one batched
  (M, 2V, 4) SVD per gating round) and the reprojection gating are host
  numpy in f64, as in the reference;
- the preintegration of all keyframe intervals is one batched
  ``preintegrate_imu`` call on ``device`` (the reference's ``vmap``), the
  dead reckoning and the camera matrices go through this package's
  ``pipelines.vio`` and ``geometry.so3``;
- the problem, the state and the solve live on ``device`` (default: the
  card) in ``dtype`` (default f32, as the reference solves at JAX's default
  f32; the cost sums stay f64). ``solve_vio`` is called directly: it reads
  nothing back from the device inside its LM loop.

Time stamps go on the device sequence-relative and in f64: ASL stamps are
epoch seconds near 1.4e9, which f32 collapses to one value.

``run_euroc_vio_from_images`` closes the loop from pixels: it reads the
cam0 PNGs with this package's own decoder (``vision.images``, no imaging
library), tracks them with ``pipelines.visual_frontend.track_sequence`` on
``device`` and solves the VIO from those tracks.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from libwave_tpu_torch.benchmark.trajectory import (
    Trajectory,
    absolute_trajectory_error,
    relative_pose_error,
)
from libwave_tpu_torch.datasets.euroc import (
    EUROC_CAM0_K,
    load_euroc_camera_index,
    load_euroc_ground_truth,
    load_euroc_imu,
    load_euroc_tracks,
)
from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.optim import schur
from libwave_tpu_torch.optim.imu import imu_sqrt_info, preintegrate_imu
from libwave_tpu_torch.pipelines.vio import (
    VIOConfig,
    VIOProblem,
    solve_vio,
    vio_dead_reckon,
)
from libwave_tpu_torch.sim.vo_dataset import q_BC as default_q_BC
from libwave_tpu_torch.utils.device import resolve


@dataclasses.dataclass(frozen=True)
class EurocVIOParams:
    pixel_sigma: float = 1.0
    huber_delta: float = 3.0  # whitened px: robust to track outliers
    max_keyframes: int = 0  # 0 = all camera frames
    min_track_length: int = 3
    # reprojection gate (px) against the dead-reckoned init: observations
    # beyond it are outliers the front end's RANSAC would reject; they are
    # weight-zeroed and landmarks re-triangulated from the survivors. The
    # gate must sit well ABOVE the dead-reckoning drift's pixel footprint
    # (gating at drift level would delete the correction signal itself) and
    # below the uniform-outlier scale (~hundreds of px).
    outlier_gate_px: float = 100.0
    gate_rounds: int = 2
    gyro_noise_density: float = 1.7e-4
    accel_noise_density: float = 2.0e-3
    bias_walk_sqrt_info: float = 1e3
    bias_prior_gyro: float = 1e2
    bias_prior_accel: float = 1e1


def _preintegrate_intervals(imu, cam_times, N, params, device,
                            dtype=torch.float32):
    """Preintegration of every keyframe interval (equal-length windows over
    a uniform IMU stream) as one batched call on ``device``: the
    ``(N - 1, steps, 3)`` windows are the batch. Returns (pim_stack,
    sqrt_infos)."""
    dt_imu = float(np.median(np.diff(imu.times)))
    steps = int(round((cam_times[1] - cam_times[0]) / dt_imu))
    starts = np.round(
        (np.asarray(cam_times[:-1]) - imu.times[0]) / dt_imu
    ).astype(np.int64)
    idx = np.minimum(starts[:, None] + np.arange(steps)[None, :],
                     len(imu.times) - 1)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype).to(device)

    z3 = torch.zeros(3, dtype=dtype, device=device)
    pim_stack = preintegrate_imu(
        dev(imu.gyro[idx]), dev(imu.accel[idx]), dt_imu, z3, z3,
        gyro_noise_density=params.gyro_noise_density,
        accel_noise_density=params.accel_noise_density,
    )
    return pim_stack, imu_sqrt_info(pim_stack)


def _track_bank(tracks, N, min_track_length, frame_offset=0,
                return_raw=False):
    """(frame, id, u, v) rows -> dense-id observation bank over keyframes
    [frame_offset, frame_offset + N), sorted by frame. Returns
    (pose_idx, lm_idx, uv, M), plus the per-observation ORIGINAL track id
    when ``return_raw`` (the windowed solvers track landmark identity
    across windows with it)."""
    frames = tracks[:, 0].astype(np.int64) - frame_offset
    keep = (frames >= 0) & (frames < N)
    frames = frames[keep]
    raw_ids = tracks[keep, 1].astype(np.int64)
    uv_all = tracks[keep, 2:4]
    uniq, inv, counts = np.unique(
        raw_ids, return_inverse=True, return_counts=True
    )
    long_enough = counts[inv] >= min_track_length
    frames = frames[long_enough]
    inv = inv[long_enough]
    uv_all = uv_all[long_enough]
    uniq2, lm_ids = np.unique(inv, return_inverse=True)
    M = len(uniq2)

    order = np.argsort(frames, kind="stable")
    out = (
        frames[order].astype(np.int32),
        lm_ids[order].astype(np.int32),
        uv_all[order],
        M,
    )
    if return_raw:
        return out + (uniq[inv][order],)
    return out


def _camera_P_mats(qs, ps, Kmat, qbc):
    """Batched pinhole projection matrices P = K [R^T | -R^T p] for body
    poses composed with the camera extrinsic rotation; host f64 in and
    out, the quaternion algebra through ``so3``."""
    qs = torch.as_tensor(np.array(qs, np.float64))
    qbc = torch.as_tensor(np.array(qbc, np.float64))
    R = so3.quat_to_rot(so3.quat_multiply(qs, qbc.expand(qs.shape))).numpy()
    P = np.zeros((len(R), 3, 4))
    P[:, :, :3] = np.einsum("ij,nkj->nik", np.asarray(Kmat), R)  # K R^T
    P[:, :, 3] = -np.einsum("nij,nj->ni", P[:, :, :3], np.asarray(ps))
    return P


def _spread_views(lm_idx, inlier, M, V=4):
    """Per-landmark selection of up to V observation indices spread across
    its track (inliers preferred; all observations when < 2 inliers
    survive). Fully vectorized. Returns (sel (M, V), mask (M, V))."""
    K_obs = len(lm_idx)
    cnt_all = np.bincount(lm_idx, minlength=M)
    cnt_in = np.bincount(lm_idx[inlier], minlength=M)
    use_all = cnt_in < 2
    # sort observations by landmark with outliers demoted to the tail of
    # each landmark's run (so the first `pool` entries are the usable set)
    demote = np.where(use_all[lm_idx], False, ~inlier)
    order = np.lexsort((np.arange(K_obs), demote, lm_idx))
    start = np.zeros(M, np.int64)
    np.cumsum(cnt_all[:-1], out=start[1:])
    pool = np.where(use_all, cnt_all, cnt_in)
    js = np.arange(V)
    pos = (js[None, :] * (np.maximum(pool, 1) - 1)[:, None]) // max(V - 1, 1)
    sel = order[np.minimum(start[:, None] + pos, max(K_obs - 1, 0))]
    mask = pool[:, None] > 0
    uniq = np.ones((M, V), bool)
    uniq[:, 1:] = pos[:, 1:] != pos[:, :-1]
    return sel, mask & uniq


def _triangulate_gated(P_mats, pose_idx, lm_idx, uv, M, gate_px, rounds):
    """Alternating batched-DLT triangulation and reprojection gating, the
    pipeline's stand-in for the front end's RANSAC outlier rejection.
    Round 1 uses all observations (outliers included); later rounds
    re-triangulate from gate survivors. Vectorized over landmarks (one
    batched (M, 2V, 4) SVD per round). Returns (lm_init (M, 3), inlier
    (K,))."""
    K_obs = len(pose_idx)
    inlier = np.ones(K_obs, bool)
    lm_init = np.zeros((M, 3))
    for _ in range(max(rounds, 1)):
        sel, smask = _spread_views(lm_idx, inlier, M)
        P = P_mats[pose_idx[sel]]  # (M, V, 3, 4)
        u, v = uv[sel][..., 0], uv[sel][..., 1]
        rows = np.stack(
            [
                u[..., None] * P[:, :, 2] - P[:, :, 0],
                v[..., None] * P[:, :, 2] - P[:, :, 1],
            ],
            axis=2,
        )  # (M, V, 2, 4)
        A = (rows * smask[..., None, None]).reshape(M, -1, 4)
        _, _, Vt = np.linalg.svd(A, full_matrices=False)
        X = Vt[:, -1, :]
        w = X[:, 3]
        safe_w = np.where(np.abs(w) < 1e-12, 1.0, w)
        lm_init = np.where(
            np.abs(w[:, None]) > 1e-12, X[:, :3] / safe_w[:, None], X[:, :3]
        )
        Xh = np.concatenate([lm_init, np.ones((M, 1))], axis=-1)
        proj = np.einsum("kij,kj->ki", P_mats[pose_idx], Xh[lm_idx])
        z = proj[:, 2]
        uv_hat = proj[:, :2] / np.where(np.abs(z) < 1e-9, 1e-9, z)[:, None]
        err = np.linalg.norm(uv_hat - uv, axis=-1)
        inlier = (z > 0.1) & (err < gate_px)
    return lm_init, inlier


def build_euroc_vio_problem(root: str,
                            params: EurocVIOParams = EurocVIOParams(),
                            K: np.ndarray | None = None,
                            tracks: np.ndarray | None = None,
                            device=None, dtype=torch.float32):
    """Problem assembly: loaders -> preintegration -> track bank ->
    triangulated initial map -> (problem, init_state, gt Trajectory,
    keyframe times), on ``device`` (default: the card). The problem and
    state are in ``dtype``; the ground truth and the times in f64.

    ``tracks`` overrides the cam0/tracks.csv sidecar with an in-memory
    (frame, landmark_id, u, v) array, such as the one
    ``pipelines.visual_frontend.track_sequence`` makes from the images."""
    device = resolve(device)
    imu = load_euroc_imu(root)
    gt = load_euroc_ground_truth(root)
    cam_times, _ = load_euroc_camera_index(root)
    if tracks is None:
        tracks = load_euroc_tracks(root)

    N = len(cam_times)
    if params.max_keyframes and N > params.max_keyframes:
        N = params.max_keyframes
        cam_times = cam_times[:N]

    pim_stack, sqrt_infos = _preintegrate_intervals(
        imu, cam_times, N, params, device, dtype
    )
    pose_idx, lm_idx, uv, M = _track_bank(
        tracks, N, params.min_track_length
    )

    Kmat = EUROC_CAM0_K if K is None else K
    qbc = default_q_BC(torch.float64, "cpu").numpy()

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt).to(device)

    # initial state: dead-reckon the IMU chain from the ground-truth start
    gi = int(np.argmin(np.abs(gt.times - cam_times[0])))
    q0 = dev(gt.q[gi] / np.linalg.norm(gt.q[gi]))
    p0 = dev(gt.p[gi])
    v0 = dev(gt.v[gi])

    free = np.ones((N, 15))
    free[0, 0:6] = 0.0

    # the observation fields are filled in after the gating below; dead
    # reckoning reads only the IMU bank
    problem = VIOProblem(
        K=dev(Kmat),
        pose_idx=None,
        lm_idx=None,
        uv=None,
        obs_weight=None,
        pim=pim_stack,
        imu_i=torch.arange(N - 1, dtype=torch.int32, device=device),
        imu_j=torch.arange(1, N, dtype=torch.int32, device=device),
        imu_sqrt_info=sqrt_infos,
        bias_walk_sqrt_info=dev(np.full(6, params.bias_walk_sqrt_info)),
        bias_prior_sqrt_info=dev(np.concatenate([
            np.full(3, params.bias_prior_gyro),
            np.full(3, params.bias_prior_accel),
        ])),
        free_pose=dev(free),
        q_BC=dev(qbc),
        pixel_sigma=params.pixel_sigma,
    )

    # dead-reckoned keyframe chain -> triangulated initial map
    state0 = vio_dead_reckon(
        problem, q0, p0, v0, torch.zeros((M, 3), dtype=dtype, device=device)
    )
    P_mats = _camera_P_mats(
        state0.q.cpu().double().numpy(), state0.p.cpu().double().numpy(),
        Kmat, qbc,
    )
    lm_init, inlier = _triangulate_gated(
        P_mats, pose_idx, lm_idx, uv, M,
        params.outlier_gate_px, params.gate_rounds,
    )

    # weight-zero the gated-out observations; drop landmarks left with < 2
    # inliers entirely (their init is untrustworthy)
    lm_inlier_count = np.bincount(lm_idx[inlier], minlength=M)
    inlier &= lm_inlier_count[lm_idx] >= 2
    weight = inlier.astype(np.float64)
    pose_ell, lm_ell, _, ell, uv_p, w_p = schur.pack_observations(
        pose_idx, lm_idx, N, M, uv, weight, device=device
    )
    problem = problem._replace(
        pose_idx=pose_ell, lm_idx=lm_ell, uv=uv_p.to(dtype),
        obs_weight=w_p.to(dtype), ell=ell,
    )
    state0 = state0._replace(lm=dev(lm_init))

    t0 = float(cam_times[0])
    gt_traj = Trajectory(
        times=dev(np.asarray(gt.times, np.float64) - t0, torch.float64),
        poses=SE3(q=dev(gt.q, torch.float64), t=dev(gt.p, torch.float64)),
    )
    kf_rel = dev(np.asarray(cam_times, np.float64) - t0, torch.float64)
    return problem, state0, gt_traj, kf_rel


def default_vio_config(params: EurocVIOParams) -> VIOConfig:
    """The pipeline's default solver configuration (bench.py's ``euroc``
    phase measures exactly this config).

    The auto solver picks the dense Schur path at EuRoC window sizes
    (N*15 in the hundreds): exact LM steps, where the stiff IMU chain made
    block-Jacobi PCG propagate corrections ~one keyframe per iteration.
    cg_max_iters only applies past the size caps.
    """
    return VIOConfig(
        max_iterations=25, cg_max_iters=150,
        huber_delta=params.huber_delta,
    )


def _trajectory_of(times, state) -> Trajectory:
    """The keyframe trajectory of ``state`` in f64, for the evaluation."""
    return Trajectory(times=times, poses=SE3(q=state.q.double(),
                                             t=state.p.double()))


def euroc_report(gt_traj, kf_times, init, state, info) -> dict:
    """ATE, RPE (delta 1), the dead-reckoned start's ATE and the solve's
    costs of a solved EuRoC problem; the trajectory errors in f64."""
    est = _trajectory_of(kf_times, state)
    ate, err = absolute_trajectory_error(gt_traj, est)
    rpe_t, rpe_r, _ = relative_pose_error(gt_traj, est, delta=1)
    ate0, _ = absolute_trajectory_error(gt_traj,
                                        _trajectory_of(kf_times, init))
    return {
        "ate_rmse": float(ate),
        "rpe_trans_rmse": float(rpe_t),
        "rpe_rot_rmse": float(rpe_r),
        "ate_rmse_deadreckon": float(ate0),
        "per_pose_error": err.cpu().numpy(),
        "final_cost": float(info["final_cost"]),
        "initial_cost": float(info["initial_cost"]),
        "costs": info["costs"].cpu().numpy(),
        "num_keyframes": int(state.q.shape[0]),
        "num_landmarks": int(state.lm.shape[0]),
    }


def run_euroc_vio(root: str, params: EurocVIOParams = EurocVIOParams(),
                  cfg: VIOConfig | None = None, K: np.ndarray | None = None,
                  tracks: np.ndarray | None = None, device=None,
                  dtype=torch.float32):
    """Full pipeline: build -> solve -> ATE, on ``device`` (default: the
    card) in ``dtype``. Returns (state, :func:`euroc_report`)."""
    problem, init, gt_traj, kf_times = build_euroc_vio_problem(
        root, params, K, tracks=tracks, device=device, dtype=dtype
    )
    if cfg is None:
        cfg = default_vio_config(params)
    state, info = solve_vio(problem, init, cfg)
    return state, euroc_report(gt_traj, kf_times, init, state, info)


def run_euroc_vio_from_images(
    root: str,
    params: EurocVIOParams = EurocVIOParams(),
    frontend=None,
    cfg: VIOConfig | None = None,
    K: np.ndarray | None = None,
    generator: torch.Generator | None = None,
    device=None,
):
    """End-to-end VIO whose only sensor inputs are the cam0 **images** and
    the IMU stream: the package's own front end (FAST -> BRISK -> match ->
    track, or ``frontend``'s method) over cam0/data/*.png on ``device``
    (default: the card), the resulting track bank into the VIO factor
    graph, solved, ATE scored. Ground truth is used only for the initial
    state and for scoring. ``generator`` draws the RANSAC samples (default:
    ``track_sequence``'s).

    Returns ``(state, report)``: :func:`euroc_report` plus the front end's
    ``num_track_measurements``, ``num_tracks``, ``frontend_frames``,
    ``frontend_seconds`` (the card synchronized before the clock is read)
    and ``frontend_frames_per_s``.
    """
    from libwave_tpu_torch.pipelines.visual_frontend import (
        FrontendParams,
        track_sequence,
    )
    from libwave_tpu_torch.vision.images import read_image_sequence

    device = resolve(device)
    if frontend is None:
        frontend = FrontendParams()
    _, paths = load_euroc_camera_index(root)
    if params.max_keyframes and len(paths) > params.max_keyframes:
        paths = paths[: params.max_keyframes]
    frames = read_image_sequence(paths)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    tracks = track_sequence(frames, params=frontend, generator=generator,
                            device=device)
    sync()
    dt_frontend = time.perf_counter() - t0

    state, report = run_euroc_vio(root, params, cfg, K, tracks=tracks,
                                  device=device)
    report["num_track_measurements"] = int(len(tracks))
    report["num_tracks"] = int(len(np.unique(tracks[:, 1])))
    report["frontend_frames"] = int(frames.shape[0])
    report["frontend_seconds"] = float(dt_frontend)
    report["frontend_frames_per_s"] = float(frames.shape[0] / dt_frontend)
    return state, report
