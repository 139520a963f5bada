"""EuRoC-format (ASL) synthetic sequence generator.

Port of ``libwave_tpu.sim.euroc_sim``. Writes an MH_01-style directory,
``mav0/{imu0,cam0,state_groundtruth_estimate0}/data.csv`` with nanosecond
timestamps, from a smooth MAV trajectory, plus a ``cam0/tracks.csv``
feature-track sidecar (frame, landmark id, u, v): the output a visual front
end would produce from the cam0 images, with injected outliers and
dropouts. ``pipelines.euroc_vio`` reads it back through ``datasets.euroc``.

Random draws. The JAX package draws the IMU noise from
``jax.random.key(seed)``; here it comes from a ``torch.Generator`` seeded
with ``seed`` on ``device``, through ``optim.imu.simulate_imu``. Every
other draw (landmarks, dropouts, pixel noise, outliers) stays on
``np.random.default_rng(seed)`` in the reference's order. So with
``gyro_sigma = accel_sigma = 0`` both packages write the same sequence;
with noise on, only ``imu0`` differs, by its noise draw.

The trajectory, the landmarks and their projection run on the host in
f64, with this package's ``geometry.so3`` for the quaternion products and
rotation matrices (the reference's formulas). :func:`cam0_frames` renders
the cam0 frames without writing them (``bench_frontend``'s sequence);
``render_images=True`` writes them as 8-bit grayscale PNGs too, through
this package's own ``vision.images.save_png`` (no imaging library): the
pixels the JAX package's PIL writes, the file bytes may differ.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.optim.imu import simulate_imu
from libwave_tpu_torch.sim.vo_dataset import q_BC as default_q_BC
from libwave_tpu_torch.utils.device import resolve
from libwave_tpu_torch.vision.images import save_png

T0_NS = 1403636579758555392  # an MH_01-era epoch


@dataclasses.dataclass(frozen=True)
class EurocSimParams:
    duration: float = 16.0  # seconds
    imu_hz: float = 200.0
    cam_hz: float = 5.0
    # lissajous trajectory scales (machine-hall-ish volume)
    amp: tuple = (3.0, 2.0, 0.5)
    freq: tuple = (0.12, 0.17, 0.23)  # Hz per axis
    height: float = 1.5
    nb_landmarks: int = 200
    # landmarks on the walls/ceiling of a box around the trajectory
    box: tuple = (12.0, 10.0, 5.0)
    fx: float = 458.654  # EuRoC cam0 intrinsics
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    width: int = 752
    height_px: int = 480
    pixel_noise: float = 0.7
    outlier_fraction: float = 0.05
    dropout_fraction: float = 0.1
    gyro_sigma: float = 1.7e-4
    accel_sigma: float = 2.0e-3
    gyro_bias: tuple = (0.002, -0.001, 0.0015)
    accel_bias: tuple = (0.02, 0.015, -0.01)
    # also render cam0 images (sim.render textured patches at the true
    # projections) into cam0/data/<ts>.png: the front-end-in-the-loop mode
    render_images: bool = False


def _qmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product of host f64 quaternions through ``so3``."""
    return so3.quat_multiply(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def _trajectory(p: EurocSimParams, t):
    """Smooth lissajous MAV path with yaw following the velocity:
    (q (n, 4), pos (n, 3), vel (n, 3)), host f64."""
    ax, ay, az = p.amp
    fx_, fy_, fz_ = [2 * np.pi * f for f in p.freq]
    pos = np.stack(
        [
            ax * np.sin(fx_ * t),
            ay * np.sin(fy_ * t + 0.7),
            p.height + az * np.sin(fz_ * t),
        ],
        axis=-1,
    )
    vel = np.stack(
        [
            ax * fx_ * np.cos(fx_ * t),
            ay * fy_ * np.cos(fy_ * t + 0.7),
            az * fz_ * np.cos(fz_ * t),
        ],
        axis=-1,
    )
    yaw = np.unwrap(np.arctan2(vel[:, 1], vel[:, 0]))
    roll = 0.05 * np.sin(2 * np.pi * 0.3 * t)
    pitch = 0.04 * np.sin(2 * np.pi * 0.25 * t + 1.1)
    cy_, sy_ = np.cos(yaw / 2), np.sin(yaw / 2)
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    # q = qz(yaw) * qy(pitch) * qx(roll), w-first Hamilton
    qz = np.stack([cy_, 0 * cy_, 0 * cy_, sy_], axis=-1)
    qy = np.stack([cp, 0 * cp, sp, 0 * cp], axis=-1)
    qx = np.stack([cr, sr, 0 * cr, 0 * cr], axis=-1)
    return _qmul(qz, _qmul(qy, qx)), pos, vel


def _landmarks(p: EurocSimParams, rng):
    """Landmarks on the 4 walls + ceiling of the box (a machine hall: all
    structure is on surfaces, not floating mid-air)."""
    bx, by, bz = p.box
    n = p.nb_landmarks
    per = n // 5
    walls = []
    u1 = rng.uniform(-bx / 2, bx / 2, per)
    v1 = rng.uniform(0.2, bz, per)
    walls.append(np.stack([u1, np.full(per, by / 2), v1], axis=-1))
    walls.append(np.stack([u1, np.full(per, -by / 2), v1], axis=-1))
    u2 = rng.uniform(-by / 2, by / 2, per)
    walls.append(np.stack([np.full(per, bx / 2), u2, v1], axis=-1))
    walls.append(np.stack([np.full(per, -bx / 2), u2, v1], axis=-1))
    rest = n - 4 * per
    walls.append(
        np.stack(
            [
                rng.uniform(-bx / 2, bx / 2, rest),
                rng.uniform(-by / 2, by / 2, rest),
                np.full(rest, bz),
            ],
            axis=-1,
        )
    )
    return np.concatenate(walls, axis=0)


def _camera_frames(p: EurocSimParams, n_imu: int) -> np.ndarray:
    """IMU sample index of every camera frame."""
    return np.arange(0, n_imu, int(round(p.imu_hz / p.cam_hz)))


def _project(p: EurocSimParams, q, pos, lm):
    """Every landmark through every camera frame of the poses ``(q, pos)``
    in one batched host computation: (uv (F, M, 2), visible (F, M))."""
    Kmat = np.array([[p.fx, 0, p.cx], [0, p.fy, p.cy], [0, 0, 1]])
    qbc = default_q_BC(torch.float64, "cpu").numpy()
    q_GC = _qmul(q, np.broadcast_to(qbc, q.shape).copy())
    R = so3.quat_to_rot(torch.from_numpy(q_GC)).numpy()  # (F, 3, 3)
    d = lm[None, :, :] - pos[:, None, :]  # (F, M, 3)
    pc = np.einsum("fmj,fjk->fmk", d, R)  # R^T d per frame
    z = pc[..., 2]
    uvh = np.einsum("fmj,kj->fmk", pc, Kmat)
    uv = uvh[..., :2] / np.where(np.abs(z) < 1e-9, 1e-9, z)[..., None]
    vis = (
        (z > 0.5) & (z < 25.0)
        & (uv[..., 0] >= 0) & (uv[..., 0] < p.width)
        & (uv[..., 1] >= 0) & (uv[..., 1] < p.height_px)
    )
    return uv, vis


def _render(p: EurocSimParams, uv_frames, vis_frames, seed: int):
    """(F, height_px, width) uint8 frames of textured patches at the
    projections (``sim.render``)."""
    from libwave_tpu_torch.sim.render import landmark_textures, render_sequence

    tex = landmark_textures(uv_frames.shape[1], seed=seed + 101)
    return render_sequence(uv_frames, vis_frames, tex, p.width, p.height_px)


def cam0_frames(params: EurocSimParams = EurocSimParams(),
                seed: int = 0) -> np.ndarray:
    """(F, height_px, width) uint8 cam0 frames that
    ``generate_euroc_sequence(root, params, seed)`` writes as PNGs with
    ``render_images=True``, without writing anything. The landmarks are the
    first draws of the sequence's ``np.random.default_rng(seed)``, so no
    other draw is needed."""
    p = params
    n_imu = int(round(p.duration * p.imu_hz)) + 1
    q, pos, _ = _trajectory(p, np.arange(n_imu) * (1.0 / p.imu_hz))
    cam_idx = _camera_frames(p, n_imu)
    lm = _landmarks(p, np.random.default_rng(seed))
    uv, vis = _project(p, q[cam_idx], pos[cam_idx], lm)
    return _render(p, uv, vis, seed)


def cam0_poses(params: EurocSimParams = EurocSimParams()):
    """Ground-truth camera-to-world rotations (F, 3, 3) and positions (F, 3)
    of the cam0 frames, host f64 (the poses the frames are rendered from)."""
    p = params
    n_imu = int(round(p.duration * p.imu_hz)) + 1
    q, pos, _ = _trajectory(p, np.arange(n_imu) * (1.0 / p.imu_hz))
    cam_idx = _camera_frames(p, n_imu)
    qbc = default_q_BC(torch.float64, "cpu").numpy()
    q_GC = _qmul(q[cam_idx], np.broadcast_to(qbc, q[cam_idx].shape).copy())
    return so3.quat_to_rot(torch.from_numpy(q_GC)).numpy(), pos[cam_idx]


def generate_euroc_sequence(root: str,
                            params: EurocSimParams = EurocSimParams(),
                            seed: int = 0, device=None):
    """Write the ASL directory under ``root``. The IMU samples are
    simulated on ``device`` (default: the card) with noise from a
    ``torch.Generator`` there seeded with ``seed``. Returns the landmark
    array (callers normally rediscover everything through the loaders)."""
    device = resolve(device)
    rng = np.random.default_rng(seed)
    p = params

    # dense IMU-rate trajectory
    dt = 1.0 / p.imu_hz
    n_imu = int(round(p.duration * p.imu_hz)) + 1
    t = np.arange(n_imu) * dt
    q, pos, vel = _trajectory(p, t)

    bg = np.asarray(p.gyro_bias, np.float64)
    ba = np.asarray(p.accel_bias, np.float64)

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64).to(device)

    gen = torch.Generator(device=device).manual_seed(seed)
    gyro, accel = simulate_imu(
        dev(q), dev(pos), dev(vel), dt, bg=dev(bg), ba=dev(ba),
        generator=gen, gyro_sigma=p.gyro_sigma, accel_sigma=p.accel_sigma,
    )
    gyro = gyro.cpu().numpy()
    accel = accel.cpu().numpy()

    imu_dir = os.path.join(root, "mav0", "imu0")
    gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    cam_dir = os.path.join(root, "mav0", "cam0")
    for d in (imu_dir, gt_dir, cam_dir):
        os.makedirs(d, exist_ok=True)

    ts_ns = T0_NS + np.round(t * 1e9).astype(np.int64)
    with open(os.path.join(imu_dir, "data.csv"), "w") as fh:
        fh.write(
            "#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
            "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
            "a_RS_S_z [m s^-2]\n"
        )
        fh.writelines(
            f"{ts_ns[i]},{gyro[i,0]:.9f},{gyro[i,1]:.9f},"
            f"{gyro[i,2]:.9f},{accel[i,0]:.9f},{accel[i,1]:.9f},"
            f"{accel[i,2]:.9f}\n"
            for i in range(gyro.shape[0])
        )

    with open(os.path.join(gt_dir, "data.csv"), "w") as fh:
        fh.write(
            "#timestamp,p_RS_R_x [m],p_RS_R_y [m],p_RS_R_z [m],"
            "q_RS_w [],q_RS_x [],q_RS_y [],q_RS_z [],"
            "v_RS_R_x [m s^-1],v_RS_R_y [m s^-1],v_RS_R_z [m s^-1],"
            "b_w_RS_S_x [rad s^-1],b_w_RS_S_y [rad s^-1],"
            "b_w_RS_S_z [rad s^-1],b_a_RS_S_x [m s^-2],"
            "b_a_RS_S_y [m s^-2],b_a_RS_S_z [m s^-2]\n"
        )
        for i in range(n_imu):
            row = [ts_ns[i]] + list(pos[i]) + list(q[i]) + list(vel[i]) \
                + list(bg) + list(ba)
            fh.write(",".join(str(x) for x in row) + "\n")

    # camera frames + feature tracks
    cam_idx = _camera_frames(p, n_imu)
    lm = _landmarks(p, rng)

    with open(os.path.join(cam_dir, "data.csv"), "w") as fh:
        fh.write("#timestamp [ns],filename\n")
        fh.writelines(f"{ts_ns[i]},{ts_ns[i]}.png\n" for i in cam_idx)

    uv_frames, vis_frames = _project(p, q[cam_idx], pos[cam_idx], lm)

    # per-frame dropout/outlier injection, consuming the rng in frame order
    frame_col, id_col, u_col, v_col = [], [], [], []
    for fi in range(len(cam_idx)):
        ids = np.nonzero(vis_frames[fi])[0]
        keep = rng.random(ids.size) >= p.dropout_fraction
        ids = ids[keep]
        puv = uv_frames[fi, ids] \
            + p.pixel_noise * rng.standard_normal((ids.size, 2))
        out = rng.random(ids.size) < p.outlier_fraction
        n_out = int(out.sum())
        puv[out, 0] = rng.uniform(0, p.width, n_out)
        puv[out, 1] = rng.uniform(0, p.height_px, n_out)
        frame_col.append(np.full(ids.size, fi, np.int64))
        id_col.append(ids)
        u_col.append(puv[:, 0])
        v_col.append(puv[:, 1])

    fcol = np.concatenate(frame_col) if frame_col else np.zeros(0, np.int64)
    jcol = np.concatenate(id_col) if id_col else np.zeros(0, np.int64)
    ucol = np.concatenate(u_col) if u_col else np.zeros(0)
    vcol = np.concatenate(v_col) if v_col else np.zeros(0)
    with open(os.path.join(cam_dir, "tracks.csv"), "w") as fh:
        fh.write("#frame,landmark_id,u [px],v [px]\n")
        fh.writelines(
            f"{fi},{j},{u:.4f},{v:.4f}\n"
            for fi, j, u, v in zip(fcol, jcol, ucol, vcol)
        )

    if p.render_images:
        frames = _render(p, uv_frames, vis_frames, seed)
        data_dir = os.path.join(cam_dir, "data")
        os.makedirs(data_dir, exist_ok=True)
        for fi, i in enumerate(cam_idx):
            save_png(os.path.join(data_dir, f"{ts_ns[i]}.png"), frames[fi])

    return lm
