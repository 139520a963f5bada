"""Synthetic VO dataset: a two-wheel robot on a circle observing landmarks.

Port of ``libwave_tpu.sim.vo_dataset`` (the reference's
``VoDatasetGenerator``): ``nb_landmarks`` landmarks uniform in x/y/z bounds,
a two-wheel robot driving a circle of radius 0.5 m at 1 m/s in steps of
``dt``, a camera mounted with q_BC = Rz(-90°) Rx(-90°) and rate-gated at
``hz``; per triggered frame every landmark is projected through the pinhole
model and kept when in front of the camera and strictly inside the image.
Observations come out dense: ``pixels (T, M, 2)`` with ``visible (T, M)``.

The JAX package draws the landmarks from a ``jax.random`` key; here they
come from a seeded numpy generator, or from the caller (``landmarks=``), so
that both packages can be fed the same landmarks. Everything after the
landmarks is deterministic. The robot's Euler recurrence and the camera's
rate gate (sequential, 3 numbers per step) run on the host in ``dtype``;
the (T, M) projection runs on ``device``.

:func:`save_vo_dataset` and :func:`load_vo_dataset` write and read the
reference's text directory format (``landmarks.dat``, ``calib.dat``,
``state.dat``, ``index.dat`` and one ``observed_<n>.dat`` per triggered
frame; quaternions stored xyzw, wxyz in memory), the same files the JAX
package writes and reads. Files are parsed on the host with numpy.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.kinematics.two_wheel import two_wheel_step
from libwave_tpu_torch.utils.device import resolve
from libwave_tpu_torch.vision import camera as cam


@dataclasses.dataclass(frozen=True)
class VoSimParams:
    """Generator parameters (defaults as in the JAX package)."""

    image_width: int = 640
    image_height: int = 480
    fx: float = 554.25
    fy: float = 554.25
    cx: float = 320.0
    cy: float = 240.0
    hz: float = 100.0
    nb_landmarks: int = 100
    landmark_x_bounds: tuple = (-10.0, 10.0)
    landmark_y_bounds: tuple = (-10.0, 10.0)
    landmark_z_bounds: tuple = (-1.0, 1.0)
    circle_radius: float = 0.5
    velocity: float = 1.0
    dt: float = 0.01
    steps: int = 300

    def K(self, dtype=torch.float64, device=None) -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
             [0.0, 0.0, 1.0]],
            dtype=dtype, device=resolve(device),
        )

    def validate(self):
        if self.nb_landmarks <= 0:
            raise ValueError("nb_landmarks must be > 0")
        if self.hz <= 0 or self.dt <= 0:
            raise ValueError("hz and dt must be > 0")


class VoDataset(NamedTuple):
    """Dense synthetic dataset (all tensors fixed-shape)."""

    landmarks: torch.Tensor  # (M, 3) world positions
    camera_K: torch.Tensor  # (3, 3)
    times: torch.Tensor  # (T,)
    robot_p_GB: torch.Tensor  # (T, 3) body position (z = 0)
    robot_q_GB: torch.Tensor  # (T, 4) body orientation wxyz
    pixels: torch.Tensor  # (T, M, 2) projections (valid where visible)
    visible: torch.Tensor  # (T, M) bool — in-frustum AND camera triggered
    frame_has_obs: torch.Tensor  # (T,) bool — camera triggered this step

    @property
    def num_frames(self) -> int:
        return self.times.shape[0]


def q_BC(dtype=torch.float64, device=None) -> torch.Tensor:
    """Body-to-camera rotation Rz(-90°) * Rx(-90°)."""
    z = torch.zeros((2, 3), dtype=dtype, device=resolve(device))
    z[0, 2] = -math.pi / 2
    z[1, 0] = -math.pi / 2
    qz, qx = so3.exp_quat(z)
    return so3.quat_multiply(qz, qx)


def draw_landmarks(params: VoSimParams, seed: int = 0) -> np.ndarray:
    """(M, 3) float64 landmarks uniform in the parameter bounds, from a
    seeded numpy generator."""
    rng = np.random.default_rng(seed)
    bounds = (params.landmark_x_bounds, params.landmark_y_bounds,
              params.landmark_z_bounds)
    return np.stack([rng.uniform(lo, hi, params.nb_landmarks)
                     for lo, hi in bounds], axis=-1)


def generate_vo_dataset(params: VoSimParams, seed: int = 0, landmarks=None,
                        dtype=torch.float64, device=None) -> VoDataset:
    """Simulate the dataset on ``device`` (default: the card). Landmarks are
    ``landmarks`` (M, 3) when given, else :func:`draw_landmarks` of
    ``seed``."""
    params.validate()
    device = resolve(device)
    T, dt = params.steps, params.dt
    if landmarks is None:
        landmarks = draw_landmarks(params, seed)
    lm = torch.as_tensor(np.array(landmarks), dtype=dtype).to(device)

    # robot recurrence and camera gate, step by step as the reference's scan
    w = params.velocity / params.circle_radius
    u = torch.tensor([params.velocity, w], dtype=dtype)
    pose = torch.zeros(3, dtype=dtype)
    cam_acc = torch.zeros((), dtype=dtype)
    poses, triggers = [], []
    for _ in range(T):
        pose = two_wheel_step(pose, u, dt)
        cam_acc = cam_acc + dt
        trigger = bool(cam_acc > 1.0 / params.hz)
        if trigger:
            cam_acc = torch.zeros_like(cam_acc)
        poses.append(pose)
        triggers.append(trigger)
    pose2d = torch.stack(poses).to(device)
    trig = torch.tensor(triggers, device=device)

    zero = torch.zeros_like(pose2d[:, 0])
    p_GB = torch.stack([pose2d[:, 0], pose2d[:, 1], zero], dim=-1)
    q_GB = so3.exp_quat(torch.stack([zero, zero, pose2d[:, 2]], dim=-1))
    q_GC = so3.quat_multiply(q_GB, q_BC(dtype, device))
    K = params.K(dtype, device)
    uv, in_front = cam.pinhole_project(K, q_GC[:, None, :], p_GB[:, None, :],
                                       lm[None, :, :])
    vis = in_front & cam.in_image(uv, params.image_width, params.image_height)
    vis = vis & trig[:, None]
    return VoDataset(
        landmarks=lm,
        camera_K=K,
        times=torch.arange(T, dtype=dtype, device=device) * dt,
        robot_p_GB=p_GB,
        robot_q_GB=q_GB,
        pixels=uv,
        visible=vis,
        frame_has_obs=trig,
    )


# ---------------------------------------------------------------------------
# Directory serialization (reference text format, VoDataset.cpp:57-211)
# ---------------------------------------------------------------------------


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def save_vo_dataset(ds: VoDataset, out_dir: str) -> None:
    """Write ``ds`` in the reference's directory format (numbers as Python
    prints them, quaternions xyzw), one ``observed_<n>.dat`` per triggered
    frame listing its visible landmarks by ascending id."""
    os.makedirs(out_dir, exist_ok=True)
    lm = _np(ds.landmarks)
    with open(os.path.join(out_dir, "landmarks.dat"), "w") as f:
        for i, p in enumerate(lm):
            f.write(f"{i} {p[0]} {p[1]} {p[2]}\n")
    with open(os.path.join(out_dir, "calib.dat"), "w") as f:
        f.write(" ".join(str(v) for v in _np(ds.camera_K).reshape(-1)) + "\n")

    q, p, t = _np(ds.robot_q_GB), _np(ds.robot_p_GB), _np(ds.times)
    vis, uv, trig = _np(ds.visible), _np(ds.pixels), _np(ds.frame_has_obs)
    with open(os.path.join(out_dir, "state.dat"), "w") as f:
        for i in range(len(t)):
            f.write(f"{t[i]} {p[i, 0]} {p[i, 1]} {p[i, 2]} "
                    f"{q[i, 1]} {q[i, 2]} {q[i, 3]} {q[i, 0]}\n")
    with open(os.path.join(out_dir, "index.dat"), "w") as idx:
        n = 0
        for i in np.nonzero(trig)[0]:
            name = f"observed_{n}.dat"
            rows = "".join(f"{j} {uv[i, j, 0]} {uv[i, j, 1]}\n"
                           for j in np.nonzero(vis[i])[0])
            with open(os.path.join(out_dir, name), "w") as f:
                f.write(f"{t[i]}\n{p[i, 0]} {p[i, 1]} {p[i, 2]}\n"
                        f"{q[i, 1]} {q[i, 2]} {q[i, 3]} {q[i, 0]}\n"
                        f"{int(vis[i].sum())}\n{rows}")
            idx.write(name + "\n")
            n += 1


def _frame_tokens(in_dir: str, name: str):
    with open(os.path.join(in_dir, os.path.basename(name))) as f:
        return f.read().split()


def load_vo_dataset(in_dir: str, num_landmarks: int | None = None,
                    dtype=torch.float64, device=None) -> VoDataset:
    """Read a dataset in the reference's directory format into dense
    tensors on ``device`` (default: the card), floating fields in
    ``dtype``; every listed frame counts as triggered.

    Exported datasets are read as the JAX package reads them: without
    ``landmarks.dat`` the table is sized from the largest observed id (its
    positions zero); a frame that declares more observation rows than it
    holds gives the rows it holds; ids ``>= M`` are dropped. ``M`` is
    ``num_landmarks`` when given."""
    K = np.loadtxt(os.path.join(in_dir, "calib.dat")).reshape(3, 3)
    with open(os.path.join(in_dir, "index.dat")) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    frames = [_frame_tokens(in_dir, n) for n in names]

    def rows(toks):
        """(ids, uv) of the observation rows a frame holds."""
        n_obs = int(float(toks[8]))
        n = min(n_obs, (len(toks) - 9) // 3)
        a = np.asarray(toks[9:9 + 3 * n], dtype=np.float64).reshape(n, 3)
        return a[:, 0].astype(np.int64), a[:, 1:]

    lm_path = os.path.join(in_dir, "landmarks.dat")
    if os.path.exists(lm_path):
        lm_raw = np.loadtxt(lm_path, ndmin=2)
        ids = lm_raw[:, 0].astype(int)
        M = int(ids.max()) + 1 if num_landmarks is None else num_landmarks
        landmarks = np.zeros((M, 3))
        landmarks[ids] = lm_raw[:, 1:4]
    else:
        # exported drives carry no landmark ground truth; as in the JAX
        # package, the id of a row cut short after its id still counts
        max_id = -1
        for toks in frames:
            ids = toks[9:9 + 3 * int(float(toks[8])):3]
            max_id = max([max_id] + [int(float(j)) for j in ids])
        M = max_id + 1 if num_landmarks is None else num_landmarks
        landmarks = np.zeros((M, 3))

    T = len(frames)
    head = np.asarray([toks[:8] for toks in frames],
                      dtype=np.float64).reshape(T, 8)
    pixels = np.zeros((T, M, 2))
    visible = np.zeros((T, M), dtype=bool)
    for i, toks in enumerate(frames):
        ids, uv = rows(toks)
        keep = ids < M
        pixels[i, ids[keep]] = uv[keep]
        visible[i, ids[keep]] = True

    device = resolve(device)

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt).to(device)

    return VoDataset(
        landmarks=t(landmarks),
        camera_K=t(K),
        times=t(head[:, 0]),
        robot_p_GB=t(head[:, 1:4]),
        robot_q_GB=t(head[:, [7, 4, 5, 6]]),  # xyzw in the file
        pixels=t(pixels),
        visible=t(visible, torch.bool),
        frame_has_obs=torch.ones(T, dtype=torch.bool, device=device),
    )
