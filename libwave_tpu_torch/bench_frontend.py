"""The front end's benchmark inputs and timing, without JAX.

Two generators, numpy only:

- :func:`blob_image`: ``bench.py``'s ``_blob_image``, the 480x640 Gaussian
  blob texture of the two-frame pair benchmark (the second frame is its
  ``np.roll(img, (4, 7), axis=(0, 1))``);
- :func:`make_euroc_frames`: the cam0 frames that
  ``libwave_tpu.sim.generate_euroc_sequence`` renders into PNGs, rebuilt from
  the same trajectory, landmarks, camera mount, projection and renderer. The
  quaternion products and rotation matrices go through this package's
  ``geometry.so3`` at f64 on the CPU, the formulas of the reference's. With
  the reference run at f64 (``jax_enable_x64``) the frames are bit-identical
  to its PNGs.

:func:`top2_edge_cases` makes the top-2 inputs that the frames do not:
ties across the kernel's column split, masks, ragged sizes.

:func:`time_call` times a call until the device finished and a result was
fetched, as ``bench_problem.bench_backend`` does; :func:`profile_sequence`
reads the device's busy share over one ``track_sequence``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from libwave_tpu_torch.bench_problem import _q_bc_np
from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.sim.render import landmark_textures, render_sequence


def blob_image(rng, H=480, W=640, n_blobs=250):
    """(H, W) float32 sum of random Gaussian blobs (``bench.py:275``)."""
    ys = rng.uniform(10, H - 10, n_blobs)
    xs = rng.uniform(10, W - 10, n_blobs)
    amps = rng.uniform(50, 200, n_blobs)
    sig = rng.uniform(1.5, 3.0, n_blobs)
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.zeros((H, W), np.float32)
    for y, x, a, s in zip(ys, xs, amps, sig):
        img += (a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * s * s))
                ).astype(np.float32)
    return img


def pair_images(seed: int = 0):
    """The pair benchmark's two frames: a blob image and its (4, 7) roll."""
    img1 = blob_image(np.random.default_rng(seed))
    return img1, np.roll(img1, (4, 7), axis=(0, 1))


@dataclasses.dataclass(frozen=True)
class EurocSimParams:
    """The fields of ``libwave_tpu.sim.EurocSimParams`` that shape the cam0
    frames, with the same defaults (the IMU and track-noise fields do not
    reach the images)."""

    duration: float = 16.0  # seconds
    imu_hz: float = 200.0
    cam_hz: float = 5.0
    amp: tuple = (3.0, 2.0, 0.5)
    freq: tuple = (0.12, 0.17, 0.23)  # Hz per axis
    height: float = 1.5
    nb_landmarks: int = 200
    box: tuple = (12.0, 10.0, 5.0)
    fx: float = 458.654  # EuRoC cam0 intrinsics
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    width: int = 752
    height_px: int = 480


# bench.py's bench_frontend_batched sequence: EuRoC cam0 752x480, 25 frames
EUROC_FRONTEND = EurocSimParams(duration=4.8, cam_hz=5.0, nb_landmarks=400)


def _qmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return so3.quat_multiply(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def _trajectory(p: EurocSimParams, t):
    """Lissajous MAV path with yaw along the velocity
    (``euroc_sim.py:58``): (q (n, 4), pos (n, 3))."""
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
    return _qmul(qz, _qmul(qy, qx)), pos


def _landmarks(p: EurocSimParams, rng):
    """Landmarks on the 4 walls + ceiling of the box (``euroc_sim.py:98``)."""
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


def make_euroc_frames(params: EurocSimParams = EUROC_FRONTEND,
                      seed: int = 0) -> np.ndarray:
    """(T, height_px, width) uint8 cam0 frames of the simulated EuRoC
    sequence (``euroc_sim.py:186-220, 253-261``)."""
    p = params
    rng = np.random.default_rng(seed)
    n_imu = int(round(p.duration * p.imu_hz)) + 1
    t = np.arange(n_imu) * (1.0 / p.imu_hz)
    q, pos = _trajectory(p, t)

    cam_idx = np.arange(0, n_imu, int(round(p.imu_hz / p.cam_hz)))
    lm = _landmarks(p, rng)  # the only draws of ``rng`` the frames see
    Kmat = np.array([[p.fx, 0, p.cx], [0, p.fy, p.cy], [0, 0, 1]])
    qbc = _q_bc_np(np.float64)
    q_GC_all = _qmul(q[cam_idx], np.broadcast_to(qbc, (len(cam_idx), 4)).copy())
    R_all = so3.quat_to_rot(torch.from_numpy(q_GC_all)).numpy()
    d_all = lm[None, :, :] - pos[cam_idx, None, :]
    pc_all = np.einsum("fmj,fjk->fmk", d_all, R_all)  # R^T d per frame
    z_all = pc_all[..., 2]
    uvh_all = np.einsum("fmj,kj->fmk", pc_all, Kmat)
    uv_frames = uvh_all[..., :2] / np.where(
        np.abs(z_all) < 1e-9, 1e-9, z_all
    )[..., None]
    vis_frames = (
        (z_all > 0.5) & (z_all < 25.0)
        & (uv_frames[..., 0] >= 0) & (uv_frames[..., 0] < p.width)
        & (uv_frames[..., 1] >= 0) & (uv_frames[..., 1] < p.height_px)
    )
    tex = landmark_textures(lm.shape[0], seed=seed + 101)
    return render_sequence(uv_frames, vis_frames, tex, p.width, p.height_px)


def top2_edge_cases(seed: int = 4):
    """Top-2 inputs that stress the kernel's split of each row's columns
    over lanes and the merge of the lanes' results, as numpy arrays: a list
    of ``(name, d1 (N1, W) uint32, d2 (N2, W) uint32, mask2 (N2,) bool or
    None)``.

    - a best tied at columns j and j + L (column j copied to j + L, the
      query column j or it with one bit flipped; some columns j masked, so
      that the copy is the best): L = 1 and 34 put the two in different
      lanes of a 32-lane split, 34 with the larger column in the lower lane
      at j = 30 and 31; L = 8, 16 and 32 in one lane of such splits;
    - the only live column last; N2 = 1, 7, 33 and 100 (not a multiple of
      32); every column masked;
    - 1,500 query rows, and 4,500 and 2,200 (W = 16 and 32: several rows
      per thread; fewer rows run 4 warps per row); W = 1 with many equal
      distances.
    """
    rng = np.random.default_rng(seed)

    def bank(n, w):
        return rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)

    cases = []
    for L in (1, 8, 16, 32, 34):
        d2 = bank(130, 16)
        js = np.arange(0, 130 - L, 3)  # no j + L is another j
        d2[js + L] = d2[js]
        d1 = d2[js].copy()
        d1[1::2, 0] ^= np.uint32(1)  # distance 1 at both columns
        mask = np.ones(130, bool)
        mask[js[1::4]] = False
        cases.append((f"tie at j and j+{L}", d1, d2, mask))
    one = np.zeros(100, bool)
    one[-1] = True
    cases.append(("only the last column live, N2=100", bank(40, 16),
                  bank(100, 16), one))
    for n2 in (1, 7, 33):
        d2 = bank(n2, 16)
        cases.append((f"N2={n2}", np.concatenate([d2, bank(37, 16)]), d2,
                      None))
    d2 = bank(100, 8)
    d2[60:] = d2[:40]
    cases.append(("N2=100 W=8 ties, mask",
                  np.concatenate([d2[:30], bank(20, 8)]), d2,
                  rng.random(100) < 0.6))
    cases.append(("all masked", bank(33, 16), bank(70, 16), np.zeros(70, bool)))
    d2 = bank(97, 16)
    d2[50:] = d2[:47]
    cases.append(("4,500 queries, ties, mask",
                  np.concatenate([d2, bank(4403, 16)]), d2,
                  rng.random(97) < 0.8))
    d2 = bank(300, 16)
    d2[200:] = d2[:100]
    cases.append(("1,500 queries, ties", np.concatenate([d2, bank(1200, 16)]),
                  d2, None))
    d2 = bank(45, 32)
    cases.append(("2,200 queries W=32, ties",
                  np.concatenate([d2[:10], bank(2190, 32)]),
                  np.concatenate([d2, d2]), None))
    small = rng.integers(0, 4, (50, 1)).astype(np.uint32)
    cases.append(("W=1 tie-heavy", small, np.tile(small, (3, 1)), None))
    return cases


def _sync(x):
    """Wait for every device that holds a tensor in ``x`` and fetch one
    value of it to the host (a numpy result is there already)."""
    if isinstance(x, np.ndarray):
        return
    leaves = [x] if isinstance(x, torch.Tensor) else [
        v for v in x if isinstance(v, torch.Tensor)
    ]
    for v in leaves:
        if v.is_cuda:
            torch.cuda.synchronize(v.device)
    if leaves:
        leaves[0].reshape(-1)[:1].cpu()


def time_call(fn, *args, reps: int = 5):
    """Median seconds of ``reps`` calls of ``fn(*args)`` after one warm-up,
    each ending once the device finished and a result was on the host.
    Returns (seconds, last result)."""
    out = fn(*args)
    _sync(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def profile_sequence(frames, device, reps: int = 3, top: int = 10):
    """The card's busy share over ``track_sequence(frames, FrontendParams())``
    on ``device``: the device kernel time that ``torch.profiler`` records over
    one run, against the median wall time of ``reps`` unprofiled runs (the
    profiler slows the host). Returns a dict with ``wall_ms``,
    ``device_ms``, ``busy_share``, ``device_events`` and the ``top``
    kernels by device time as (name, calls, ms)."""
    from torch.profiler import ProfilerActivity, profile

    from libwave_tpu_torch.pipelines import visual_frontend

    def run():
        return visual_frontend.track_sequence(frames, device=device)

    wall, _ = time_call(run, reps=reps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(device)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {
        "wall_ms": 1e3 * wall,
        "device_ms": device_us / 1e3,
        "busy_share": device_us / 1e3 / (1e3 * wall),
        "device_events": sum(e.count for e in kernels),
        "top": [(e.key, e.count, e.self_device_time_total / 1e3)
                for e in kernels[:top]],
    }
