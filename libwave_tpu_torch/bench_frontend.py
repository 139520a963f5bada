"""The front end's benchmark inputs and timing, without JAX.

Two generators, numpy only:

- :func:`blob_image`: ``bench.py``'s ``_blob_image``, the 480x640 Gaussian
  blob texture of the two-frame pair benchmark (the second frame is its
  ``np.roll(img, (4, 7), axis=(0, 1))``);
- :func:`make_euroc_frames`: the cam0 frames that
  ``generate_euroc_sequence`` renders into PNGs
  (``sim.euroc_sim.cam0_frames``), without writing them; :func:`vo_pair`
  two of them with their true relative rotation, for two-frame VO.
  With the JAX package run at f64 (``jax_enable_x64``) the frames are
  bit-identical to its PNGs.

:func:`top2_edge_cases` makes the top-2 inputs that the frames do not:
ties across the kernel's column split, masks, ragged sizes;
:func:`table_edge_cases` the table's: every descriptor width, ragged
sizes.

:func:`time_call` times a call until the device finished and a result was
fetched, as ``bench_problem.bench_backend`` does; :func:`profile_sequence`
reads the device's busy share over one ``track_sequence``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from libwave_tpu_torch.sim.euroc_sim import (
    EurocSimParams,
    cam0_frames,
    cam0_poses,
)


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


# bench.py's bench_frontend_batched sequence: EuRoC cam0 752x480, 25 frames
EUROC_FRONTEND = EurocSimParams(duration=4.8, cam_hz=5.0, nb_landmarks=400)


def make_euroc_frames(params: EurocSimParams = EUROC_FRONTEND,
                      seed: int = 0) -> np.ndarray:
    """(T, height_px, width) uint8 cam0 frames of the simulated EuRoC
    sequence (``euroc_sim.cam0_frames``)."""
    return cam0_frames(params, seed)


def vo_pair(params: EurocSimParams = EUROC_FRONTEND, seed: int = 0,
            i: int = 0, j: int = 2):
    """Frames ``i`` and ``j`` of the simulated sequence as uint8 images, its
    intrinsics K (3, 3) and the true relative rotation R_21 (camera-1
    coordinates into camera-2's), for ``two_frame_pose``."""
    frames = cam0_frames(params, seed)
    R, _ = cam0_poses(params)
    K = np.array([[params.fx, 0, params.cx], [0, params.fy, params.cy],
                  [0, 0, 1.0]])
    return frames[i], frames[j], K, R[j].T @ R[i]


def rotation_error(R_est, R_true) -> float:
    """Angle in radians of R_estᵀ R_true."""
    c = (np.trace(np.asarray(R_est, np.float64).T @ R_true) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


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


def table_edge_cases(seed: int = 9):
    """Hamming-table inputs as numpy arrays: a list of ``(name, d1 (N1, W)
    uint32, d2 (N2, W) uint32)``. Every W the table kernel is built for (1,
    2 and 4 pad k with zero words) with duplicate rows; ragged N1 and N2
    (1, 7, 33, 100, 4,097: partial tiles, N2 % 4 != 0 takes scalar stores)
    at W = 16, 8 and 2; a 2,048-row bank against itself reversed (1,024
    full 64 x 64 tiles)."""
    rng = np.random.default_rng(seed)

    def bank(n, w):
        return rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)

    cases = []
    for w in (1, 2, 4, 8, 16, 32):
        d2 = bank(300, w)
        d2[200:] = d2[:100]
        cases.append((f"300x300x{w}, duplicates",
                      np.concatenate([d2[:50], bank(250, w)]), d2))
    for n1, n2 in ((1, 7), (7, 1), (33, 100), (100, 33), (4097, 1),
                   (1, 4097), (4097, 100), (130, 4097)):
        for w in (16, 8, 2):
            cases.append((f"{n1}x{n2}x{w}", bank(n1, w), bank(n2, w)))
    big = bank(2048, 16)
    cases.append(("2048x2048x16, reversed", big, big[::-1].copy()))
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
