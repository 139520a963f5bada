"""The headline bundle-adjustment problem and its LM timing, without JAX.

:func:`make_problem` is a numpy-only copy of ``bench.py``'s ``make_problem``
(200 poses on a circle, 10,000 landmarks in a ring with ids ordered by
bearing, 300 genuinely visible observations per pose, f32, pose-ELL layout
plus a covisibility :class:`~libwave_tpu_torch.optim.schur.BandPlan`). For
the same arguments it gives bit-identical arrays; its landmark layout leaves
zero-weight slots out of every landmark's run. The problem is built on
the host, outside any timed window, and moved to ``device`` (the card unless
the caller asks for the CPU).

:func:`bench_backend` times full LM iterations with ``bench.py``'s
``bench_backend`` configuration (10 iterations, 20 CG steps, tolerance
1e-5, convergence freeze off). :func:`matvec_profile` is ``bench.py``'s
``bench_matvec_profile`` on the card: the matrix-free Schur matvec at 300 to
2,400 observations per pose, a linear fit t(K) = a + b*K, and the split by
op. :func:`make_vio_problem` and :func:`bench_vio` are ``bench.py``'s
``bench_vio`` configuration (BASELINE config 4) built from seeds.

:func:`ba_batched_problems` and :func:`bench_ba_batched` are ``bench.py``'s
``bench_ba_batched`` (B windows of 50 poses, 2,000 landmarks and 240
observations per pose, seeds 10 + i) through ``optim.ba.solve_ba_batched``;
:func:`bench_ba_large` is its ``bench_ba_large`` (:func:`ba_large_problem`,
5 LM iterations, 2 timed solves), without the FLOP accounting.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.optim import schur
from libwave_tpu_torch.optim.ba import (
    BAConfig,
    BAProblem,
    BAState,
    _linearize_ba,
    solve_ba,
    solve_ba_batched,
)
from libwave_tpu_torch.pipelines import vio
from libwave_tpu_torch.sim.vo_dataset import VoSimParams, generate_vo_dataset
from libwave_tpu_torch.utils.precision import full_f32
from libwave_tpu_torch.utils.device import resolve


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
                 seed=0, device=None):
    """Synthetic BA problem with ~num_poses*obs_per_pose observations,
    built on the host from ``seed`` and returned on ``device`` (default:
    the card)."""
    device = resolve(device)
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
    pose_ell, lm_ell, pad_mask, _, uv_p, w_p = schur.pack_observations(
        pose_idx, lm_idx, num_poses, num_landmarks, uv, weight, device=device
    )
    # zero-weight slots (poses that see fewer than obs_per_pose landmarks
    # pad with landmark 0) add exact zeros: leave them out of the landmark
    # runs, or landmark 0's run holds all of them
    ell = schur.build_ell_layout(lm_ell, num_landmarks, valid=w_p > 0,
                                 device=device)
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


def ba_large_problem(num_landmarks=100_000, device=None):
    """``bench.py``'s ``ba_large`` problem: :func:`make_problem` at 400
    poses, ``num_landmarks`` landmarks (100,000 there), 1,500 observations
    per pose (K = 600,000), seed 1."""
    return make_problem(num_poses=400, num_landmarks=num_landmarks,
                        obs_per_pose=1500, seed=1, device=device)


def g_a_edge_cases(seed: int = 1):
    """G/A inputs the headline problem does not make, as numpy arrays:
    a list of ``(name, W (18, N, Pmax) f32, lm_slot (N, Pmax) int32,
    hinv (6, M) f32, windows)``, each window ``(c0, c1, plo, phi)``. Ids
    outside ``[0, M)`` (the pose-padding id -1, ids >= M) name no column;
    duplicate ids within a pose sum."""
    rng = np.random.default_rng(seed)
    cases = []

    def add(name, N, P, M, lo, hi, windows, edit=None):
        W = rng.standard_normal((18, N, P)).astype(np.float32)
        ids = rng.integers(lo, hi, (N, P)).astype(np.int32)
        if edit is not None:
            edit(ids, M)
        hinv = rng.standard_normal((6, M)).astype(np.float32)
        cases.append((name, W, ids, hinv, windows))

    def dup_and_pad(ids, M):
        P = ids.shape[1]
        ids[:, : P // 4] = ids[:, :1]  # duplicates of the first slot's id
        ids[0, :3] = -1
        ids[-1, -3:] = M
        ids[min(1, ids.shape[0] - 1)] = -1  # every id out of range

    def spanning(ids, M):
        ids[:, 3] = 7  # landmark 7 in every pose, twice
        ids[:, 9] = 7

    add("duplicates, ids -1 and >= M, Pmax=37, M=1000", 5, 37, 1000, -1,
        1003, [(0, 1000, 0, 5), (100, 900, 1, 4)], dup_and_pad)
    add("duplicates, Pmax=300, M=1000", 3, 300, 1000, -1, 1003,
        [(0, 1000, 0, 3), (512, 1000, 2, 3)], dup_and_pad)
    add("M=77, c1-c0 not a multiple of 4", 2, 600, 77, -1, 80,
        [(0, 77, 0, 2), (5, 38, 0, 2), (3, 77, 0, 1)], dup_and_pad)
    add("a run spanning 40 poses cut by the pose window, one-pose windows",
        40, 16, 50, 0, 50,
        [(0, 50, 0, 40), (0, 50, 5, 33), (7, 8, 0, 40), (0, 50, 17, 18)],
        spanning)
    add("empty runs (ids in [0, 50) of M=500)", 6, 20, 500, 0, 50,
        [(0, 500, 0, 6), (40, 300, 2, 5)])
    return cases


def broadcast_edge_cases(seed: int = 7):
    """Segment-broadcast inputs off the main path's shapes, as numpy arrays:
    a list of ``(name, y (C, M) f64, ids (off + K,) int32, off)``; the
    broadcast's ids are the view ``ids[off:]`` of a tensor of ``ids``, so
    ``off = 1`` gives a contiguous view with a storage offset that is not
    16-byte aligned. K in {1, 3, 4,096, 4,097} (rows of a (C, K) output off
    16-byte boundaries where K % 4 != 0), C in {1, 3, 5, 6}, ids < 0 and
    >= M = 300; and M = 22,000 at C = 6 (y 528 KB in f32, past the 384 KB
    where the kernel walks one channel at a time)."""
    rng = np.random.default_rng(seed)
    cases = []

    def add(C, K, M, off):
        ids = rng.integers(-3, M + 3, off + K).astype(np.int32)
        cases.append((f"C={C} K={K} M={M} offset {off}",
                      rng.standard_normal((C, M)), ids, off))

    for K in (1, 3, 4096, 4097):
        for C in (1, 3, 5, 6):
            for off in (0, 1):
                add(C, K, 300, off)
    for off in (0, 1):
        add(6, 1001, 22_000, off)
    return cases


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


def bench_backend(problem, state, iters=10, repeats=3, cfg=None):
    """Time full LM solves: one warm-up, then the median of ``repeats``
    solves, each stopped after the device finished and the final cost was
    fetched to the host. ``cfg`` defaults to :func:`bench_config` of
    ``iters``. Returns (LM iterations/s, final cost)."""
    cfg = bench_config(iters) if cfg is None else cfg
    dt, cost = _seconds(
        lambda: solve_ba(problem, state, cfg)[1]["final_cost"], repeats)
    return cfg.max_iterations / dt, float(cost)


BATCH_WINDOWS = (8, 32)  # bench.py's B and B2
BATCH_WINDOW_SHAPE = dict(num_poses=50, num_landmarks=2000, obs_per_pose=240)


def ba_batched_problems(B: int = 32, device=None):
    """``bench.py``'s batched windows: :func:`make_problem` at 50 poses,
    2,000 landmarks and 240 observations per pose (12,000 slots), seed
    10 + i for window i < B, each with its band plan. Returns (problems,
    states), two lists."""
    out = [make_problem(**BATCH_WINDOW_SHAPE, seed=10 + i, device=device)
           for i in range(B)]
    return [p for p, _ in out], [s for _, s in out]


def batched_configs():
    """``bench.py``'s ``cfg_pcg`` (8 LM iterations, 20 CG steps at 1e-5,
    convergence freeze off) and ``cfg_dense`` (the same with the dense
    solver at any landmark count)."""
    cfg_pcg = BAConfig(max_iterations=8, cg_max_iters=20, cg_tol=1e-5,
                       relative_decrease_tol=0.0, absolute_decrease_tol=0.0)
    return cfg_pcg, dataclasses.replace(cfg_pcg, solver="dense",
                                        dense_max_landmarks=100_000)


def _seconds(fn, repeats: int = 3):
    """Median seconds of ``repeats`` calls of ``fn`` after one warm-up
    (kernel build and library load, allocator), each started after and
    ended by a synchronize and a host read of ``fn``'s tensor. Returns
    (seconds, the last call's tensor on the host)."""
    def once():
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        out = out.cpu()
        return time.perf_counter() - t0, out

    once()
    runs = [once() for _ in range(repeats)]
    return _median([t for t, _ in runs]), runs[-1][1]


def bench_ba_batched(problems, states, repeats: int = 3) -> dict:
    """``bench.py``'s ``bench_ba_batched`` keys on ``problems`` (at least
    32 windows, :func:`ba_batched_problems`): aggregate LM iterations/s of
    one window alone (PCG and dense), of B = 8 and 32 windows dense in one
    batch (and their speedups over B single PCG solves, as ``bench.py``
    computes them) and of 32 windows with PCG."""
    cfg_pcg, cfg_dense = batched_configs()
    iters = cfg_pcg.max_iterations
    out = {}
    dt1, _ = _seconds(lambda: solve_ba(problems[0], states[0], cfg_pcg)[1][
        "final_cost"], repeats)
    out["ba_window_iter_per_s_single"] = iters / dt1
    dt1d, _ = _seconds(lambda: solve_ba(problems[0], states[0], cfg_dense)[
        1]["final_cost"], repeats)
    out["ba_window_iter_per_s_single_dense"] = iters / dt1d
    for nb in BATCH_WINDOWS:
        dtb, _ = _seconds(lambda: solve_ba_batched(
            problems[:nb], states[:nb], cfg_dense)[1]["final_cost"], repeats)
        out[f"ba_batched{nb}_iter_per_s"] = nb * iters / dtb
        out[f"ba_batched{nb}_speedup"] = dt1 * nb / dtb
    nb = BATCH_WINDOWS[-1]
    dtp, _ = _seconds(lambda: solve_ba_batched(
        problems[:nb], states[:nb], cfg_pcg)[1]["final_cost"], repeats)
    out[f"ba_batched{nb}_pcg_iter_per_s"] = nb * iters / dtp
    return out


def bench_ba_large(problem, state) -> dict:
    """``bench.py``'s ``bench_ba_large`` rate on :func:`ba_large_problem`:
    5 LM iterations, the median of 2 timed solves, and the final cost."""
    rate, cost = bench_backend(problem, state, iters=5, repeats=2)
    return {"ba_lm_iterations_per_s_100k_landmarks": rate,
            "ba_100k_final_cost": cost}


def device_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured into one CUDA
    graph and replayed between two CUDA events. The replay launches every
    kernel without the host, so this is the device's time (with the gaps
    between its kernels) whatever the host's launch rate or the depth of the
    launch queue. ``fn`` must not synchronize: such a function cannot be
    captured; time it with :func:`wall_ms`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as PyTorch asks
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()  # the first replay uploads the graph
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    graph.reset()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int = 50, warmup: int = 3) -> float:
    """Host-clock ms per call of ``fn`` over ``reps`` back-to-back calls
    that end in a synchronize: what a loop of such calls waits for."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


MATVEC_OBS = (300, 600, 1200, 2400)


def matvec_profile(device=None, obs=MATVEC_OBS, reps: int = 50):
    """``bench.py``'s ``bench_matvec_profile`` on the card: ms of one
    matrix-free ``schur_matvec`` on the 200-pose, 10,000-landmark problem
    at each observation count per pose, the fit t(K) = a + b*K over the
    observation-bank size K, and one matvec's ops at 300 observations per
    pose: the landmark broadcast (3 x K), the landmark reduce (3 x K), the
    two W sweeps, the pose slot sum and the Hpp block product. Device time
    (:func:`device_ms`, a CUDA graph of ``reps`` calls) each, and the
    headline matvec's host-clock time (:func:`wall_ms`); needs a CUDA
    device."""
    device = resolve(device)
    if device.type != "cuda":
        raise ValueError("matvec_profile times the card: it needs a CUDA "
                         "device")
    out, sizes, headline = {}, {}, None
    for n_obs in obs:
        problem, state = make_problem(obs_per_pose=n_obs, device=device)
        with full_f32():
            blocks = _linearize_ba(problem, state,
                                   torch.tensor(1e-4, device=device))
        x = torch.ones((problem.free_pose.shape[0], 6), device=device)
        with full_f32():
            ms = device_ms(lambda: schur.schur_matvec(blocks, x), reps)
            if headline is None:
                headline = (blocks, x)
                out[f"ba_matvec_wall_ms_obs{n_obs}"] = wall_ms(
                    lambda: schur.schur_matvec(blocks, x), reps)
        sizes[int(problem.pose_idx.shape[0])] = ms
        out[f"ba_matvec_ms_obs{n_obs}"] = ms
    ks = np.array(sorted(sizes), dtype=np.float64)
    ts = np.array([sizes[int(k)] for k in ks])
    slope, fixed = np.polyfit(ks, ts, 1)
    out["ba_matvec_fixed_latency_ms"] = float(fixed)
    out["ba_matvec_ns_per_obs"] = float(slope * 1e6)
    out["ba_matvec_latency_fraction_headline"] = float(fixed / ts[0])

    blocks, x = headline
    ell = blocks.ell
    vals3 = torch.ones((3,) + tuple(blocks.W.shape[1:]), device=device)
    flat3 = vals3.reshape(3, -1)
    y3 = torch.ones((3, blocks.bl.shape[-1]), device=device)
    xk = x.T[:, :, None]
    ops = {
        "lm_broadcast_3xK": lambda: schur._gather_lm(blocks, y3),
        "lm_seg_reduce_3xK": lambda: schur.ell_seg_reduce(flat3, ell),
        "w_sweeps_elementwise": lambda: (schur._w_t_apply(blocks.W, xk),
                                         schur._w_apply(blocks.W, vals3)),
        "pose_slot_sum": lambda: torch.sum(vals3, dim=-1),
        "hpp_block_product": lambda: torch.einsum("nij,nj->ni",
                                                  blocks.Hpp, x),
    }
    out["ba_matvec_op_ms"] = {k: device_ms(fn, reps) for k, fn in ops.items()}
    return out


VIO_PARAMS = VoSimParams(nb_landmarks=120, steps=600, fx=200.0, fy=200.0,
                         hz=10.0)


def make_vio_problem(seed: int = 2, device=None, dtype=torch.float32):
    """``bench.py``'s ``bench_vio`` problem without JAX: the synthetic VO
    dataset of :data:`VIO_PARAMS` (landmarks from ``seed``), its VIO problem
    with pixel noise 0.7 px and IMU noise 1e-4 rad/s, 1e-3 m/s^2 (drawn on
    ``device`` from ``seed + 1``), cast to ``dtype``, and the perturbed
    start (0.01 rad, 0.03 m, 0.2 m on the landmarks, from ``seed + 2``).
    The draws are the port's own: the JAX package's keys give other
    numbers. Returns (problem, ground truth, start state)."""
    device = resolve(device)
    ds = generate_vo_dataset(VIO_PARAMS, seed=seed, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    problem, gt = vio.vio_from_sim(
        ds, pixel_noise=0.7, imu_gyro_sigma=1e-4, imu_accel_sigma=1e-3,
        generator=gen, device=device,
    )

    def cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    problem = problem._replace(
        pim=type(problem.pim)(*map(cast, problem.pim)),
        **{f: cast(getattr(problem, f)) for f in problem._fields
           if f not in ("pim", "ell")},
    )
    N, M = gt.q.shape[0], gt.lm.shape[0]
    gen = torch.Generator(device=device).manual_seed(seed + 2)

    def noise(*shape):
        return torch.randn(shape, generator=gen, dtype=gt.p.dtype,
                           device=device)

    init = vio.VIOState(
        q=so3.quat_boxplus(gt.q, 0.01 * noise(N, 3)).to(dtype),
        p=(gt.p + 0.03 * noise(N, 3)).to(dtype),
        v=gt.v.to(dtype),
        bg=torch.zeros((N, 3), dtype=dtype, device=device),
        ba=torch.zeros((N, 3), dtype=dtype, device=device),
        lm=(gt.lm + 0.2 * noise(M, 3)).to(dtype),
    )
    return problem, gt, init


def vio_config(solver: str = "auto") -> "vio.VIOConfig":
    """``bench.py``'s ``bench_vio`` solver configuration: 15 LM
    iterations, 60 CG steps."""
    return vio.VIOConfig(max_iterations=15, cg_max_iters=60, solver=solver)


def bench_vio(problem, init, solver="auto", repeats=3):
    """Time whole VIO solves as :func:`bench_backend` does: one warm-up,
    then the median of ``repeats`` solves. Returns (keyframes/s, final
    cost)."""
    cfg = vio_config(solver)

    def run_once():
        if init.p.is_cuda:
            torch.cuda.synchronize(init.p.device)
        t0 = time.perf_counter()
        _, info = vio.solve_vio(problem, init, cfg)
        cost = float(info["final_cost"])
        return time.perf_counter() - t0, cost

    run_once()
    times, cost = [], 0.0
    for _ in range(repeats):
        dt, cost = run_once()
        times.append(dt)
    return init.q.shape[0] / _median(times), cost


def windowed_ba_circle(params: VoSimParams = VoSimParams(
        nb_landmarks=120, steps=2000, fx=200.0, fy=200.0, hz=10.0),
        seed: int = 0):
    """The synthetic circle of the JAX package's windowed-BA test
    (``tests/test_windowed_ba.py:48-104``) as host f64 arrays made from
    seeds: landmarks of ``seed`` (numpy, :func:`draw_landmarks`), 1 px of
    pixel noise, odometry between-factors with 1e-2 rad and m of noise
    (sqrt-information 1e2), priors on the first two camera poses and the
    init offset by (-0.02, 0.02, 0.02) rad and (0.02, -0.03, 0.05) m in
    each camera's frame; every draw from ``numpy.random.default_rng(seed +
    1)``. Returns a dict: ``K``, ``tracks`` ((frame, id, u, v) rows),
    ``num_frames``, ``q_init``, ``p_init``, ``between`` and ``priors``
    (dicts of the bank fields), ``q_gt``, ``p_gt`` (camera poses)."""
    from libwave_tpu_torch.sim.vo_dataset import q_BC

    ds = generate_vo_dataset(params, seed=seed, device="cpu")
    frames = np.nonzero(ds.frame_has_obs.numpy())[0]
    N = len(frames)
    q_gt = so3.quat_multiply(ds.robot_q_GB[frames],
                             q_BC(torch.float64, "cpu").expand(N, 4)).numpy()
    p_gt = ds.robot_p_GB.numpy()[frames]
    vis = ds.visible.numpy()[frames]
    px = ds.pixels.numpy()[frames]
    fr, lm = np.nonzero(vis)
    tracks = np.stack([fr, lm, px[fr, lm, 0], px[fr, lm, 1]],
                      axis=1).astype(np.float64)
    rng = np.random.default_rng(seed + 1)
    tracks[:, 2:] += rng.standard_normal((len(tracks), 2))

    def exp_q(v):
        return so3.exp_quat(torch.as_tensor(v)).numpy()

    # odometry: the true relative poses, each perturbed by its own sigmas
    i = np.arange(N - 1)
    qi_inv = q_gt[i] * np.array([1.0, -1.0, -1.0, -1.0])
    dq = _quat_multiply_np(_quat_multiply_np(qi_inv, q_gt[i + 1]),
                           exp_q(1e-2 * rng.standard_normal((N - 1, 3))))
    dp = np.einsum("nji,nj->ni", so3.quat_to_rot(torch.as_tensor(q_gt[i]))
                   .numpy(), p_gt[i + 1] - p_gt[i])
    dp = dp + 1e-2 * rng.standard_normal((N - 1, 3))
    between = dict(i=i.astype(np.int32), j=(i + 1).astype(np.int32), dq=dq,
                   dp=dp, sqrt_info=np.full((N - 1, 6), 1e2))
    priors = dict(i=np.array([0, 1], np.int32), q=q_gt[:2], p=p_gt[:2],
                  sqrt_info=np.concatenate([np.full((2, 3), 1e5),
                                            np.full((2, 3), 1e6)], axis=-1))
    off_q = exp_q(np.array([-0.02, 0.02, 0.02]))
    q_init = _quat_multiply_np(q_gt, np.broadcast_to(off_q, (N, 4)))
    off_p = np.array([0.02, -0.03, 0.05])
    p_init = p_gt + np.einsum(
        "nij,j->ni", so3.quat_to_rot(torch.as_tensor(q_gt)).numpy(), off_p)
    return dict(K=ds.camera_K.numpy(), tracks=tracks, num_frames=N,
                q_init=q_init, p_init=p_init, between=between,
                priors=priors, q_gt=q_gt, p_gt=p_gt)
