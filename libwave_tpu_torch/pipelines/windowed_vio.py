"""Sliding-window VIO: bounded-memory solves for MH_01-length sequences.

Port of ``libwave_tpu.pipelines.windowed_vio``. The full-batch
``pipelines.euroc_vio`` solve keeps every keyframe in one factor graph; an
MH_01-scale sequence (~3,600 keyframes) needs bounded windows. The solver
windows itself:

- fixed-size keyframe windows with ``overlap`` shared keyframes, marching
  down the sequence by ``window - overlap``;
- **marginalization mode (default)**: after each window solves, the
  out-of-window states and their factors are Schur-complement marginalized
  onto the overlap states (``optim.marginalization``); the next window
  carries that dense prior on its head states (``VIOProblem.prior_Lambda``)
  with everything free, a fixed-lag smoother. Every measurement counts once
  across the chain: the marginalized factor set is the incoming prior, the
  full live tracks of every landmark touching an out-frame (their overlap
  observations included, see :func:`_marg_obs_split`), and the IMU and
  bias-walk intervals up to the overlap boundary;
- **freeze mode (ablation)**: the head keyframes are pinned at the previous
  window's estimates, a prior-free anchor (bounded-drift odometry);
- bias estimates carry forward as the next window's initialization;
- in marginalization mode window starts stay exactly ``step`` apart (the
  final window is padded with pinned zero-information dummy frames past the
  sequence end), so the marginalized keep-set aligns with the next head.

What runs where: the window march, track banks, triangulation, gating,
dead reckoning and the chain's bookkeeping are host numpy in f64, as in the
reference. Each window's problem and solve live on ``device`` (default: the
card) in ``dtype`` (default f32), with ``solve_vio`` called in chunks whose
one host read is the chunk's final cost. The Schur complement runs on the
device (:func:`~libwave_tpu_torch.pipelines.vio.vio_marginalize_device`,
only the prior leaves it) when the problem is on the card, else on the host
in f64 (``vio_reduced_hessian`` plus ``schur_marginalize``);
``WindowedVIOParams.marg_device`` forces either.

Differences from the reference, each on purpose:

- the reference pads every window's ELL shift masks to a common count so
  one jit executable serves the sequence (``_pad_shift_masks``); the port's
  layout has no shift masks and PyTorch does not trace, so that step is
  gone. The ``(M, pmax)`` pad buckets stay and are reported alike;
- a resume into a later pass restores the previous pass's estimates from
  the checkpoint (the reference re-snapshots them from estimates that are
  partly this pass's); a file without them resumes as the reference does;
- the seam alignment of a later pass transforms only the tail it keeps, as
  one batched quaternion product;
- the report counts the device complement's non-finite results that fell
  back to the host f64 complement (``marg_host_fallbacks``) and the LM
  iterations of each window solved in this run (``window_iterations``).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time as _time

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
from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.optim import schur
from libwave_tpu_torch.optim.marginalization import (
    psd_project,
    schur_marginalize,
)
from libwave_tpu_torch.optim.reprojection import reprojection_residual_ell
from libwave_tpu_torch.pipelines import vio as _vio
from libwave_tpu_torch.pipelines.euroc_vio import (
    EurocVIOParams,
    _camera_P_mats,
    _preintegrate_intervals,
    _track_bank,
    _triangulate_gated,
    default_vio_config,
)
from libwave_tpu_torch.pipelines.vio import (
    VIOConfig,
    VIOProblem,
    VIOState,
    solve_vio,
    vio_marginalize_device,
    vio_reduced_hessian,
)
from libwave_tpu_torch.sim.vo_dataset import q_BC as default_q_BC
from libwave_tpu_torch.utils.checkpoint import (
    _load_state_carry,
    _save_state_carry,
)
from libwave_tpu_torch.utils.device import resolve

__all__ = ["WindowedVIOParams", "run_euroc_vio_windowed"]

D = 15  # keyframe tangent dim


@dataclasses.dataclass(frozen=True)
class WindowedVIOParams:
    """Window-march settings; fields, defaults and meanings as in the
    reference (``libwave_tpu/pipelines/windowed_vio.py:91-176``)."""

    window: int = 100  # keyframes per window
    overlap: int = 10  # keyframes shared with the previous window
    # "marginalize": carry the out-of-window information forward as a
    # Schur-complement prior on the overlap (fixed-lag smoother);
    # "freeze": pin the overlap at the previous estimates (ablation)
    mode: str = "marginalize"
    # window-0 prior information on the first keyframe's 15 tangent dims
    # (1e8 = sigma 1e-4)
    anchor_info: float = 1e8
    # the overlap-frame observations of a marginalized track: "split"
    # (half here, half in the next window), "exclusive" (all here) or
    # "duplicate" (all in both; diagnostic only)
    boundary_obs: str = "split"
    # < 1 inflates the carried covariance; False drops the carried gradient
    prior_scale: float = 1.0
    prior_gradient: bool = True
    # where the Schur complement runs: None = on the device when the
    # problem is on the card, True/False to force
    marg_device: bool | None = None
    # forward passes of the whole chain (iterated fixed-lag smoothing)
    passes: int = 1
    # "auto" widens the pose-block sums, the reduced factorization and the
    # carried prior to f64 when max |imu_sqrt_info| > 3e4; None forces the
    # state's dtype; "float64" forces the widening
    hessian_dtype: str | None = "auto"
    # chunked adaptive LM: chunks of solve_iters_chunk iterations (lambda
    # carried), at most solve_chunks_max, stopping once a chunk improves
    # the cost by less than solve_rel_tol relative
    solve_iters_chunk: int = 12
    solve_chunks_max: int = 4
    solve_rel_tol: float = 1e-3
    # < 100: a typical (M, pmax) bucket at this percentile of the windows'
    # dims plus an overflow bucket at the global max
    pad_percentile: float = 100.0

    def validate(self):
        if self.overlap < 1 or self.overlap >= self.window:
            raise ValueError("need 1 <= overlap < window")
        if self.mode == "marginalize" and self.overlap > self.window // 2:
            # each frame must live in at most 2 consecutive windows: the
            # boundary-observation bookkeeping (excl_pairs) carries one
            # window back only
            raise ValueError(
                "marginalize mode needs overlap <= window // 2 (frames "
                "must span at most 2 windows for exact information "
                "accounting)"
            )
        if self.mode not in ("marginalize", "freeze"):
            raise ValueError("mode must be marginalize | freeze")
        if self.boundary_obs not in ("split", "exclusive", "duplicate"):
            raise ValueError(
                "boundary_obs must be split | exclusive | duplicate"
            )
        if self.hessian_dtype not in (None, "auto", "float64"):
            raise ValueError("hessian_dtype must be None | auto | float64")
        if not 1.0 <= self.pad_percentile <= 100.0:
            raise ValueError("pad_percentile must be in (1, 100]")


def _quat_to_rot_np(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _quat_mult_np(a, b):
    """Hamilton product of (..., 4) host quaternions, broadcast."""
    w1, x1, y1, z1 = np.moveaxis(np.asarray(a), -1, 0)
    w2, x2, y2, z2 = np.moveaxis(np.asarray(b), -1, 0)
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def _dead_reckon_np(q0, p0, v0, dq, dp, dv, dt, g):
    """Host IMU dead reckoning of a window's tail. Returns (L+1, ...)
    chains including the start state."""
    L = len(dt)
    qs = np.zeros((L + 1, 4))
    ps = np.zeros((L + 1, 3))
    vs = np.zeros((L + 1, 3))
    qs[0], ps[0], vs[0] = q0, p0, v0
    for i in range(L):
        R = _quat_to_rot_np(qs[i])
        ps[i + 1] = ps[i] + vs[i] * dt[i] + 0.5 * g * dt[i] ** 2 + R @ dp[i]
        vs[i + 1] = vs[i] + g * dt[i] + R @ dv[i]
        q = _quat_mult_np(qs[i], dq[i])
        qs[i + 1] = q / np.linalg.norm(q)
    return qs, ps, vs


def _seam_aligned_init(est, prev, s, W, head, nreal):
    """A later pass's window initialization: the head ``[0, head)`` from
    this pass's chain ``est``, the tail from the previous pass's estimates
    ``prev`` mapped into this pass's gauge by the 4-DoF transform (yaw
    about gravity + translation) that joins the two at the seam frame. The
    two passes drift apart in the unobservable directions, so an unaligned
    tail would start the window a seam away from its prior. ``est`` and
    ``prev`` are (q, p, v, bg, ba) tuples of (N, .) host arrays; rows past
    ``nreal`` repeat the last real frame's aligned tail value. Returns the
    (W, .) arrays (q0, p0, v0, bg0, ba0)."""
    h = min(head, nreal)
    a0 = s + h - 1  # seam: last this-pass frame
    R_rel = _quat_to_rot_np(est[0][a0]) @ _quat_to_rot_np(prev[0][a0]).T
    dyaw = np.arctan2(R_rel[1, 0], R_rel[0, 0])
    cz, sz = np.cos(dyaw), np.sin(dyaw)
    Rz = np.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]])
    qz = np.array([np.cos(dyaw / 2), 0.0, 0.0, np.sin(dyaw / 2)])
    dp = est[1][a0] - Rz @ prev[1][a0]
    # the frames kept from the previous pass, and the last real frame,
    # whose aligned value fills the padding rows
    lo = min(h, nreal - 1)
    tail = slice(s + lo, s + nreal)
    q = _quat_mult_np(qz, prev[0][tail])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    aligned = (q, prev[1][tail] @ Rz.T + dp, prev[2][tail] @ Rz.T,
               prev[3][tail], prev[4][tail])
    out = []
    for cur, seg in zip(est, aligned):
        x = np.empty((W, seg.shape[1]))
        x[lo:nreal] = seg
        x[nreal:] = seg[-1]
        x[:h] = cur[s:s + h]
        out.append(x)
    return tuple(out)


def _excluded_mask(frames_global, raw_ids, excl_pairs):
    """Boolean mask of observations listed in ``excl_pairs`` ((E, 2) rows
    of [global frame, original track id]): observations the previous
    window (partially or fully) marginalized into the incoming prior."""
    if excl_pairs is None or len(excl_pairs) == 0 or len(raw_ids) == 0:
        return np.zeros(len(raw_ids), bool)
    base = int(max(raw_ids.max(), excl_pairs[:, 1].max())) + 1
    key = frames_global.astype(np.int64) * base + raw_ids.astype(np.int64)
    excl_key = excl_pairs[:, 0] * base + excl_pairs[:, 1]
    return np.isin(key, excl_key)


def _marg_obs_split(pose_idx, lm_idx, raw_ids, weight, W, O, s,
                    boundary_obs="split"):
    """Full-track marginalization split of a window's observation bank.

    A landmark with any live observation at an out-frame (local index
    < W - O) is owned by the marginalization: its live observations,
    overlap frames included, enter the marginalization Hessian. What its
    overlap-frame observations do next is ``boundary_obs`` (see
    :class:`WindowedVIOParams`). Landmarks seen only in the overlap flow to
    the next window untouched.

    Returns ``(w_marg, pairs_next)``: ``pairs_next`` are (E, 2) [global
    frame, raw id] rows the NEXT window down-weights by the mode's reuse
    factor.
    """
    if len(lm_idx) == 0:
        return np.zeros(0), np.zeros((0, 2), np.int64)
    M = int(lm_idx.max()) + 1
    live = weight > 0
    out = pose_idx < W - O
    has_out = np.zeros(M, bool)
    has_out[lm_idx[live & out]] = True
    w_marg = weight * has_out[lm_idx]
    selx = live & ~out & has_out[lm_idx]
    if boundary_obs == "split":
        w_marg = np.where(selx, 0.5 * w_marg, w_marg)
    pairs = np.stack(
        [pose_idx[selx].astype(np.int64) + s,
         raw_ids[selx].astype(np.int64)], axis=1,
    )
    if boundary_obs == "duplicate":
        pairs = np.zeros((0, 2), np.int64)
    return w_marg, pairs


def _window_starts(N, W, step, marg):
    """Window starts: ``step`` apart in marginalization mode (the last
    window padded past the sequence end), the last one clamped to end at N
    in freeze mode."""
    if N <= W:
        return [0]
    if marg:
        return [i * step for i in range(int(np.ceil((N - W) / step)) + 1)]
    starts = list(range(0, N - W + 1, step))
    if starts[-1] != N - W:
        starts.append(N - W)
    return starts


def _pad_buckets(banks, percentile):
    """Per-window (M, pmax) padding dims: one global bucket, or with
    ``percentile`` < 100 a typical bucket at that percentile of the
    windows' dims plus an overflow bucket at the global max."""
    Ms = [max(b[3], 1) for b in banks]
    pmaxs = [
        max(int(np.bincount(b[0]).max()), 1) if len(b[0]) else 1
        for b in banks
    ]
    big = (max(Ms), max(pmaxs))
    if percentile < 100.0 and len(banks) >= 2:
        small = (int(np.ceil(np.percentile(Ms, percentile))),
                 int(np.ceil(np.percentile(pmaxs, percentile))))
        return [small if Ms[i] <= small[0] and pmaxs[i] <= small[1] else big
                for i in range(len(banks))]
    return [big] * len(banks)


def _pad_pim(pim, sqrt_infos, N, pad):
    """Append ``pad`` zero-information dummy intervals to the stacked
    preintegration (identity rotation deltas) and its whitening."""
    pim = type(pim)(*(torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
                      for x in pim))
    pim.dq[N - 1:, 0] = 1.0
    return pim, torch.cat([sqrt_infos, sqrt_infos.new_zeros((pad, 9, 9))])


def _debug_parts(pr, st, W, pixel_sigma):
    """Per-component costs (behind-camera count, vision, IMU, prior) for
    ``WAVE_DEBUG_WINDOWS``."""
    r, valid = reprojection_residual_ell(
        pr.K, _vio._camera_quats(pr, st.q), st.p, st.lm,
        pr.lm_idx.reshape(W, -1), pr.uv.T.reshape(2, W, -1),
    )
    wf = pr.obs_weight.reshape(W, -1)
    n_viol = torch.sum(wf * (~valid).to(wf.dtype))
    wv = wf * valid.to(wf.dtype)
    c_vis = 0.5 * torch.sum(wv * (r[0] ** 2 + r[1] ** 2) / pixel_sigma**2)
    ri, _, _ = _vio._imu_linearize(pr, st, None)
    c_imu = 0.5 * torch.sum(ri * ri)
    c_pri = (_vio._prior_cost(pr, st) if pr.prior_Lambda is not None
             else 0.0)
    return tuple(float(x) for x in (n_viol, c_vis, c_imu, c_pri))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_euroc_vio_windowed(
    root: str,
    params: EurocVIOParams = EurocVIOParams(),
    wparams: WindowedVIOParams = WindowedVIOParams(),
    cfg: VIOConfig | None = None,
    K: np.ndarray | None = None,
    tracks: np.ndarray | None = None,
    checkpoint_dir: str | None = None,
    stop_after_windows: int | None = None,
    device=None,
    dtype=torch.float32,
):
    """Windowed VIO over an EuRoC (ASL) sequence of any length, each window
    solved on ``device`` (default: the card) in ``dtype``.

    Ground truth enters only through the first window's initial state
    (q0, p0, v0) and the final ATE; every later window chains off the
    previous solution. Returns ``(est Trajectory, report dict)``, the
    trajectory as host f64 tensors.

    ``checkpoint_dir``: snapshot the chain (estimates and the marginal
    prior) after every solved window (an atomic npz, ``utils.checkpoint``);
    a rerun with the same arguments resumes after the last completed
    window. ``stop_after_windows`` stops the chain early; the report then
    carries ``completed=False`` and the ATE of the solved prefix.
    """
    wparams.validate()
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
    W = min(wparams.window, N)
    # a sequence at or below the overlap degrades to a single window
    O = min(wparams.overlap, W - 1) if W > 1 else 0
    step = max(W - O, 1)
    marg = wparams.mode == "marginalize" and O >= 1

    pim_stack, sqrt_infos = _preintegrate_intervals(
        imu, cam_times, N, params, device, dtype)
    starts = _window_starts(N, W, step, marg)
    N_ext = starts[-1] + W
    if N_ext > N:
        pim_stack, sqrt_infos = _pad_pim(pim_stack, sqrt_infos, N, N_ext - N)
    pim_np = type(pim_stack)(*(x.cpu().numpy() for x in pim_stack))

    Kmat = EUROC_CAM0_K if K is None else K
    qbc = default_q_BC(torch.float64, "cpu").numpy()
    g_vec = np.array([0.0, 0.0, -9.81])

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt).to(device)

    # per-window track banks and padding dims (layout only: the
    # initialization is sequential)
    banks = [
        _track_bank(tracks, min(W, N - s), params.min_track_length,
                    frame_offset=s, return_raw=True)
        for s in starts
    ]
    win_dims = _pad_buckets(banks, wparams.pad_percentile)
    M_pad = max(max(b[3], 1) for b in banks)

    # stiffness-gated widening: 5 Hz keyframes whiten to ~1.9e4 (the f32
    # chain is accurate), 10 Hz ~5.5e4, 20 Hz ~1.5e5 (f32 summation
    # drowns the ~1e2 vision information): gate between them
    hdt = wparams.hessian_dtype
    if hdt == "auto":
        stiff = float(sqrt_infos[: max(N - 1, 1)].abs().max())
        hdt = "float64" if stiff > 3e4 else None
    pdt = torch.float64 if hdt == "float64" else dtype

    if cfg is None:
        cfg = default_vio_config(params)
    if hdt is not None and cfg.hessian_dtype is None:
        cfg = dataclasses.replace(cfg, hessian_dtype=hdt)
    cfg_chunk = dataclasses.replace(
        cfg, max_iterations=wparams.solve_iters_chunk)

    def solve(pr, st):
        """Chunks of LM iterations with the lambda carried on the device,
        until a chunk stops paying or the chunk budget is spent."""
        lam = cfg.init_lambda
        info = None
        prev = None
        for _ in range(max(wparams.solve_chunks_max, 1)):
            st, ci = solve_vio(pr, st, cfg_chunk, lam0=lam)
            lam = ci["final_lambda"]
            cost = float(ci["final_cost"])
            if info is None:
                info = dict(ci)
                prev = float(ci["initial_cost"])
            else:
                info["final_cost"] = ci["final_cost"]
                info["accepted"] = torch.cat(
                    [info["accepted"], ci["accepted"]])
                info["costs"] = torch.cat([info["costs"], ci["costs"]])
            if prev - cost <= wparams.solve_rel_tol * abs(cost):
                break
            prev = cost
        return st, info

    debug = bool(os.environ.get("WAVE_DEBUG_WINDOWS"))
    P = O * D
    prior_Lambda = np.zeros((P, P))
    prior_b = np.zeros(P)
    marg_dev = False
    if marg:
        marg_dev = (wparams.marg_device if wparams.marg_device is not None
                    else device.type == "cuda")
        # only out-frames' bias priors enter the carried prior: overlap
        # frames get theirs in the next window
        bias_out_mask = np.zeros((W, 1))
        bias_out_mask[: W - O] = 1.0
        bias_out_mask_t = dev(bias_out_mask)
        # IMU and bias-walk intervals up to the overlap boundary only
        imu_marg_mask = np.ones(W - 1)
        imu_marg_mask[W - O:] = 0.0
        imu_marg_mask_t = dev(imu_marg_mask)[:, None, None]
        # window-0 prior: anchor the very first keyframe
        prior_Lambda[:D, :D] = wparams.anchor_info * np.eye(D)
    prior0_Lambda = prior_Lambda.copy()

    est = tuple(np.zeros((N, k)) for k in (4, 3, 3, 3, 3))
    est_q, est_p, est_v, est_bg, est_ba = est

    gi = int(np.argmin(np.abs(gt.times - cam_times[0])))
    est_q[0] = gt.q[gi] / np.linalg.norm(gt.q[gi])
    est_p[0] = gt.p[gi]
    est_v[0] = gt.v[gi]

    solved_upto = 1  # states [0, solved_upto) are final (current pass)
    excl_pairs = np.zeros((0, 2), np.int64)  # marginalized (frame, id) obs
    window_costs = []
    window_times = []
    window_iters = []
    t_solve = 0.0
    t_marg = 0.0
    fallbacks = 0
    windows_done = 0
    pass_done = 0
    n_passes = wparams.passes if marg else 1
    ckpt_path = None
    resumed_prev = None
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        ckpt_path = os.path.join(checkpoint_dir, "windowed_vio.npz")
        if os.path.exists(ckpt_path):
            like = {
                "est_q": est_q, "est_p": est_p, "est_v": est_v,
                "est_bg": est_bg, "est_ba": est_ba,
                "solved_upto": np.asarray(0),
                "windows_done": np.asarray(0),
                "window_costs": np.zeros(len(starts)),
                "prior_Lambda": prior_Lambda,
                "prior_b": prior_b,
                "excl_pairs": excl_pairs,
                "pass_done": np.asarray(0),
            }
            # the port's files of a later pass carry the previous pass's
            # estimates after the reference's leaves
            snap, carry = _load_state_carry(ckpt_path, like)
            snap = {k: v.numpy() for k, v in snap.items()}
            windows_done = int(snap["windows_done"])
            pass_done = int(snap["pass_done"])
            solved_upto = int(snap["solved_upto"])
            for arr, name in zip(est, ("est_q", "est_p", "est_v", "est_bg",
                                       "est_ba")):
                arr[:] = snap[name]
            prior_Lambda = snap["prior_Lambda"]
            prior_b = snap["prior_b"]
            excl_pairs = snap["excl_pairs"].reshape(-1, 2)
            window_costs = list(snap["window_costs"][:windows_done])
            if windows_done >= len(starts) and pass_done + 1 < n_passes:
                # the checkpoint finished a pass; resume into the next
                pass_done += 1
                windows_done = 0
                solved_upto = 1
                excl_pairs = np.zeros((0, 2), np.int64)
                prior_Lambda = prior0_Lambda.copy()
                prior_b = np.zeros(P)
                window_costs = []
            elif carry is not None:
                resumed_prev = tuple(c.numpy() for c in carry)

    resumed_pass = pass_done
    kf_solved_run = 0
    windows_run = 0
    stopped_early = False
    prev = None
    for pass_idx in range(resumed_pass, n_passes):
        if pass_idx > resumed_pass:  # fresh pass state (estimates carry)
            solved_upto = 1
            windows_done = 0
            excl_pairs = np.zeros((0, 2), np.int64)
            prior_Lambda = prior0_Lambda.copy()
            prior_b = np.zeros(P)
            window_costs = []
        if pass_idx >= 1:
            # the previous pass's estimates: later windows initialize their
            # tails from these while est is overwritten by this pass
            if pass_idx == resumed_pass and resumed_prev is not None:
                prev = tuple(x.copy() for x in resumed_prev)
            else:
                prev = tuple(x.copy() for x in est)
        for wi, s in enumerate(starts):
            if wi < windows_done:
                continue  # already solved (checkpoint resume)
            pose_idx, lm_idx, uv, M, raw_ids = banks[wi]
            M_pad_w, pmax_w = win_dims[wi]
            nreal = min(W, N - s)  # real (non-dummy) frames this window
            head = max(min(solved_upto - s, W), 1)

            # the head from the chain (the prior mean in marginalization
            # mode); the tail dead-reckoned from the last head state on
            # pass 0, seam-aligned from the previous pass afterwards
            a = s + head - 1  # last chained global index
            if pass_idx == 0:
                qs, ps, vs = _dead_reckon_np(
                    est_q[a], est_p[a], est_v[a],
                    pim_np.dq[a: s + W - 1], pim_np.dp[a: s + W - 1],
                    pim_np.dv[a: s + W - 1], pim_np.dt_total[a: s + W - 1],
                    g_vec,
                )
                q0 = np.concatenate([est_q[s:a], qs])
                p0 = np.concatenate([est_p[s:a], ps])
                v0 = np.concatenate([est_v[s:a], vs])
                bg0 = np.broadcast_to(est_bg[a], (W, 3)).copy()
                ba0 = np.broadcast_to(est_ba[a], (W, 3)).copy()
                bg0[: a - s] = est_bg[s:a]
                ba0[: a - s] = est_ba[s:a]
            else:
                q0, p0, v0, bg0, ba0 = _seam_aligned_init(
                    est, prev, s, W, head, nreal)

            # local triangulation + gating off the initialized chain
            P_mats = _camera_P_mats(q0, p0, Kmat, qbc)
            if M > 0:
                lm_init, inlier = _triangulate_gated(
                    P_mats, pose_idx, lm_idx, uv, M,
                    params.outlier_gate_px, params.gate_rounds,
                )
                scale = np.ones(len(pose_idx))
                if marg:
                    # observations the previous window marginalized carry
                    # only their reuse share here
                    reuse = {"split": 0.5, "exclusive": 0.0,
                             "duplicate": 1.0}[wparams.boundary_obs]
                    exm = _excluded_mask(pose_idx + s, raw_ids, excl_pairs)
                    if reuse == 0.0:
                        inlier &= ~exm
                    else:
                        scale = np.where(exm, reuse, 1.0)
                # landmarks left with < 2 inlier observations drop out
                cnt = np.bincount(lm_idx[inlier], minlength=M)
                inlier &= cnt[lm_idx] >= 2
                weight = inlier * scale
            else:
                lm_init = np.zeros((0, 3))
                weight = np.zeros(0)

            lm0 = np.zeros((M_pad_w, 3))
            lm0[:M] = lm_init

            extra = ()
            if marg:
                w_marg, excl_next = _marg_obs_split(
                    pose_idx, lm_idx, raw_ids, weight, W, O, s,
                    wparams.boundary_obs,
                )
                extra = (w_marg,)
            (pose_ell, lm_ell, pad_mask, ell, uv_p, w_p,
             *wm_p) = schur.pack_observations(
                pose_idx, lm_idx, W, M_pad_w, uv, weight, *extra,
                min_pmax=pmax_w, device=device,
            )
            pad_mask = pad_mask.to(dtype)

            free = np.ones((W, D))
            if marg:
                free[nreal:, :] = 0.0  # pin final-window dummy frames
            else:
                free[:head, :] = 0.0

            problem = VIOProblem(
                K=dev(Kmat),
                pose_idx=pose_ell,
                lm_idx=lm_ell,
                uv=uv_p.to(dtype),
                obs_weight=w_p.to(dtype) * pad_mask,
                pim=type(pim_stack)(*(x[s: s + W - 1] for x in pim_stack)),
                imu_i=torch.arange(W - 1, dtype=torch.int32, device=device),
                imu_j=torch.arange(1, W, dtype=torch.int32, device=device),
                imu_sqrt_info=sqrt_infos[s: s + W - 1],
                bias_walk_sqrt_info=torch.full(
                    (6,), params.bias_walk_sqrt_info, dtype=dtype,
                    device=device),
                bias_prior_sqrt_info=dev(np.concatenate([
                    np.full(3, params.bias_prior_gyro),
                    np.full(3, params.bias_prior_accel),
                ])),
                ell=ell,
                free_pose=dev(free),
                q_BC=dev(qbc),
                pixel_sigma=params.pixel_sigma,
                prior_Lambda=dev(prior_Lambda, pdt) if marg else None,
                prior_b=dev(prior_b, pdt) if marg else None,
                prior_q=dev(q0[:O]) if marg else None,
                prior_p=dev(p0[:O]) if marg else None,
                prior_v=dev(v0[:O]) if marg else None,
                prior_bg=dev(bg0[:O]) if marg else None,
                prior_ba=dev(ba0[:O]) if marg else None,
            )
            state0 = VIOState(q=dev(q0), p=dev(p0), v=dev(v0), bg=dev(bg0),
                              ba=dev(ba0), lm=dev(lm0))
            _sync(device)
            t0 = _time.perf_counter()
            state, info = solve(problem, state0)
            _sync(device)
            window_times.append(_time.perf_counter() - t0)
            t_solve += window_times[-1]
            window_costs.append(float(info["final_cost"]))
            window_iters.append(int(info["accepted"].shape[0]))
            sol = tuple(x.cpu().numpy() for x in state[:5])
            if debug:
                acc = info["accepted"].cpu().numpy().astype(int)
                dp_move = float(np.abs(sol[1][:nreal] - p0[:nreal]).max())
                v0_, cv0, ci0, cp0 = _debug_parts(problem, state0, W,
                                                  params.pixel_sigma)
                v1_, cv1, ci1, cp1 = _debug_parts(problem, state, W,
                                                  params.pixel_sigma)
                print(
                    f"[w {pass_idx}:{wi}] cost0 "
                    f"{float(info['initial_cost']):.4g}"
                    f" cost {window_costs[-1]:.4g} acc {acc.sum()}/{len(acc)}"
                    f" nobs {int((weight > 0).sum())} max|dp| {dp_move:.3f}\n"
                    f"   init: viol {v0_:.0f} vis {cv0:.4g} imu {ci0:.4g}"
                    f" prior {cp0:.4g}\n"
                    f"   final: viol {v1_:.0f} vis {cv1:.4g} imu {ci1:.4g}"
                    f" prior {cp1:.4g}",
                    file=sys.stderr, flush=True,
                )

            if marg:
                # the whole window re-estimated (overlap refined by the prior)
                for arr, x in zip(est, sol):
                    arr[s: s + nreal] = x[:nreal]
            else:
                for arr, x in zip(est, sol):
                    arr[s + head: s + W] = x[head:]
            kf_solved_run += min(s + W, N) - max(solved_upto, s)
            solved_upto = min(s + W, N)
            windows_done = wi + 1
            windows_run += 1

            if marg and wi + 1 < len(starts):
                tm0 = _time.perf_counter()
                marg_problem = problem._replace(
                    obs_weight=wm_p[0].to(dtype) * pad_mask,
                    imu_sqrt_info=problem.imu_sqrt_info * imu_marg_mask_t,
                    # bias priors of keep/overlap frames are excluded: the
                    # window that marginalizes them out counts them
                    bias_prior_sqrt_info=(
                        problem.bias_prior_sqrt_info[None, :]
                        * bias_out_mask_t
                    ),
                )
                host = not marg_dev
                if marg_dev:
                    Lam, b_m = vio_marginalize_device(
                        marg_problem, state, P, params.huber_delta,
                        cfg.hessian_dtype,
                    )
                    Lam, b_m = Lam.cpu().numpy(), b_m.cpu().numpy()
                    if np.isfinite(Lam).all() and np.isfinite(b_m).all():
                        prior_Lambda, prior_b = psd_project(Lam, b_m)
                    else:
                        # the device Cholesky met an indefinite H_oo (stiff
                        # chain roundoff): take the host f64 complement for
                        # this window instead of corrupting the chain
                        fallbacks += 1
                        host = True
                if host:
                    H, b = vio_reduced_hessian(
                        marg_problem, state, params.huber_delta,
                        cfg.hessian_dtype,
                    )
                    prior_Lambda, prior_b = schur_marginalize(
                        H.cpu().numpy(), b.cpu().numpy(), keep_dim=P
                    )
                prior_Lambda = prior_Lambda * wparams.prior_scale
                prior_b = (
                    prior_b * wparams.prior_scale
                    if wparams.prior_gradient else np.zeros(P)
                )
                excl_pairs = excl_next
                t_marg += _time.perf_counter() - tm0
                if debug:
                    ww = np.linalg.eigvalsh(prior_Lambda)
                    print(
                        f"[m {pass_idx}:{wi}] eig [{ww.min():.3g},"
                        f" {ww.max():.3g}] n<=0 {(ww <= 0).sum()}"
                        f" |b| {np.linalg.norm(prior_b):.4g}",
                        file=sys.stderr, flush=True,
                    )

            if ckpt_path is not None:
                costs_arr = np.zeros(len(starts))
                costs_arr[: len(window_costs)] = window_costs
                _save_state_carry(ckpt_path, {
                    "est_q": est_q, "est_p": est_p, "est_v": est_v,
                    "est_bg": est_bg, "est_ba": est_ba,
                    "solved_upto": np.asarray(solved_upto),
                    "windows_done": np.asarray(windows_done),
                    "window_costs": costs_arr,
                    "prior_Lambda": prior_Lambda,
                    "prior_b": prior_b,
                    "excl_pairs": excl_pairs,
                    "pass_done": np.asarray(pass_idx),
                }, prev)
            remaining = (
                (n_passes - 1 - pass_idx) * len(starts)
                + len(starts) - windows_done
            )
            if (stop_after_windows is not None
                    and windows_run >= stop_after_windows
                    and remaining > 0):
                stopped_early = True
                break
        if stopped_early:
            break

    n_solved = solved_upto if stopped_early else N
    t0c = float(cam_times[0])

    def host(a):
        return torch.as_tensor(np.asarray(a, np.float64))

    gt_traj = Trajectory(times=host(np.asarray(gt.times) - t0c),
                         poses=SE3(q=host(gt.q), t=host(gt.p)))
    est_traj = Trajectory(
        times=host(np.asarray(cam_times[:n_solved]) - t0c),
        poses=SE3(q=host(est_q[:n_solved]), t=host(est_p[:n_solved])),
    )
    ate, err = absolute_trajectory_error(gt_traj, est_traj)
    rpe_t, rpe_r, _ = relative_pose_error(gt_traj, est_traj, delta=1)
    if len(window_times) > 1:
        # the first window's time holds the kernels' first launches; the
        # steady rate replaces it with the median of the rest
        t_steady = t_solve - (
            window_times[0] - float(np.median(window_times[1:]))
        )
    else:
        t_steady = t_solve
    # rates count only keyframes advanced in THIS run; the window-march
    # rate counts re-solved keyframes once per pass, the sequence rate
    # divides the passes back out
    n_timed = kf_solved_run if window_times else 0
    passes_run = max(n_passes - resumed_pass, 1)
    report = {
        "ate_rmse": float(ate),
        "rpe_trans_rmse": float(rpe_t),
        "rpe_rot_rmse": float(rpe_r),
        "per_pose_error": err.numpy(),
        "num_keyframes": N,
        "num_keyframes_solved": n_solved,
        "completed": not stopped_early,
        "mode": wparams.mode,
        "passes": n_passes,
        "num_windows": len(starts),
        "windows_done": windows_done,
        "window": W,
        "overlap": O,
        "window_final_costs": window_costs,
        "window_iterations": window_iters,
        "solve_seconds": t_solve,
        "marginalization_seconds": t_marg,
        "marg_host_fallbacks": fallbacks,
        "solve_keyframes_per_s": n_timed / max(t_steady, 1e-9),
        "solve_keyframes_per_s_including_compile": n_timed / max(
            t_solve, 1e-9
        ),
        "sequence_keyframes_per_s": (
            n_timed / passes_run / max(t_steady, 1e-9)
        ),
        "hessian_dtype": cfg.hessian_dtype,
        "num_landmarks_padded": M_pad,
        "pad_buckets": sorted(set(win_dims)),
        "pad_bucket_windows": [
            sum(1 for d in win_dims if d == b)
            for b in sorted(set(win_dims))
        ],
    }
    return est_traj, report
