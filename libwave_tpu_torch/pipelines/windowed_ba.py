"""Sliding-window bundle adjustment: vision-only long-sequence solves.

Port of ``libwave_tpu.pipelines.windowed_ba``, the vision-only sibling of
:mod:`~libwave_tpu_torch.pipelines.windowed_vio` (the windowed form of the
reference's offline KITTI example: projection factors, noisy odometry
between-factors and priors, there solved as one global graph):

- fixed-size keyframe windows with ``overlap`` shared frames marching down
  the sequence by ``window - overlap``;
- **marginalization mode (default)**: after each window solves, the
  out-of-window poses and their factors (the full live tracks of every
  landmark touching an out-frame, between-factors reaching out of the
  overlap, window-0 priors and the incoming prior) are Schur-complement
  marginalized onto the overlap poses on the host in f64
  (``optim.marginalization``); the next window carries that dense
  (O*6)^2 prior on its head poses (``BAProblem.prior_Lambda``), a
  fixed-lag smoother;
- **freeze mode (ablation)**: the head poses are pinned at the previous
  window's estimates;
- window ``w``'s tail initializes from the caller's full-trajectory poses,
  anchor-corrected by the rigid transform that takes the provided init to
  the solved chain at the anchor frame;
- per-window landmarks re-triangulate from the corrected init (gated DLT,
  the ``euroc_vio`` machinery with an identity camera extrinsic).

Host bookkeeping is numpy in f64, as in the reference; each window's
problem, its LM solve (``solve_ba``) and its reduced Hessian
(``ba_reduced_hessian``) live on ``device`` (default: the card) in
``dtype``. The reference pads every window's shift masks to one count so
one jit executable serves the sequence; the port's layout has none, so
that step is gone.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from libwave_tpu_torch.geometry import so3
from libwave_tpu_torch.optim import schur
from libwave_tpu_torch.optim.ba import (
    BAConfig,
    BAProblem,
    BAState,
    ba_reduced_hessian,
    solve_ba,
)
from libwave_tpu_torch.optim.marginalization import schur_marginalize
from libwave_tpu_torch.optim.pose_graph import BetweenBank, PriorBank
from libwave_tpu_torch.pipelines.euroc_vio import (
    _camera_P_mats,
    _track_bank,
    _triangulate_gated,
)
from libwave_tpu_torch.pipelines.windowed_vio import (
    WindowedVIOParams as WindowedBAParams,  # same knobs: window/overlap/mode
    _excluded_mask,
    _marg_obs_split,
    _sync,
    _window_starts,
)
from libwave_tpu_torch.utils.device import resolve

__all__ = ["WindowedBAParams", "solve_ba_windowed"]

_IDENTITY_Q = np.array([1.0, 0.0, 0.0, 0.0])


def _slice_between(between: BetweenBank | None, s: int, W: int, f_max: int,
                   device, dtype, marg_boundary: int | None = None):
    """Between-factors with both endpoints inside [s, s+W), re-indexed
    locally and padded to ``f_max`` zero-information slots, on ``device``.
    ``marg_boundary``: additionally zero the information of factors lying
    entirely inside the keep-set [marg_boundary, W) (they belong to the
    next window)."""
    if between is None or f_max == 0:
        return None
    i = schur._host(between.i)
    j = schur._host(between.j)
    sel = (i >= s) & (i < s + W) & (j >= s) & (j < s + W)
    pad = f_max - int(sel.sum())

    def padded(arr, fill_row):
        if pad:
            arr = np.concatenate([arr, np.tile(fill_row, (pad, 1))])
        return torch.as_tensor(arr, dtype=dtype).to(device)

    si = schur._host(between.sqrt_info)[sel]
    if marg_boundary is not None:
        keep_only = (
            (i[sel] - s >= marg_boundary) & (j[sel] - s >= marg_boundary)
        )
        si = si * ~keep_only[:, None]

    def index(x):
        return torch.as_tensor(
            np.concatenate([x[sel] - s, np.zeros(pad, x.dtype)]),
            dtype=torch.int32).to(device)

    return BetweenBank(
        i=index(i), j=index(j),
        dq=padded(schur._host(between.dq)[sel], _IDENTITY_Q),
        dp=padded(schur._host(between.dp)[sel], np.zeros(3)),
        sqrt_info=padded(si, np.zeros(si.shape[1])),  # zero rows = silent
    )


def _far_priors(priors: PriorBank | None, device, dtype):
    """Later windows keep the prior bank's shape but silence it: zero
    sqrt-information rows on local index 0."""
    if priors is None:
        return None
    n = priors.i.shape[0]
    return PriorBank(
        i=torch.zeros((n,), dtype=torch.int32, device=device),
        q=torch.as_tensor(_IDENTITY_Q, dtype=dtype).to(device).expand(n, 4),
        p=torch.zeros((n, 3), dtype=dtype, device=device),
        sqrt_info=torch.zeros((n, priors.sqrt_info.shape[1]), dtype=dtype,
                              device=device),
    )


def _priors_on(priors: PriorBank | None, device, dtype):
    if priors is None:
        return None
    return PriorBank(
        i=priors.i.to(device=device, dtype=torch.int32),
        q=priors.q.to(device=device, dtype=dtype),
        p=priors.p.to(device=device, dtype=dtype),
        sqrt_info=priors.sqrt_info.to(device=device, dtype=dtype),
    )


def solve_ba_windowed(
    K: np.ndarray,
    tracks: np.ndarray,
    num_frames: int,
    q_init: np.ndarray,
    p_init: np.ndarray,
    between: BetweenBank | None = None,
    priors: PriorBank | None = None,
    wparams: WindowedBAParams = WindowedBAParams(),
    cfg: BAConfig | None = None,
    min_track_length: int = 2,
    outlier_gate_px: float = 100.0,
    gate_rounds: int = 2,
    device=None,
    dtype=torch.float32,
):
    """Chained window solves over a (frame, id, u, v) track bank, each on
    ``device`` (default: the card) in ``dtype``.

    ``q_init``/``p_init`` are the caller's full-trajectory initial CAMERA
    poses (host arrays); only window 0 consumes them directly, later
    windows apply them anchor-corrected. ``between``/``priors`` are banks of
    tensors on any device. Returns ``(q_est, p_est, report)``, the
    estimates as host f64 arrays.
    """
    wparams.validate()
    device = resolve(device)
    if cfg is None:
        cfg = BAConfig(max_iterations=40, cg_max_iters=150, huber_delta=3.0)
    N = num_frames
    W = min(wparams.window, N)
    O = min(wparams.overlap, W - 1) if W > 1 else 0
    step = max(W - O, 1)
    marg = wparams.mode == "marginalize" and O >= 1
    q_init = np.asarray(q_init, np.float64)
    p_init = np.asarray(p_init, np.float64)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt).to(device)

    starts = _window_starts(N, W, step, marg)

    # layout dims (independent of initialization)
    banks = [_track_bank(tracks, min(W, N - s), min_track_length,
                         frame_offset=s, return_raw=True) for s in starts]
    M_pad = max(max((b[3] for b in banks), default=1), 1)
    pmax_g = 1
    for pose_idx, *_ in banks:
        if len(pose_idx):
            pmax_g = max(pmax_g, int(np.bincount(pose_idx).max()))
    f_max = 0
    if between is not None:
        bi = schur._host(between.i)
        bj = schur._host(between.j)
        for s in starts:
            f_max = max(f_max, int(
                ((bi >= s) & (bi < s + W) & (bj >= s) & (bj < s + W)).sum()
            ))
    priors0 = _priors_on(priors, device, dtype)
    far_priors = _far_priors(priors, device, dtype)

    P = O * 6
    prior_Lambda = np.zeros((P, P))
    prior_b = np.zeros(P)
    if marg and priors is None:
        # soft gauge for window 0: anchor the first two poses at their
        # init; scale rides on the inter-pose baseline either way
        n_anchor = min(2, O)
        prior_Lambda[: n_anchor * 6, : n_anchor * 6] = (
            wparams.anchor_info * np.eye(n_anchor * 6)
        )

    prior0_Lambda = prior_Lambda.copy()
    est_q = np.zeros((N, 4))
    est_p = np.zeros((N, 3))
    est_q[0] = q_init[0]
    est_p[0] = p_init[0]
    solved_upto = 1
    excl_pairs = np.zeros((0, 2), np.int64)
    window_costs = []
    window_iters = []
    t_solve = 0.0
    t_marg = 0.0
    n_passes = wparams.passes if marg else 1

    # later passes (iterated fixed-lag smoothing) re-run the chain with
    # every window initialized from the previous pass's estimates
    for pass_idx in range(n_passes):
        if pass_idx > 0:  # fresh pass state (estimates carry)
            solved_upto = 1
            excl_pairs = np.zeros((0, 2), np.int64)
            prior_Lambda = prior0_Lambda.copy()
            prior_b = np.zeros(P)
            window_costs = []
        for wi, s in enumerate(starts):
            pose_idx, lm_idx, uv, M, raw_ids = banks[wi]
            nreal = min(W, N - s)
            head = max(min(solved_upto - s, W), 1)
            a = s + head - 1  # anchor: last chained global frame

            if pass_idx > 0:
                q0 = np.concatenate([
                    est_q[s: s + nreal],
                    np.tile(est_q[s + nreal - 1], (W - nreal, 1)),
                ])
                p0 = np.concatenate([
                    est_p[s: s + nreal],
                    np.tile(est_p[s + nreal - 1], (W - nreal, 1)),
                ])
            elif wi == 0:
                q0 = np.concatenate(
                    [q_init[s: s + nreal],
                     np.tile(_IDENTITY_Q, (W - nreal, 1))]
                )
                p0 = np.concatenate(
                    [p_init[s: s + nreal],
                     np.tile(p_init[min(N, s + nreal) - 1], (W - nreal, 1))]
                )
                q0[:head] = est_q[s: s + head]
                p0[:head] = est_p[s: s + head]
            else:
                # anchor-correct the provided init: T_corr maps init ->
                # solved at frame a, applied rigidly to the tail
                q_corr = so3.quat_multiply(
                    torch.as_tensor(est_q[a]),
                    so3.quat_conjugate(torch.as_tensor(q_init[a])),
                )
                R_corr = so3.quat_to_rot(q_corr).numpy()
                t_corr = est_p[a] - R_corr @ p_init[a]
                q0 = np.tile(_IDENTITY_Q, (W, 1))
                p0 = np.zeros((W, 3))
                q0[:head] = est_q[s: s + head]
                p0[:head] = est_p[s: s + head]
                tail_q = torch.as_tensor(q_init[a + 1: s + nreal])
                q0[head:nreal] = so3.quat_multiply(
                    q_corr.expand(tail_q.shape), tail_q).numpy()
                p0[head:nreal] = p_init[a + 1: s + nreal] @ R_corr.T + t_corr
                q0[nreal:] = q0[nreal - 1]
                p0[nreal:] = p0[nreal - 1]

            P_mats = _camera_P_mats(q0, p0, K, _IDENTITY_Q)
            if M > 0:
                lm_init, inlier = _triangulate_gated(
                    P_mats, pose_idx, lm_idx, uv, M, outlier_gate_px,
                    gate_rounds,
                )
                scale = np.ones(len(pose_idx))
                if marg:
                    reuse = {"split": 0.5, "exclusive": 0.0,
                             "duplicate": 1.0}[wparams.boundary_obs]
                    exm = _excluded_mask(pose_idx + s, raw_ids, excl_pairs)
                    if reuse == 0.0:
                        inlier &= ~exm
                    else:
                        scale = np.where(exm, reuse, 1.0)
                cnt = np.bincount(lm_idx[inlier], minlength=M)
                inlier &= cnt[lm_idx] >= 2
                weight = inlier * scale
            else:
                lm_init = np.zeros((0, 3))
                weight = np.zeros(0)
            lm0 = np.zeros((M_pad, 3))
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
                pose_idx, lm_idx, W, M_pad, uv, weight, *extra,
                min_pmax=pmax_g, device=device,
            )
            pad_mask = pad_mask.to(dtype)

            free = np.ones(W)
            if marg:
                free[nreal:] = 0.0  # pin final-window dummy frames
            else:
                if wi == 0 and priors is None:
                    free[: min(2, W)] = 0.0  # hard gauge when no priors given
                if wi > 0:
                    free[:head] = 0.0

            problem = BAProblem(
                K=dev(K),
                pose_idx=pose_ell,
                lm_idx=lm_ell,
                uv=uv_p.to(dtype),
                weight=w_p.to(dtype) * pad_mask,
                free_pose=dev(free),
                between=_slice_between(between, s, W, f_max, device, dtype),
                priors=priors0 if wi == 0 else far_priors,
                ell=ell,
                prior_Lambda=dev(prior_Lambda) if marg else None,
                prior_b=dev(prior_b) if marg else None,
                prior_q=dev(q0[:O]) if marg else None,
                prior_p=dev(p0[:O]) if marg else None,
            )
            state0 = BAState(q=dev(q0), p=dev(p0), lm=dev(lm0))
            _sync(device)
            t0 = _time.perf_counter()
            state, info = solve_ba(problem, state0, cfg)
            _sync(device)
            t_solve += _time.perf_counter() - t0
            window_costs.append(float(info["final_cost"]))
            window_iters.append(int(info["accepted"].shape[0]))
            sq, sp = state.q.cpu().numpy(), state.p.cpu().numpy()

            if marg or wi == 0:
                est_q[s: s + nreal] = sq[:nreal]
                est_p[s: s + nreal] = sp[:nreal]
            else:
                est_q[s + head: s + W] = sq[head:]
                est_p[s + head: s + W] = sp[head:]
            solved_upto = min(s + W, N)

            if marg and wi + 1 < len(starts):
                tm0 = _time.perf_counter()
                marg_problem = problem._replace(
                    weight=wm_p[0].to(dtype) * pad_mask,
                    between=_slice_between(
                        between, s, W, f_max, device, dtype,
                        marg_boundary=W - O,
                    ),
                )
                H, b = ba_reduced_hessian(marg_problem, state,
                                          cfg.huber_delta)
                prior_Lambda, prior_b = schur_marginalize(
                    H.cpu().numpy(), b.cpu().numpy(), keep_dim=P
                )
                excl_pairs = excl_next
                t_marg += _time.perf_counter() - tm0

    report = {
        "num_frames": N,
        "num_windows": len(starts),
        "window": W,
        "overlap": O,
        "mode": wparams.mode,
        "passes": n_passes,
        "window_final_costs": window_costs,
        "window_iterations": window_iters,
        "solve_seconds": t_solve,
        "marginalization_seconds": t_marg,
        "num_landmarks_padded": M_pad,
    }
    return est_q, est_p, report
