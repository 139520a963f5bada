"""Schur-complement marginalization for sliding-window solvers.

A copy of ``libwave_tpu.optim.marginalization`` (host f64 numpy; the port
imports nothing of the JAX package, so it keeps its own). What follows is
the reference's note.

The reference keeps every solve global (GTSAM/Ceres over the whole graph,
wave_gtsam/tests/gtsam/gtsam_offline_example.cpp:133) and only the
*tracker* windows (tracker.hpp:103-114). This framework windows the solver
itself (pipelines.windowed_vio / windowed_ba); what makes that statistically
sound — rather than a hard-anchor approximation — is carrying the
marginal of the out-of-window states forward as a dense prior:

    given the window's reduced (landmark-eliminated) Hessian H and rhs
    b = -grad at the solution, partition states into out `o` (leaving the
    window) and keep `k` (the overlap carried into the next window), then

        Lambda = H_kk - H_ko H_oo^-1 H_ok
        b_m    = b_k  - H_ko H_oo^-1 b_o

    is exactly the information the discarded states (and their factors)
    imply about the kept ones. The next window adds
    ``0.5 d^T Lambda d - b_m^T d`` over the head-state tangent delta d
    (pipelines.vio.VIOProblem.prior_Lambda), making the chain a fixed-lag
    smoother instead of frozen-anchor odometry.

Split of labor: H/b are built ON DEVICE by the reduced-Hessian primitives
(pipelines.vio.vio_reduced_hessian, optim.ba.ba_reduced_hessian); the
complement itself runs here on the HOST in float64 — it happens once per
window on a (W*D)^2 matrix, is latency- not throughput-bound, and the
subtraction cancels catastrophically in f32 when the IMU chain makes H
stiff.
"""

from __future__ import annotations

import numpy as np

__all__ = ["schur_marginalize", "psd_project"]


def schur_marginalize(H, b, keep_dim: int, rel_eps: float = 1e-10):
    """Marginalize all but the LAST ``keep_dim`` coordinates of (H, b).

    ``H`` (n, n) symmetric PSD information matrix, ``b`` (n,) rhs (-grad),
    both in tangent coordinates at the linearization point. Returns
    ``(Lambda (keep_dim, keep_dim), b_m (keep_dim,))``, with ``Lambda``
    projected to PSD (negative curvature from accumulation noise clipped,
    ``b_m`` projected onto the surviving range so no unbounded linear
    terms leak into the next window).

    Scale care: a chained prior mixes anchor information (~1e8-1e12 on
    gauge-pinned directions) with weak physical information (~1e0 on
    barely-observed ones) in the SAME matrix. Both the ridge and the PSD
    clip must therefore be per-direction/relative-free: the ridge is
    Marquardt-scaled off H_oo's own diagonal, and the eigenvalue clip
    removes only genuinely negative curvature — a threshold relative to
    the LARGEST eigenvalue (the anchor) would silently delete the weak
    directions and the chain drifts (measured on KITTI drive_0036: a
    1e-12*max cutoff cost several meters and made larger overlaps WORSE).
    """
    H = np.asarray(H, np.float64)
    b = np.asarray(b, np.float64)
    n = H.shape[0]
    cut = n - keep_dim
    if cut <= 0:
        return H.copy(), b.copy()
    Hoo = H[:cut, :cut]
    Hok = H[:cut, cut:]
    # per-coordinate Marquardt-scaled ridge keeps H_oo factorizable when a
    # direction is barely constrained (only ever weakens the prior)
    eps = rel_eps * np.maximum(np.diag(Hoo), 1.0)
    Hoo = Hoo + np.diag(eps)
    rhs = np.concatenate([Hok, b[:cut, None]], axis=1)
    try:
        sol = np.linalg.solve(Hoo, rhs)
    except np.linalg.LinAlgError:
        # a truly information-free out-direction (all factors silenced)
        # makes H_oo numerically singular even with the ridge; the
        # minimum-norm solve drops it, which only weakens the prior
        sol = np.linalg.lstsq(Hoo, rhs, rcond=None)[0]
    Lam = H[cut:, cut:] - Hok.T @ sol[:, :keep_dim]
    b_m = b[cut:] - Hok.T @ sol[:, -1]
    return psd_project(0.5 * (Lam + Lam.T), b_m)


def psd_project(Lam, b_m):
    """Clip negative curvature (accumulation noise) and project the rhs
    onto the surviving range — shared by the host complement above and
    the on-device complement (pipelines.vio.vio_marginalize_device)."""
    Lam = np.asarray(Lam, np.float64)
    b_m = np.asarray(b_m, np.float64)
    w, V = np.linalg.eigh(Lam)
    keep = w > 0.0
    Vk = V[:, keep]
    return (Vk * w[keep]) @ Vk.T, Vk @ (Vk.T @ b_m)
