"""Plain PyTorch reference of the benchmark's bundle-adjustment solve.

It imports only ``torch`` and takes the raw observations (camera and point
of each, measured pixels), the intrinsics, the start state and the solver
settings, and works out everything else itself: it keeps the observations
flat in their given order and sums them by camera and by point with
``index_add_``, so it needs no pose-ELL packing, landmark order, segment
layout or band plan. Its reduced camera system is always matrix-free
(``S x`` as two passes over the observations), which in exact arithmetic is
the same operator an explicit ``S`` holds.

The method is the one ``BAConfig`` documents, written down from its
mathematics: Levenberg-Marquardt on the product manifold (``q <- q exp(w)``,
``p <- p + dp``, ``X <- X + dX``); Marquardt damping of the pose and point
diagonals with an additive floor; points eliminated in closed 3x3 blocks;
the reduced system solved by preconditioned conjugate gradients with the
block-Jacobi (SCHUR_JACOBI) preconditioner, a fixed number of steps stopped
by the residual test ``|r|^2 <= tol^2 |b|^2``; back substitution; the
cheirality penalty; acceptance on a cost decrease; the freeze once an
accepted step gains less than the decrease tolerances.

Contractions (every sum of products) go through :func:`_mm` and
:func:`_dot`, elementwise products summed in the working dtype, so no
library matmul and no TF32 setting touches them. ``rounding=tf32`` rounds
every operand of those products to TF32 (10 fraction bits) first: the same
reference computed one precision below float32, the benchmark's control.
Cost sums accumulate in float64.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

CHEIRALITY_PENALTY = 1e6


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties to even:
    the low 13 of float32's 23 fraction bits cleared."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


@dataclass(frozen=True)
class Observations:
    """The raw problem: flat observations and the camera model."""

    cam: torch.Tensor  # (K,) int64
    pt: torch.Tensor  # (K,) int64
    uv: torch.Tensor  # (K, 2)
    intrinsics: tuple  # (fx, fy, cx, cy)
    free: torch.Tensor  # (N,) 1 free, 0 gauge-fixed
    num_cameras: int
    num_points: int


def _mm(a, b, rnd):
    """Batched small matrix product a (..., i, j) b (..., j, k)."""
    return (rnd(a)[..., :, :, None] * rnd(b)[..., None, :, :]).sum(-2)


def _mv(a, v, rnd):
    """Batched a (..., i, j) v (..., j)."""
    return (rnd(a) * rnd(v)[..., None, :]).sum(-1)


def _dot(a, b, rnd):
    return (rnd(a) * rnd(b)).sum()


def _sum_by(idx, vals, n):
    out = vals.new_zeros((n,) + vals.shape[1:])
    return out.index_add_(0, idx, vals)


def rotation(q):
    """Camera-to-world rotation of quaternions (w, x, y, z), (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def boxplus(q, w):
    """q exp(w): the right perturbation of quaternions q by rotation
    vectors w."""
    t2 = (w * w).sum(-1, keepdim=True)
    small = t2 < 1e-12
    t = torch.sqrt(torch.where(small, 1.0, t2))
    c = torch.where(small, 1 - t2 / 8, torch.cos(t / 2))
    s = torch.where(small, 0.5 - t2 / 48, torch.sin(t / 2) / t)
    e = torch.cat([c, s * w], -1)
    aw, ax, ay, az = q.unbind(-1)
    bw, bx, by, bz = e.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def _project(obs, q, p, X, rnd):
    """Residuals (K, 2) (zero behind the camera), validity (K,), and the
    pieces the Jacobians need."""
    R = rotation(q)[obs.cam]  # (K, 3, 3)
    d = X[obs.pt] - p[obs.cam]
    pc = _mv(R.mT, d, rnd)  # R^T (X - p)
    x, y, z = pc.unbind(-1)
    valid = z > 1e-6
    zs = torch.where(valid, z, 1.0)
    fx, fy, cx, cy = obs.intrinsics
    r = torch.stack([fx * x / zs + cx, fy * y / zs + cy], -1) - obs.uv
    return r * valid[:, None], valid, R, pc, zs


def cost(obs, q, p, X, rnd=exact) -> torch.Tensor:
    """0.5 sum |r|^2 plus the penalty per observation behind its camera,
    summed in float64 (a 0-d tensor)."""
    r, valid, *_ = _project(obs, q, p, X, rnd)
    r = r.double()
    return 0.5 * (r * r).sum() + CHEIRALITY_PENALTY * (~valid).double().sum()


def exact_cost(obs, q, p, X) -> float:
    """The cost of a state in float64 throughout: the yardstick that judges
    a solve's answer."""
    f64 = torch.float64
    obs64 = Observations(obs.cam, obs.pt, obs.uv.to(f64), obs.intrinsics,
                         obs.free, obs.num_cameras, obs.num_points)
    return float(cost(obs64, q.to(f64), p.to(f64), X.to(f64)))


def _linearize(obs, q, p, X, rnd):
    """Residuals and Jacobians: J_pose (K, 2, 6) in [w, dp] order and
    J_point (K, 2, 3), zero behind the camera."""
    r, valid, R, pc, zs = _project(obs, q, p, X, rnd)
    fx, fy, _, _ = obs.intrinsics
    x, y, _ = pc.unbind(-1)
    zero = torch.zeros_like(x)
    vf = valid.to(x.dtype)
    jp = torch.stack([
        torch.stack([fx / zs, zero, -fx * x / (zs * zs)], -1),
        torch.stack([zero, fy / zs, -fy * y / (zs * zs)], -1),
    ], -2) * vf[:, None, None]  # d uv / d pc
    px, py, pz = pc.unbind(-1)
    hat = torch.stack([
        torch.stack([zero, -pz, py], -1),
        torch.stack([pz, zero, -px], -1),
        torch.stack([-py, px, zero], -1),
    ], -2)
    j_w = _mm(jp, hat, rnd)  # d pc / d w = hat(pc)
    j_x = _mm(jp, R.mT, rnd)  # d pc / d X = R^T
    return r, torch.cat([j_w, -j_x], -1), j_x


@dataclass
class _System:
    Hpp: torch.Tensor  # (N, 6, 6) damped
    Hll_inv: torch.Tensor  # (M, 3, 3) inverse of the damped point blocks
    W: torch.Tensor  # (K, 6, 3) weighted J_pose^T J_point
    bp: torch.Tensor  # (N, 6)
    bl: torch.Tensor  # (M, 3)


def _damp(H, lam, floor):
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    return H + torch.diag_embed(lam * d + floor)


def _normal_equations(obs, r, jpose, jpt, lam, rnd):
    N, M = obs.num_cameras, obs.num_points
    floor = 1e-6 if r.dtype == torch.float32 else 1e-10
    jpT, jlT = jpose.mT, jpt.mT
    Hpp = _sum_by(obs.cam, _mm(jpT, jpose, rnd), N)
    Hll = _sum_by(obs.pt, _mm(jlT, jpt, rnd), M)
    bp = -_sum_by(obs.cam, _mv(jpT, r, rnd), N)
    bl = -_sum_by(obs.pt, _mv(jlT, r, rnd), M)
    W = _mm(jpT, jpt, rnd)
    Hll_inv, _ = torch.linalg.inv_ex(_damp(Hll, lam, floor))
    return _System(_damp(Hpp, lam, floor), Hll_inv, W, bp, bl)


def _pose_cross(obs, sysm, y, rnd):
    """sum over each camera's observations of W_k y[point_k]: (N, 6)."""
    return _sum_by(obs.cam, _mv(sysm.W, y[obs.pt], rnd), obs.num_cameras)


def _point_cross(obs, sysm, x, rnd):
    """sum over each point's observations of W_k^T x[camera_k]: (M, 3)."""
    return _sum_by(obs.pt, _mv(sysm.W.mT, x[obs.cam], rnd), obs.num_points)


def _schur_matvec(obs, sysm, x, rnd):
    free = obs.free[:, None]
    x = x * free
    y = _mv(sysm.Hll_inv, _point_cross(obs, sysm, x, rnd), rnd)
    out = _mv(sysm.Hpp, x, rnd) - _pose_cross(obs, sysm, y, rnd)
    return out * free


def _preconditioner(obs, sysm, rnd):
    """Inverse of the block diagonal of S, identity on gauge-fixed cameras."""
    WH = _mm(sysm.W, sysm.Hll_inv[obs.pt], rnd)  # (K, 6, 3)
    self_k = _mm(WH, sysm.W.mT, rnd)  # (K, 6, 6)
    S = sysm.Hpp - _sum_by(obs.cam, self_k, obs.num_cameras)
    m = obs.free[:, None].expand(-1, 6)
    eye = torch.eye(6, dtype=S.dtype, device=S.device)
    S = m[:, :, None] * S * m[:, None, :] + torch.diag_embed(1.0 - m)
    S = S + 1e-10 * eye
    L, _ = torch.linalg.cholesky_ex(S)
    return torch.cholesky_inverse(L)


def _pcg(obs, sysm, b, max_iters, tol, rnd):
    """Preconditioned CG on S x = b from x = 0; a step is taken while
    |r|^2 > tol^2 |b|^2, at most ``max_iters`` steps. Returns (x, steps)."""
    free = obs.free[:, None]
    P = _preconditioner(obs, sysm, rnd)

    def apply_p(v):
        return _mv(P, v * free, rnd) * free

    b = b * free
    x = torch.zeros_like(b)
    r = b
    z = apply_p(r)
    d = z
    rz = _dot(r, z, rnd)
    rr = _dot(b, b, rnd)
    thresh = tol * tol * rr
    steps = 0
    for _ in range(max_iters):
        if not bool(rr > thresh):
            break
        Sd = _schur_matvec(obs, sysm, d, rnd)
        denom = _dot(d, Sd, rnd)
        alpha = rz / torch.where(denom == 0, 1.0, denom)
        x = x + alpha * d
        r = r - alpha * Sd
        z = apply_p(r)
        rz_new = _dot(r, z, rnd)
        rr = _dot(r, r, rnd)
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        d = z + beta * d
        rz = rz_new
        steps += 1
    return x, steps


@dataclass(frozen=True)
class Settings:
    """The LM and CG settings, named as ``BAConfig`` names them."""

    max_iterations: int
    cg_max_iters: int
    cg_tol: float
    init_lambda: float
    lambda_up: float
    lambda_down: float
    min_lambda: float
    max_lambda: float
    relative_decrease_tol: float
    absolute_decrease_tol: float

    @classmethod
    def from_dict(cls, d: dict) -> "Settings":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__})


def solve(obs: Observations, q, p, X, settings: Settings, rounding=exact):
    """The LM solve from (q, p, X). Returns ``(q, p, X, info)`` with info
    ``costs`` (the accepted cost after each iteration, float64),
    ``accepted``, ``cg_iterations`` and ``initial_cost``."""
    rnd = rounding
    lam = settings.init_lambda
    c = float(cost(obs, q, p, X, rnd))
    info = {"initial_cost": c, "costs": [], "accepted": [],
            "cg_iterations": []}
    converged = False
    free = obs.free[:, None]
    for _ in range(settings.max_iterations):
        r, jpose, jpt = _linearize(obs, q, p, X, rnd)
        sysm = _normal_equations(obs, r, jpose, jpt, lam, rnd)
        y = _mv(sysm.Hll_inv, sysm.bl, rnd)
        rhs = (sysm.bp - _pose_cross(obs, sysm, y, rnd)) * free
        dx, steps = _pcg(obs, sysm, rhs, settings.cg_max_iters,
                         settings.cg_tol, rnd)
        dx = dx * free
        dX = _mv(sysm.Hll_inv,
                 sysm.bl - _point_cross(obs, sysm, dx, rnd), rnd)
        q1, p1, X1 = boxplus(q, dx[:, :3]), p + dx[:, 3:], X + dX
        c1 = float(cost(obs, q1, p1, X1, rnd))
        finite = bool(torch.isfinite(dx.sum()) & torch.isfinite(dX.sum()))
        accept = (c1 < c and not converged and c1 == c1
                  and c1 != float("inf") and finite)
        if accept:
            converged = (c - c1 < settings.relative_decrease_tol * c
                         + settings.absolute_decrease_tol)
            q, p, X, c = q1, p1, X1, c1
        if not converged:
            lam = lam * (settings.lambda_down if accept
                         else settings.lambda_up)
            lam = min(max(lam, settings.min_lambda), settings.max_lambda)
        info["costs"].append(c)
        info["accepted"].append(accept)
        info["cg_iterations"].append(steps)
    return q, p, X, info
