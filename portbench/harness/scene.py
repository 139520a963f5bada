"""A BAL-sized bundle-adjustment scene made from a seed.

The BAL problem files (Agarwal et al., "Bundle Adjustment in the Large",
ECCV 2010) are not in the repository, so each configuration keeps a BAL
problem's counts exactly (cameras, points, observations) and assumes the
rest: a sequential capture, as a SLAM map is built, rather than the BAL
photo collection's own (far less even) visibility.

- Structure (which camera sees which point) comes from the configuration's
  ``structure_seed`` alone, so every ``--seed`` solves the same sizes and
  sparsity. A point is seen by a run of consecutive cameras around a ring
  (a track, at least two cameras long); track lengths are drawn with the
  configuration's mean (observations / points) and then adjusted so that
  they sum to the observation count exactly; track starts are uniform.
  Point ids are ordered by the first camera of their track, as a mapper
  adds points when the cameras come in.
- Geometry comes from ``--seed``, drawn on the device with a
  ``torch.Generator`` in float64: cameras on a ring, looking outward, with
  small position and rotation jitter; each point placed beyond the ring at
  a depth where every camera of its track sees it inside the image
  (checked: the generator raises if any observation is behind its camera or
  outside the image). Pixel noise, the perturbed start state and the gauge
  (the first cameras fixed at their true poses) come from the traffic mix.

Camera model: calibrated pinhole with shared intrinsics and no distortion,
the model ``libwave_tpu_torch.optim.ba`` solves; quaternions are w-first,
camera-to-world.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Scene:
    """Raw observations and start state, on one device; what both the port
    and the plain reference are given."""

    num_cameras: int
    num_points: int
    cam: torch.Tensor  # (K,) int32 observation -> camera
    pt: torch.Tensor  # (K,) int32 observation -> point
    uv: torch.Tensor  # (K, 2) float32 measured pixels
    intrinsics: tuple  # (fx, fy, cx, cy)
    q0: torch.Tensor  # (N, 4) float32 start orientations
    p0: torch.Tensor  # (N, 3) float32 start positions
    X0: torch.Tensor  # (M, 3) float32 start points
    free: torch.Tensor  # (N,) float32, 0 for the gauge-fixed cameras
    max_camera_observations: int
    ell_padding_share: float  # padded slots of a pose-ELL bank / its slots

    @property
    def num_observations(self) -> int:
        return int(self.cam.shape[0])


def track_structure(num_cameras: int, num_points: int, num_obs: int,
                    max_track: int, seed: int):
    """Tracks of exactly ``num_obs`` observations in all: ``(start (M,),
    length (M,))`` numpy int64 arrays, points ordered by start camera.
    Lengths are 2 plus a geometric draw with the mean ``num_obs /
    num_points``, clipped to ``max_track``, then moved by one on randomly
    chosen points until they sum to ``num_obs``."""
    N, M, K = num_cameras, num_points, num_obs
    if not 2 * M <= K <= max_track * M or max_track > N:
        raise ValueError(f"{K} observations of {M} points cannot be tracks "
                         f"of 2 to {max_track} of {N} cameras")
    rng = np.random.default_rng(seed)
    p = 1.0 / (K / M - 1.0)  # P(stop) of the geometric part, mean K/M - 2
    u = rng.random(M)
    length = 2 + np.floor(np.log1p(-u) / math.log1p(-p)).astype(np.int64)
    length = np.minimum(length, max_track)
    while (diff := K - int(length.sum())) != 0:
        room = length < max_track if diff > 0 else length > 2
        pick = rng.permutation(np.nonzero(room)[0])[:abs(diff)]
        length[pick] += 1 if diff > 0 else -1
    start = rng.integers(0, N, M)
    order = np.argsort(start, kind="stable")
    return start[order], length[order]


def observations(start, length, num_cameras: int):
    """``(cam (K,), pt (K,))`` numpy int32: point j seen by cameras
    ``(start[j] + t) % N`` for ``t < length[j]``, in point order."""
    K = int(length.sum())
    pt = np.repeat(np.arange(length.shape[0], dtype=np.int64), length)
    first = np.repeat(np.cumsum(length) - length, length)
    t = np.arange(K, dtype=np.int64) - first
    cam = (np.repeat(start, length) + t) % num_cameras
    return cam.astype(np.int32), pt.astype(np.int32)


def quat_multiply(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def exp_quat(w):
    """Rotation vector (..., 3) -> unit quaternion (..., 4)."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)
    half = 0.5 * theta
    k = torch.where(theta > 1e-12, torch.sin(half) / theta.clamp_min(1e-300),
                    0.5)
    return torch.cat([torch.cos(half), k * w], dim=-1)


def rotation(q):
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def camera_frame(q, p, X):
    """Points X (K, 3) in the frames of cameras (q, p) (K, ...): R^T (X - p)."""
    return torch.einsum("kji,kj->ki", rotation(q), X - p)


def make_scene(config: dict, traffic: dict, seed: int,
               device: torch.device) -> Scene:
    """The scene of ``config`` under ``traffic`` for ``seed`` on ``device``."""
    sc = config["scene"]
    N, M, K = config["cameras"], config["points"], config["observations"]
    start, length = track_structure(N, M, K, sc["max_track"],
                                    sc["structure_seed"])
    cam_np, pt_np = observations(start, length, N)
    counts = np.bincount(cam_np, minlength=N)
    pmax = int(counts.max())

    f64 = torch.float64
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))

    def uniform(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device,
                                           dtype=f64)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=f64)

    W, H, f = sc["image_width"], sc["image_height"], sc["focal_px"]
    spacing = sc["camera_spacing"]
    step = 2 * math.pi / N
    ring = N * spacing / (2 * math.pi)
    jit_rot = math.radians(sc["rotation_jitter_deg"])
    jit_pos = sc["position_jitter"] * spacing
    min_depth = sc["min_depth"] * spacing
    # bearing budgets, less what the jitter can take (a rotation moves a
    # bearing by at most its angle; a position shift by its size over depth)
    shift = math.atan(2 * math.sqrt(3) * jit_pos / min_depth)
    beta_h = math.atan((W / 2 - sc["margin_px"]) / f) - 2 * jit_rot - shift
    beta_v = math.atan((H / 2 - sc["margin_px"]) / f) - 2 * jit_rot - shift
    if (sc["max_track"] - 1) * step >= beta_h:
        raise ValueError("max_track spans more of the ring than a camera sees")

    # cameras: on the ring, optical axis outward, x along the ring, y up
    theta = step * torch.arange(N, device=device, dtype=f64)
    p = torch.stack([ring * torch.cos(theta), ring * torch.sin(theta),
                     torch.zeros_like(theta)], -1)
    p = p + uniform(N, 3, lo=-jit_pos, hi=jit_pos)
    qz = torch.stack([torch.cos(theta / 2), torch.zeros_like(theta),
                      torch.zeros_like(theta), torch.sin(theta / 2)], -1)
    q_axes = torch.tensor([0.5, 0.5, 0.5, 0.5], device=device, dtype=f64)
    q = quat_multiply(quat_multiply(qz, q_axes.expand(N, 4)),
                      exp_quat(uniform(N, 3, lo=-jit_rot, hi=jit_rot)))

    # points: beyond the ring, where the whole track sees them
    s = torch.as_tensor(start, device=device).to(f64)
    span = torch.as_tensor(length - 1, device=device).to(f64) * step
    u = uniform(M)
    phi = s * step + u * span
    dmax = torch.maximum(u, 1 - u) * span
    rho_min = ring * math.sin(beta_h) / torch.sin(beta_h - dmax)
    depth = torch.clamp(rho_min - ring, min=min_depth) + uniform(
        M) * sc["depth_span"] * spacing
    rho = ring + depth
    z_min = rho * torch.cos(dmax) - ring - math.sqrt(3) * jit_pos
    h = uniform(M, lo=-1.0, hi=1.0) * math.tan(beta_v) * z_min
    X = torch.stack([rho * torch.cos(phi), rho * torch.sin(phi), h], -1)

    cam = torch.as_tensor(cam_np, device=device)
    pt = torch.as_tensor(pt_np, device=device)
    camk, ptk = cam.long(), pt.long()
    pc = camera_frame(q[camk], p[camk], X[ptk])
    z = pc[:, 2]
    uv_true = torch.stack([f * pc[:, 0] / z + W / 2, f * pc[:, 1] / z + H / 2],
                          -1)
    inside = (z > 0) & (uv_true[:, 0] >= 0) & (uv_true[:, 0] < W) & (
        uv_true[:, 1] >= 0) & (uv_true[:, 1] < H)
    if not bool(inside.all()):
        raise ValueError(f"{int((~inside).sum())} observations are behind "
                         "their camera or outside the image")

    uv = uv_true + traffic["pixel_noise_px"] * normal(K, 2)
    X0 = X + normal(M, 3) * (traffic["landmark_perturb_of_depth"]
                             * depth)[:, None]
    fixed = sc["fixed_cameras"]
    free = torch.ones(N, device=device, dtype=f64)
    free[:fixed] = 0.0
    dq = exp_quat(normal(N, 3) * math.radians(
        traffic["pose_rotation_perturb_deg"]) * free[:, None])
    q0 = quat_multiply(q, dq)
    p0 = p + normal(N, 3) * (traffic["pose_position_perturb_of_spacing"]
                             * spacing) * free[:, None]

    f32 = torch.float32
    return Scene(
        num_cameras=N, num_points=M, cam=cam, pt=pt, uv=uv.to(f32),
        intrinsics=(float(f), float(f), W / 2, H / 2),
        q0=q0.to(f32), p0=p0.to(f32), X0=X0.to(f32), free=free.to(f32),
        max_camera_observations=pmax,
        ell_padding_share=1.0 - K / (N * pmax),
    )
