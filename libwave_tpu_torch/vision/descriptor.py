"""BRISK-pattern binary descriptors (port of ``libwave_tpu.vision.descriptor``'s
BRISK part).

The reference samples a rotated BRISK pattern around every keypoint of the
fixed-capacity bank with bilinear gathers, takes the orientation from the
long-pair gradients, compares the short pairs and packs the bits into
32-bit words. Its per-keypoint ``vmap`` is an explicit (N, P) batch here:
the pattern is rotated per keypoint with elementwise products and the
samples are flat-index gathers ``y * W + x``.

Descriptor words keep the reference's uint32 bit pattern in ``torch.int32``
(bit 31 is the sign bit), the dtype the Hamming kernels take; ``interop``
crosses to numpy uint32 with ``ndarray.view``. The pre-smoothing is the
separable 5-tap Gaussian written as shifted sums, so no cuDNN convolution
(TF32 by default on the card) touches it.

ORB's rotated BRIEF (:func:`orb_describe`, :func:`orb_describe_pyramid`)
compares 256 seeded pairs of pattern points around each keypoint, rotated by
its angle, on the smoothed image (the pyramid version: on the keypoint's own
level, the levels padded into one (L, H, W) stack as in the reference). The
pattern is the reference's numpy draw from the same seed.

Every function takes images with leading batch dimensions ``(..., H, W)``
and keypoint banks ``(..., N, 2)``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from libwave_tpu_torch.utils.config import ConfigError
from libwave_tpu_torch.vision.detector import build_pyramid, fixed_order_sum


@dataclasses.dataclass(frozen=True)
class BRISKParams:
    radius_list: tuple = (0.0, 2.47, 4.17, 6.29, 9.18)
    number_list: tuple = (1, 10, 14, 15, 20)
    d_max: float = 5.85
    d_min: float = 8.2

    def validate(self):
        if len(self.radius_list) == 0 or len(self.number_list) == 0:
            raise ConfigError("radius_list/number_list cannot be empty")
        if len(self.radius_list) != len(self.number_list):
            raise ConfigError("radius_list and number_list must match in size")
        if any(r < 0 for r in self.radius_list):
            raise ConfigError("radii must be non-negative")
        if any(n <= 0 for n in self.number_list):
            raise ConfigError("number_list entries must be positive")
        if self.d_max >= self.d_min:
            raise ConfigError("d_max must be less than d_min")


@dataclasses.dataclass(frozen=True)
class ORBDescriptorParams:
    """orb_descriptor.hpp:29 parameter parity."""

    tuple_size: int = 2  # WTA_K; only 2 (binary comparisons) supported
    patch_size: int = 31
    num_bits: int = 256
    seed: int = 0x5151

    def validate(self):
        if self.tuple_size != 2:
            raise ConfigError("only tuple_size=2 (WTA_K=2) is supported")
        if self.patch_size <= 2:
            raise ConfigError("patch_size must be > 2")


@functools.lru_cache(maxsize=8)
def _brisk_pattern(params: BRISKParams):
    """(points (P, 2), sigmas (P,), short_pairs (S, 2), long_pairs (L, 2)),
    host numpy, the reference's construction."""
    pts, sigmas = [], []
    for r, n in zip(params.radius_list, params.number_list):
        for k in range(n):
            a = 2 * np.pi * k / n + (0.5 if r > 0 else 0.0)
            pts.append((r * np.cos(a), r * np.sin(a)))
            # smoothing radius grows with ring radius (BRISK sigma ~ 1.3 * r / n)
            sigmas.append(max(0.7, 1.3 * (r * np.sin(np.pi / max(n, 2)))))
    pts = np.asarray(pts, dtype=np.float32)
    sigmas = np.asarray(sigmas, dtype=np.float32)

    P = len(pts)
    ii, jj = np.triu_indices(P, k=1)
    d = np.linalg.norm(pts[ii] - pts[jj], axis=-1)
    short = np.stack([ii[d < params.d_max], jj[d < params.d_max]], axis=-1)
    long = np.stack([ii[d > params.d_min], jj[d > params.d_min]], axis=-1)
    return pts, sigmas, short.astype(np.int32), long.astype(np.int32)


@functools.lru_cache(maxsize=16)
def _pattern_tensors(params: BRISKParams, device: torch.device):
    """The pattern on ``device``, made once per (params, device): copying
    host constants in every call would synchronize the frame step."""
    pts, _, short, long_pairs = _brisk_pattern(params)
    pts_t = torch.as_tensor(pts, device=device)
    short_t = torch.as_tensor(short, dtype=torch.int64, device=device)
    long_t = torch.as_tensor(long_pairs, dtype=torch.int64, device=device)
    dpos = pts_t[long_t[:, 1]] - pts_t[long_t[:, 0]]
    dist2 = torch.sum(dpos * dpos, dim=-1)
    return pts_t, short_t, long_t, dpos, dist2


@functools.lru_cache(maxsize=16)
def _bit_weights(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(
        (1 << np.arange(32)).astype(np.int64), device=device
    )


def _bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                     plane: torch.Tensor | None = None):
    """Bilinear samples of ``img`` (..., H, W) at float coordinates
    (..., N, P) sharing its leading dimensions; coordinates are clamped to
    the image as in the reference. With ``plane`` (..., N), ``img`` is a
    stack (..., L, H, W) and row n samples its plane ``plane[..., n]``."""
    H, W = img.shape[-2:]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    y0 = torch.clamp(y0.to(torch.int64), 0, H - 1)
    x0 = torch.clamp(x0.to(torch.int64), 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    lead = img.shape[:-3] if plane is not None else img.shape[:-2]
    flat = img.reshape(lead + (-1,))
    base = 0 if plane is None else (plane.to(torch.int64) * (H * W))[..., None]

    def at(y, x):
        idx = (base + y * W + x).reshape(lead + (-1,))
        return torch.gather(flat, -1, idx).reshape(ys.shape)

    v00 = at(y0, x0)
    v01 = at(y0, x1)
    v10 = at(y1, x0)
    v11 = at(y1, x1)
    return (
        v00 * (1 - wy) * (1 - wx)
        + v01 * (1 - wy) * wx
        + v10 * wy * (1 - wx)
        + v11 * wy * wx
    )


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., N, B) bool -> (..., N, ceil(B/32)) int32 words holding the
    reference's uint32 bit pattern: bit k of word w is bits[..., 32 w + k]."""
    B = bits.shape[-1]
    pad = (-B) % 32
    if pad:
        bits = torch.cat(
            [bits, torch.zeros(bits.shape[:-1] + (pad,), dtype=bits.dtype,
                               device=bits.device)],
            dim=-1,
        )
        B += pad
    grouped = bits.reshape(bits.shape[:-1] + (B // 32, 32)).to(torch.int64)
    words = (grouped * _bit_weights(bits.device)).sum(-1)  # in [0, 2^32)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32)


def _smoothing_kernel(sigma: float):
    x = np.arange(-2, 3)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _smoothed(image: torch.Tensor, sigma: float = 1.2) -> torch.Tensor:
    """Separable 5-tap Gaussian pre-smoothing with zero padding (the
    reference's SAME convolutions), as shifted sums in f32 over the last two
    dimensions, added as the reference's CPU convolution adds them (its
    bits)."""
    k = [float(v) for v in _smoothing_kernel(sigma)]
    img = image.to(torch.float32)

    def taps(x, dim):
        n = x.shape[dim]
        xp = torch.nn.functional.pad(
            x, (2, 2, 0, 0) if dim == -1 else (0, 0, 2, 2)
        )
        t = [xp.narrow(dim, i, n) * kv for i, kv in enumerate(k)]
        # XLA's CPU convolution adds the five taps in this tree
        return ((t[0] + t[1]) + (t[2] + t[3])) + t[4]

    return taps(taps(img, -2), -1)


def brisk_describe(
    image: torch.Tensor,
    xy: torch.Tensor,
    mask: torch.Tensor,
    params: BRISKParams = BRISKParams(),
):
    """BRISK descriptors for a keypoint bank ``xy`` (..., N, 2), ``mask``
    (..., N) of the image (..., H, W).

    Orientation per keypoint from long-pair gradients (the BRISK rule), then
    short-pair comparisons of rotated-pattern samples -> packed words.

    Returns (desc (..., N, W) int32 holding uint32 bit patterns, mask).
    Masked rows are all-zero words.
    """
    pts, short, long_pairs, dpos, dist2 = _pattern_tensors(params, xy.device)
    img = _smoothed(image)
    px, py = pts[:, 0], pts[:, 1]
    x0 = xy[..., 0:1]
    y0 = xy[..., 1:2]

    # pass 1: unrotated samples -> orientation from long pairs
    vals = _bilinear_sample(img, y0 + py, x0 + px)  # (..., N, P)
    gi = vals[..., long_pairs[:, 0]]
    gj = vals[..., long_pairs[:, 1]]
    # the reference's (gj - gi) * dpos / dist2, summed over the L long pairs
    gx = fixed_order_sum((gj - gi) * dpos[:, 0] / dist2)
    gy = fixed_order_sum((gj - gi) * dpos[:, 1] / dist2)
    angle = torch.atan2(gy, gx)

    # pass 2: rotated samples -> short-pair comparisons; p @ rot.T with
    # rot = [[c, -s], [s, c]], written out per component
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    rx = px * c + py * (-s)
    ry = px * s + py * c
    vals_r = _bilinear_sample(img, y0 + ry, x0 + rx)
    bits = vals_r[..., short[:, 0]] < vals_r[..., short[:, 1]]
    desc = _pack_bits(bits)
    desc = torch.where(mask[..., None], desc, torch.zeros_like(desc))
    return desc, mask


@functools.lru_cache(maxsize=8)
def _brief_pattern(params: ORBDescriptorParams):
    """Seeded random BRIEF pattern: pairs of offsets ~ N(0, (patch/5)^2),
    clipped to the patch (the classic BRIEF G-II construction); the
    reference's numpy draw."""
    rng = np.random.default_rng(params.seed)
    half = params.patch_size // 2
    sigma = params.patch_size / 5.0
    a = np.clip(rng.normal(0, sigma, (params.num_bits, 2)), -half, half)
    b = np.clip(rng.normal(0, sigma, (params.num_bits, 2)), -half, half)
    return a.astype(np.float32), b.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _brief_tensors(params: ORBDescriptorParams, device: torch.device):
    a, b = _brief_pattern(params)
    return (torch.as_tensor(a, device=device),
            torch.as_tensor(b, device=device))


def _brief_bits(img, xy, angle, params, plane=None, inv_scale=None):
    """Rotated-BRIEF comparison bits (..., N, num_bits) of keypoints ``xy``
    at ``angle`` (``inv_scale`` (..., N) maps level-0 coordinates to each
    keypoint's ``plane`` of the stack ``img``)."""
    a, b = _brief_tensors(params, xy.device)
    pt = xy if inv_scale is None else xy * inv_scale[..., None]
    x0 = pt[..., 0:1]
    y0 = pt[..., 1:2]
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]

    def sample(p):
        # p @ rot.T with rot = [[c, -s], [s, c]], written out per component
        rx = p[:, 0] * c + p[:, 1] * (-s)
        ry = p[:, 0] * s + p[:, 1] * c
        return _bilinear_sample(img, y0 + ry, x0 + rx, plane)

    return sample(a) < sample(b)


def orb_describe(
    image: torch.Tensor,
    xy: torch.Tensor,
    angle: torch.Tensor,
    mask: torch.Tensor,
    params: ORBDescriptorParams = ORBDescriptorParams(),
):
    """Rotated-BRIEF (ORB-style) descriptors on the image itself. Returns
    (desc (..., N, W) int32 words, mask)."""
    bits = _brief_bits(_smoothed(image, sigma=2.0), xy, angle, params)
    desc = _pack_bits(bits)
    return torch.where(mask[..., None], desc, torch.zeros_like(desc)), mask


@functools.lru_cache(maxsize=16)
def _inv_scales(scale_factor: float, num_levels: int, device: torch.device):
    return torch.as_tensor(
        np.asarray([scale_factor**-lvl for lvl in range(num_levels)],
                   np.float32), device=device)


def orb_describe_pyramid(
    image: torch.Tensor,
    xy: torch.Tensor,
    angle: torch.Tensor,
    level: torch.Tensor,
    mask: torch.Tensor,
    scale_factor: float,
    num_levels: int,
    params: ORBDescriptorParams = ORBDescriptorParams(),
    levels=None,
):
    """Scale-aware rBRIEF: each keypoint's pattern samples its own pyramid
    level's smoothed pixels (cv::ORB, orb_detector.hpp:29-44). ``xy`` are
    level-0 coordinates and ``level`` the per-keypoint pyramid level, as
    :func:`~libwave_tpu_torch.vision.detector.detect_orb_pyramid` returns
    them. The levels are padded with zeros into one (..., L, H, W) stack and
    sampled with the full level-0 bounds, as in the reference. ``levels``:
    ``build_pyramid(image, ...)``'s output, when the caller has it already.

    Returns (desc (..., N, W) int32 words, mask).
    """
    if levels is None:
        levels = build_pyramid(image, scale_factor, num_levels)
    H, W = levels[0].shape[-2:]
    stack = torch.stack([
        torch.nn.functional.pad(
            _smoothed(img_l, sigma=2.0),
            (0, W - img_l.shape[-1], 0, H - img_l.shape[-2]))
        for img_l in levels
    ], dim=-3)
    lvl = level.to(torch.int64)
    inv = _inv_scales(scale_factor, num_levels, xy.device)[lvl]
    bits = _brief_bits(stack, xy, angle, params, plane=lvl, inv_scale=inv)
    desc = _pack_bits(bits)
    return torch.where(mask[..., None], desc, torch.zeros_like(desc)), mask
