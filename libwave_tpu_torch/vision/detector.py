"""FAST corner detection (port of ``libwave_tpu.vision.detector``'s FAST part).

Dense, branch-free tensor math over the whole image, as in the reference:
all ring comparisons at every pixel at once, the "n contiguous" test as
log-step shifted ANDs on a doubled ring mask, non-max suppression as a 3x3
max pool, top-N retention as a fixed-capacity keypoint bank with a validity
mask.

Every step gives the reference's bits: the ring sums add the ring terms in
ring order, one elementwise add at a time, so the score does not depend on
how a reduction kernel orders its sums on either device; the top-N selection
is a stable descending sort, so equal scores keep the lower flat index first,
as ``lax.top_k`` does.

The ORB detector (``detect_orb_pyramid``) runs the same FAST segment test on
every level of an image pyramid, ranks by the Harris response, orients by
the intensity centroid and merges the levels by response. The pyramid is
``jax.image.resize``'s antialiased bilinear resampling written out: per axis
a triangle-kernel weight matrix (``compute_weight_mat``: the kernel widened
by the downscale factor, columns normalised by their sums, samples outside
the input zeroed), applied as two f32 contractions with TF32 off.

Every function takes images with leading batch dimensions ``(..., H, W)``
(a stack of sequences' frames) and keypoint banks ``(..., N, 2)``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from libwave_tpu_torch.utils.config import ConfigError
from libwave_tpu_torch.utils.precision import full_f32, per_item

# Bresenham circle of radius 3 (the FAST-16 ring, clockwise from 12 o'clock).
_RING16 = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)
# radius-1.5 ring of 8 for TYPE_5_8 and radius-2 ring of 12 for TYPE_7_12
_RING8 = np.array(
    [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)],
    dtype=np.int32,
)
_RING12 = np.array(
    [
        (-2, 0), (-2, 1), (-1, 2), (0, 2), (1, 2), (2, 1), (2, 0), (2, -1),
        (1, -2), (0, -2), (-1, -2), (-2, -1),
    ],
    dtype=np.int32,
)

_FAST_TYPES = {
    "5_8": (_RING8, 5),
    "7_12": (_RING12, 7),
    "9_16": (_RING16, 9),
}


@dataclasses.dataclass(frozen=True)
class FASTParams:
    """fast_detector.hpp:20 parameter parity (type as a string enum)."""

    threshold: float = 10.0
    nonmax_suppression: bool = True
    type: str = "9_16"
    num_features: int = 1024  # top-N retained (fixed capacity)

    def validate(self):
        if self.threshold <= 0:
            raise ConfigError("threshold must be greater than 0")
        if self.type not in _FAST_TYPES:
            raise ConfigError(f"invalid FAST type {self.type}")
        if self.num_features <= 0:
            raise ConfigError("num_features must be positive (fixed capacity)")


@dataclasses.dataclass(frozen=True)
class ORBDetectorParams:
    """orb_detector.hpp:29 parameter parity (HARRIS_SCORE ranking;
    num_levels/scale_factor drive the image pyramid of
    :func:`detect_orb_pyramid`). ``cross_level_nms`` additionally suppresses
    keypoints that re-detect a strictly stronger response from another level
    at the same level-0 location (off by default, as cv::ORB keeps
    multi-scale duplicates)."""

    num_features: int = 2000
    scale_factor: float = 1.2
    num_levels: int = 8
    edge_threshold: int = 31
    fast_threshold: float = 10.0
    use_harris_score: bool = True
    cross_level_nms: bool = False

    def validate(self):
        if self.num_features < 0:
            raise ConfigError("num_features must be >= 0")
        if self.scale_factor < 1.0:
            raise ConfigError("scale_factor must be >= 1")
        if not 0 < self.num_levels <= 12:
            raise ConfigError("num_levels out of range")
        if self.fast_threshold <= 0:
            raise ConfigError("fast_threshold must be > 0")


def _shifted(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx], wrapping at the edges (the border is
    zeroed by the caller)."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))


def _contiguous_run(mask: torch.Tensor, n: int, ring_size: int) -> torch.Tensor:
    """Whether each pixel's circular ring mask (..., ring) bool has >= n
    contiguous set bits: a doubled ring mask packed into int64, ANDed with
    log-step shifted copies of itself."""
    one = torch.ones((), dtype=torch.int64, device=mask.device)
    weights = one << torch.arange(ring_size, device=mask.device)
    packed = (mask.to(torch.int64) * weights).sum(-1)
    out = packed | (packed << ring_size)
    shift, remaining = 1, n - 1
    while remaining > 0:
        s = min(shift, remaining)
        out = out & (out >> s)
        remaining -= s
        shift *= 2
    return out != 0


def _ring_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum over the last (ring) axis, in ring order."""
    acc = terms[..., 0]
    for i in range(1, terms.shape[-1]):
        acc = acc + terms[..., i]
    return acc


def fast_score(image: torch.Tensor, params: FASTParams = FASTParams()):
    """Dense FAST corner response.

    Returns (score (..., H, W) f32, is_corner (..., H, W) bool). Score is the
    OpenCV-style sum of absolute differences over the qualifying arc (max of
    bright/dark sums), zero where the segment test fails or in the border.
    """
    ring, n = _FAST_TYPES[params.type]
    img = image.to(torch.float32)
    H, W = img.shape[-2:]
    t = float(np.float32(params.threshold))

    ring_vals = torch.stack(
        [_shifted(img, int(dy), int(dx)) for dy, dx in ring], dim=-1
    )  # (..., H, W, R)
    center = img[..., None]
    bright = ring_vals > center + t
    dark = ring_vals < center - t

    is_bright = _contiguous_run(bright, n, len(ring))
    is_dark = _contiguous_run(dark, n, len(ring))
    is_corner = is_bright | is_dark

    diff = ring_vals - center
    zero = torch.zeros((), dtype=torch.float32, device=img.device)
    bright_sum = _ring_sum(torch.where(bright, diff - t, zero))
    dark_sum = _ring_sum(torch.where(dark, -diff - t, zero))
    score = torch.maximum(
        torch.where(is_bright, bright_sum, zero),
        torch.where(is_dark, dark_sum, zero),
    )

    # zero the border (ring reads wrap; border results are invalid)
    r = int(np.max(np.abs(ring)))
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    interior = (yy >= r) & (yy < H - r) & (xx >= r) & (xx < W - r)
    corner = interior & is_corner
    return torch.where(corner, score, zero), corner


def nonmax_suppress(score: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Keep only local maxima of the response in a window x window patch
    (the max pool pads with -inf, as the reference's reduce_window does)."""
    H, W = score.shape[-2:]
    local_max = F.max_pool2d(
        score.reshape(-1, 1, H, W), window, stride=1, padding=window // 2
    ).reshape(score.shape)
    return torch.where(score >= local_max, score, torch.zeros_like(score))


def fixed_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a pairwise tree of elementwise adds (the
    axis zero-padded to a power of two): the same order, so the same bits,
    whatever the leading dimensions, where a reduction kernel may split its
    sums by the tensor's whole shape."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:
        x = F.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def top_k_stable(x: torch.Tensor, k: int):
    """The ``k`` largest entries of the last axis, ties in ascending index
    order (``lax.top_k``'s order; ``torch.topk`` leaves ties unordered on a
    GPU). Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_top_k(score: torch.Tensor, k: int):
    """Flatten -> top-k -> (xy (..., k, 2) f32, response (..., k), mask
    (..., k)).

    xy is (x=col, y=row), the OpenCV KeyPoint.pt convention. Rows past the
    last positive response hold xy = -1 and mask False.
    """
    H, W = score.shape[-2:]
    vals, idx = top_k_stable(score.reshape(score.shape[:-2] + (H * W,)), k)
    ys = torch.div(idx, W, rounding_mode="floor").to(torch.float32)
    xs = (idx % W).to(torch.float32)
    mask = vals > 0
    xy = torch.stack([xs, ys], dim=-1)
    return torch.where(mask[..., None], xy, -1.0), vals, mask


def detect_fast(image: torch.Tensor, params: FASTParams = FASTParams()):
    """Full FAST detection: score -> (optional) NMS -> top-N.

    Returns (xy (..., N, 2), response (..., N), mask (..., N)) with N =
    params.num_features.
    """
    score, _ = fast_score(image, params)
    if params.nonmax_suppression:
        score = nonmax_suppress(score)
    return select_top_k(score, params.num_features)


# ---------------------------------------------------------------------------
# Harris response + ORB-style detector
# ---------------------------------------------------------------------------


def pyramid_shapes(H: int, W: int, scale_factor: float, num_levels: int):
    """Static per-level image shapes (floored at 8 px)."""
    out = []
    for level in range(num_levels):
        s = scale_factor**level
        out.append((max(int(round(H / s)), 8), max(int(round(W / s)), 8)))
    return out


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 weights of ``jax.image.resize``'s antialiased
    bilinear resampling along one axis (``compute_weight_mat`` with the
    triangle kernel, scale ``n_out / n_in``, no translation), computed in
    f64 as the JAX package computes them under x64, then rounded to f32."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    w = np.maximum(0.0, 1.0 - np.abs(x / kernel_scale))
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _resize_weights_on(n_in: int, n_out: int, device: torch.device):
    """:func:`_resize_weights` on ``device``, copied once."""
    return torch.as_tensor(_resize_weights(n_in, n_out), device=device)


def resize_bilinear(img: torch.Tensor, shape) -> torch.Tensor:
    """``jax.image.resize(img, shape, "bilinear")`` of (..., H, W) f32
    images to (..., h, w): the rows, then the columns contracted with their
    weight matrices in full f32. An axis whose size stays is not touched,
    as in the reference. A batch of images goes one image at a time, so
    each image's products are those of the same call alone (a batched GEMM
    may pick another kernel, and another summation order)."""
    H, W = img.shape[-2:]
    h, w = shape
    if img.dim() > 2:
        return per_item(lambda x: resize_bilinear(x, shape),
                        img.reshape(-1, H, W)).reshape(img.shape[:-2] + (h, w))
    with full_f32():
        if h != H:
            wy = _resize_weights_on(H, h, img.device)
            img = torch.matmul(wy.T, img)
        if w != W:
            wx = _resize_weights_on(W, w, img.device)
            img = torch.matmul(img, wx)
    return img


def build_pyramid(image: torch.Tensor, scale_factor: float, num_levels: int):
    """Per-level bilinear rescales of ``image`` (..., H, W) (cv::ORB's image
    pyramid, orb_detector.hpp:36-44); each level resamples the
    full-resolution image."""
    img = image.to(torch.float32)
    H, W = img.shape[-2:]
    shapes = pyramid_shapes(H, W, scale_factor, num_levels)
    return [img if lvl == 0 else resize_bilinear(img, shp)
            for lvl, shp in enumerate(shapes)]


def _level_budgets(num_features: int, scale_factor: float, num_levels: int):
    """cv::ORB's per-level feature budget: geometric decay by 1/scale_factor
    per level, remainder to the coarsest level."""
    factor = 1.0 / scale_factor
    if num_levels == 1:
        return [num_features]
    if factor == 1.0:
        return [max(num_features // num_levels, 1)] * num_levels
    ndesired = num_features * (1 - factor) / (1 - factor**num_levels)
    budgets = []
    acc = 0
    for level in range(num_levels - 1):
        b = max(int(round(ndesired * factor**level)), 1)
        budgets.append(b)
        acc += b
    budgets.append(max(num_features - acc, 1))
    return budgets


_BOX_WEIGHT = float(np.float32(1.0) / np.float32(9.0))


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box mean with zero padding (the reference's SAME convolution),
    as nine shifted products added in row-major order."""
    H, W = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = xp[..., dy:dy + H, dx:dx + W] * _BOX_WEIGHT
            acc = term if acc is None else acc + term
    return acc


def harris_score(image: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """Harris corner response det(M) - k tr(M)^2 with 3x3 aggregation."""
    img = image.to(torch.float32)
    dx = (torch.roll(img, -1, dims=-1) - torch.roll(img, 1, dims=-1)) * 0.5
    dy = (torch.roll(img, -1, dims=-2) - torch.roll(img, 1, dims=-2)) * 0.5
    Ixx, Iyy, Ixy = _box3(dx * dx), _box3(dy * dy), _box3(dx * dy)
    det = Ixx * Iyy - Ixy * Ixy
    tr = Ixx + Iyy
    return det - k * tr * tr


@functools.lru_cache(maxsize=16)
def _circle_offsets(radius: int, device: torch.device):
    """(dy, dx) f32 offsets of the circular patch, and the same as int64."""
    dy, dx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    circle = (dy * dy + dx * dx) <= radius * radius
    offs = np.stack([dy[circle], dx[circle]], axis=-1)
    return (torch.as_tensor(offs.astype(np.float32), device=device),
            torch.as_tensor(offs.astype(np.int64), device=device))


def _gather_pixels(img: torch.Tensor, y: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """``img[..., y, x]`` for images (..., H, W) and in-range integer
    coordinates (..., *) sharing the leading dimensions."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    flat = img.reshape(lead + (H * W,))
    idx = (y * W + x).reshape(lead + (-1,))
    return torch.gather(flat, -1, idx).reshape(y.shape)


def orb_orientation(image: torch.Tensor, xy: torch.Tensor, radius: int = 15):
    """Intensity-centroid orientation per keypoint (the ORB "oFAST" angle):
    theta = atan2(m01, m10) over a circular patch. ``xy`` (..., N, 2)."""
    img = image.to(torch.float32)
    H, W = img.shape[-2:]
    offs_f, offs_i = _circle_offsets(radius, xy.device)
    y = torch.clamp(xy[..., 1:2].to(torch.int32).to(torch.int64)
                    + offs_i[:, 0], 0, H - 1)  # (..., N, P)
    x = torch.clamp(xy[..., 0:1].to(torch.int32).to(torch.int64)
                    + offs_i[:, 1], 0, W - 1)
    vals = _gather_pixels(img, y, x)
    m01 = fixed_order_sum(vals * offs_f[:, 0])
    m10 = fixed_order_sum(vals * offs_f[:, 1])
    return torch.atan2(m01, m10)


def _detect_orb_level(image: torch.Tensor, params: ORBDetectorParams,
                      budget: int):
    """One pyramid level: FAST segment test gated, Harris ranked, NMS,
    edge-threshold border, top-``budget``, oriented."""
    fast_p = FASTParams(
        threshold=params.fast_threshold,
        nonmax_suppression=True,
        num_features=budget,
    )
    score, corners = fast_score(image, fast_p)
    zero = torch.zeros((), dtype=torch.float32, device=score.device)
    if params.use_harris_score:
        h = harris_score(image)
        hmin = torch.amin(h, dim=(-2, -1), keepdim=True)
        score = torch.where(corners, h - hmin + 1e-3, zero)
    score = nonmax_suppress(score)
    # suppress near-edge responses (edge_threshold border, orb_detector
    # parity: descriptors need intact patches)
    H, W = image.shape[-2:]
    b = params.edge_threshold
    yy = torch.arange(H, device=score.device)[:, None]
    xx = torch.arange(W, device=score.device)[None, :]
    inside = (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)
    score = torch.where(inside, score, zero)
    xy, resp, mask = select_top_k(score, budget)
    angle = orb_orientation(image, xy)
    return xy, resp, torch.where(mask, angle, zero), mask


def detect_orb_pyramid(image: torch.Tensor,
                       params: ORBDetectorParams = ORBDetectorParams(),
                       levels=None):
    """Full multi-level ORB detection (orb_detector.hpp:29-112 parity:
    num_features across num_levels scales of scale_factor).

    Per level: detect on the pre-scaled image with a geometrically decaying
    feature budget, orient on that level's pixels, then map coordinates back
    to level 0 and merge by response into the fixed num_features capacity
    (equal responses keep the lower bank index first). With
    ``cross_level_nms`` a keypoint is dropped when a strictly stronger
    response from another level sits within its scaled NMS radius.

    ``levels``: ``build_pyramid(image, ...)``'s output, when the caller
    has it already.

    Returns (xy (..., N, 2) level-0 coords, response (..., N), angle
    (..., N), level (..., N) int32, mask (..., N)); N = params.num_features.
    """
    if levels is None:
        levels = build_pyramid(image, params.scale_factor, params.num_levels)
    budgets = _level_budgets(
        params.num_features, params.scale_factor, params.num_levels
    )
    xs, rs, asz, ls, ms = [], [], [], [], []
    for lvl, (img_l, budget) in enumerate(zip(levels, budgets)):
        xy, resp, ang, mask = _detect_orb_level(img_l, params, budget)
        scale = float(np.float32(params.scale_factor**lvl))
        xs.append(torch.where(mask[..., None], xy * scale, -1.0))
        rs.append(resp)
        asz.append(ang)
        ls.append(torch.full(resp.shape, lvl, dtype=torch.int32,
                             device=resp.device))
        ms.append(mask)
    xy = torch.cat(xs, dim=-2)
    resp = torch.cat(rs, dim=-1)
    angle = torch.cat(asz, dim=-1)
    level = torch.cat(ls, dim=-1)
    mask = torch.cat(ms, dim=-1)

    if params.cross_level_nms and params.num_levels > 1:
        # suppress k where a strictly stronger response from another level
        # lies within 2 px * its scale at level 0
        d = xy[..., :, None, :] - xy[..., None, :, :]
        d2 = d[..., 0] ** 2 + d[..., 1] ** 2  # (..., T, T)
        top = torch.maximum(level[..., :, None], level[..., None, :])
        base = torch.tensor(params.scale_factor, dtype=xy.dtype,
                            device=xy.device)
        radius = 2.0 * torch.pow(base, top.to(xy.dtype))
        other_level = level[..., :, None] != level[..., None, :]
        stronger = (resp[..., None, :] > resp[..., :, None]) & mask[..., None, :]
        dominated = torch.any(
            (d2 <= radius * radius) & other_level & stronger, dim=-1
        )
        mask = mask & ~dominated

    # merge: global top num_features by response
    keyed = torch.where(mask, resp, torch.full_like(resp, -float("inf")))
    _, idx = top_k_stable(keyed, params.num_features)
    mask = torch.gather(mask, -1, idx)
    xy = torch.gather(xy, -2, idx[..., None].expand(idx.shape + (2,)))
    zero = torch.zeros((), dtype=resp.dtype, device=resp.device)
    return (
        torch.where(mask[..., None], xy, -1.0),
        torch.where(mask, torch.gather(resp, -1, idx), zero),
        torch.where(mask, torch.gather(angle, -1, idx), zero),
        torch.where(mask, torch.gather(level, -1, idx),
                    torch.zeros_like(level[..., :1])),
        mask,
    )


def detect_orb(image: torch.Tensor,
               params: ORBDetectorParams = ORBDetectorParams()):
    """ORB detection honoring ``num_levels``: the full image pyramid when
    num_levels > 1 (see :func:`detect_orb_pyramid`), single-level otherwise.

    Returns (xy (..., N, 2) level-0 coords, response, angle, mask).
    """
    if params.num_levels > 1:
        xy, resp, angle, _, mask = detect_orb_pyramid(image, params)
        return xy, resp, angle, mask
    return _detect_orb_level(image, params, params.num_features)
