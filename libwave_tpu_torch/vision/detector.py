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
as ``lax.top_k`` does. The ORB pyramid (``ORBDetectorParams`` only) is not
ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from libwave_tpu_torch.utils.config import ConfigError

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
    """orb_detector.hpp:29 parameter parity. Only the parameters are ported:
    the ORB pyramid detector itself is not yet (see ROADMAP.md)."""

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
    return torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))


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

    Returns (score (H, W) f32, is_corner (H, W) bool). Score is the
    OpenCV-style sum of absolute differences over the qualifying arc (max of
    bright/dark sums), zero where the segment test fails or in the border.
    """
    ring, n = _FAST_TYPES[params.type]
    img = image.to(torch.float32)
    H, W = img.shape
    t = float(np.float32(params.threshold))

    ring_vals = torch.stack(
        [_shifted(img, int(dy), int(dx)) for dy, dx in ring], dim=-1
    )  # (H, W, R)
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
    local_max = F.max_pool2d(
        score[None, None], window, stride=1, padding=window // 2
    )[0, 0]
    return torch.where(score >= local_max, score, torch.zeros_like(score))


def top_k_stable(x: torch.Tensor, k: int):
    """The ``k`` largest entries of the last axis, ties in ascending index
    order (``lax.top_k``'s order; ``torch.topk`` leaves ties unordered on a
    GPU). Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_top_k(score: torch.Tensor, k: int):
    """Flatten -> top-k -> (xy (k, 2) f32, response (k,), mask (k,)).

    xy is (x=col, y=row), the OpenCV KeyPoint.pt convention. Rows past the
    last positive response hold xy = -1 and mask False.
    """
    H, W = score.shape
    vals, idx = top_k_stable(score.reshape(-1), k)
    ys = torch.div(idx, W, rounding_mode="floor").to(torch.float32)
    xs = (idx % W).to(torch.float32)
    mask = vals > 0
    xy = torch.stack([xs, ys], dim=-1)
    return torch.where(mask[:, None], xy, -1.0), vals, mask


def detect_fast(image: torch.Tensor, params: FASTParams = FASTParams()):
    """Full FAST detection: score -> (optional) NMS -> top-N.

    Returns (xy (N, 2), response (N,), mask (N,)) with N =
    params.num_features.
    """
    score, _ = fast_score(image, params)
    if params.nonmax_suppression:
        score = nonmax_suppress(score)
    return select_top_k(score, params.num_features)
