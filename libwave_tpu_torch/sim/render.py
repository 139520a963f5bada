"""Synthetic image rendering for front-end-in-the-loop tests.

The reference never closes the pixels->solver loop in simulation: its
synthetic datasets export *feature tracks* (VoDataset observations,
wave_vision/src/dataset/VoDataset.cpp:213), so the detector/descriptor/
matcher are only ever tested on real photos while the optimizer is only
ever fed simulator output. This module renders actual images from the
simulator's landmark projections so the full pipeline — FAST -> BRISK ->
match -> track -> triangulate -> BA/VIO — runs from pixels with known
ground truth behind them.

Each landmark gets a unique high-contrast texture patch (seeded by its id)
with a uniformly bright 3x3 core: every ring pixel of the FAST 9-16 circle
sits below the core intensity, so the detector fires exactly at the patch
center, while the surrounding random texture makes the BRISK descriptor
distinctive. Patches are pasted axis-aligned at the rounded true projection
over a smooth (texture-free) background, so detection error — not renderer
geometry — is the only measurement noise.
"""

from __future__ import annotations

import numpy as np


def _box_blur(tex: np.ndarray, passes: int = 2) -> np.ndarray:
    """Separable 3x3 box blur (edge-replicated), applied ``passes`` times —
    kills high-frequency corners while keeping per-landmark variation."""
    out = tex.astype(np.float64)
    for _ in range(passes):
        p = np.pad(out, ((0, 0), (1, 1), (1, 1)), mode="edge")
        out = (
            p[:, :-2, 1:-1] + p[:, 1:-1, 1:-1] + p[:, 2:, 1:-1]
        ) / 3.0
        p = np.pad(out, ((0, 0), (1, 1), (1, 1)), mode="edge")
        out = (
            p[:, 1:-1, :-2] + p[:, 1:-1, 1:-1] + p[:, 1:-1, 2:]
        ) / 3.0
    return out


def landmark_textures(num_landmarks: int, patch: int = 15,
                      seed: int = 7) -> np.ndarray:
    """(M, patch, patch) uint8 unique textures with a bright FAST core.

    The random texture is low-pass filtered before the 255 core is stamped:
    sharp texture interiors would create extra FAST corners at constant
    pixel offsets from the patch center — pseudo-landmarks whose constant
    image-space bias is inconsistent with any single 3D point and poisons
    the downstream solve. Blurred texture keeps the BRISK descriptor
    distinctive (its pairs compare smoothed samples anyway) while the core
    stays the only detector response.
    """
    if patch % 2 == 0 or patch < 9:
        raise ValueError("patch must be odd and >= 9")
    rng = np.random.default_rng(seed)
    # low-amplitude texture around the background level: local contrast in
    # any FAST ring stays below the detector threshold, so the 255 core is
    # the only response, while the BRISK pair comparisons (exact
    # inequalities on smoothed samples) still see a unique signature
    tex = rng.integers(98, 133, size=(num_landmarks, patch, patch))
    tex = _box_blur(tex, passes=1)
    c = patch // 2
    tex[:, c - 1 : c + 2, c - 1 : c + 2] = 255.0
    return np.clip(np.round(tex), 0, 255).astype(np.uint8)


def _background(height: int, width: int) -> np.ndarray:
    """Gentle vertical gradient at the texture's mean level — featureless,
    and close enough to the patch intensities that the alpha-blend ring
    stays below the FAST threshold too."""
    col = np.linspace(105.0, 125.0, height)[:, None]
    return np.broadcast_to(col, (height, width)).astype(np.uint8).copy()


def _edge_alpha(patch: int) -> np.ndarray:
    """Radial cosine falloff: 1 inside, ->0 at the patch border, so pasted
    patches blend into the background with no sharp square boundary (whose
    four corners would otherwise be spurious FAST responses at constant
    offsets from the landmark center)."""
    c = patch // 2
    yy, xx = np.mgrid[0:patch, 0:patch]
    rad = np.sqrt((yy - c) ** 2 + (xx - c) ** 2)
    r_in, r_out = c - 3.0, float(c)
    t = np.clip((rad - r_in) / max(r_out - r_in, 1e-9), 0.0, 1.0)
    return 0.5 * (1.0 + np.cos(np.pi * t))


def render_frame(uv: np.ndarray, vis: np.ndarray, textures: np.ndarray,
                 width: int, height: int,
                 background: np.ndarray | None = None) -> np.ndarray:
    """Render one (H, W) uint8 frame.

    uv: (M, 2) pixel projections; vis: (M,) visibility; textures from
    :func:`landmark_textures`. Patches alpha-blend into the background
    (radial falloff) and overlapping patches paint in id order (later ids
    win) — occlusion-like confusion the matcher must survive.
    """
    img = (_background(height, width) if background is None
           else background).astype(np.float64)
    patch = textures.shape[1]
    r = patch // 2
    alpha = _edge_alpha(patch)
    for j in np.nonzero(np.asarray(vis))[0]:
        u = int(round(float(uv[j, 0])))
        v = int(round(float(uv[j, 1])))
        y0, y1 = v - r, v + r + 1
        x0, x1 = u - r, u + r + 1
        ty0, tx0 = max(0, -y0), max(0, -x0)
        y0, x0 = max(0, y0), max(0, x0)
        y1, x1 = min(height, y1), min(width, x1)
        if y1 <= y0 or x1 <= x0:
            continue
        a = alpha[ty0 : ty0 + (y1 - y0), tx0 : tx0 + (x1 - x0)]
        t = textures[j][ty0 : ty0 + (y1 - y0), tx0 : tx0 + (x1 - x0)]
        img[y0:y1, x0:x1] = a * t + (1.0 - a) * img[y0:y1, x0:x1]
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def render_sequence(uv: np.ndarray, vis: np.ndarray, textures: np.ndarray,
                    width: int, height: int) -> np.ndarray:
    """(T, M, 2) projections + (T, M) visibility -> (T, H, W) uint8 stack."""
    bg = _background(height, width)
    return np.stack(
        [
            render_frame(uv[t], vis[t], textures, width, height, bg)
            for t in range(uv.shape[0])
        ]
    )
