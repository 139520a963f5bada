"""The port's ORB front end (``libwave_tpu_torch.vision.detector``'s pyramid
detector, ``vision.descriptor``'s rBRIEF, ``FrontendParams(method="orb")``)
against the JAX package's, on the same numpy frames.

Tolerances, and why:

- ``build_pyramid`` within 1e-4 of 255: ``jax.image.resize``'s weights are
  rebuilt in numpy, and the two packages contract in another order;
- ``harris_score`` within 1e-5 of its largest magnitude: the 3x3 box sums
  round in another order than XLA's convolution, and det - k tr^2 cancels,
  so an elementwise rtol has no meaning near its zeros;
- ``orb_orientation`` within 1e-4 rad;
- keypoints ((x, y, level) at level 0) by set overlap >= 99%: FAST's
  threshold and the Harris ranking turn ulps into other keypoints;
- descriptors of the same keypoints at the same angles: >= 99% of the bits
  (measured 99.76-100%). Not bit for bit: the resampled levels differ by
  ulps, and a comparison of two samples of a flat region flips on them;
  ``cos``/``sin`` differ by ulps between XLA and PyTorch; and the JAX
  package's jit-compiled program sums the smoothing in another order than
  its eager call, whose 5-tap order the port reproduces (at level 0, 97.6%
  of the rows equal its eager call's, 69% its compiled one's). The BRIEF
  pattern is equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.pipelines import visual_frontend as jf
from libwave_tpu.vision import descriptor as js
from libwave_tpu.vision import detector as jd
from libwave_tpu_torch import bench_frontend, interop
from libwave_tpu_torch.pipelines import visual_frontend as tf
from libwave_tpu_torch.utils.config import ConfigError, validate
from libwave_tpu_torch.vision import descriptor as ts
from libwave_tpu_torch.vision import detector as td
from test_torch_detector import IMAGES
from test_torch_windowed_vio import one_torch_thread  # noqa: F401

SMALL = bench_frontend.EurocSimParams(
    duration=2.0, cam_hz=5.0, nb_landmarks=120, fx=229.0, fy=228.0,
    cx=188.0, cy=120.0, width=376, height_px=240)


@pytest.fixture(scope="module")
def frames():
    """Rendered 376x240 frames, and two 752x480 EuRoC-resolution ones."""
    small = bench_frontend.make_euroc_frames(SMALL, seed=0)
    big = bench_frontend.make_euroc_frames(
        bench_frontend.EurocSimParams(duration=0.6, cam_hz=5.0,
                                      nb_landmarks=400), seed=0)
    return {"rendered_376x240": small[2].astype(np.float32),
            "rendered_752x480": big[2].astype(np.float32),
            "blobs7": IMAGES["blobs7"], "stack": small}


_jax_detect = jax.jit(jd.detect_orb_pyramid, static_argnums=1)
_jax_describe = jax.jit(js.orb_describe_pyramid, static_argnums=(5, 6, 7))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", ["rendered_376x240", "rendered_752x480",
                                  "blobs7"])
def test_pyramid_harris_and_orientation(frames, name):
    img = frames[name]
    lj = jd.build_pyramid(jnp.asarray(img), 1.2, 8)
    lt = td.build_pyramid(torch.from_numpy(img), 1.2, 8)
    assert [tuple(x.shape) for x in lt] == [x.shape for x in lj]
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4 * 255)
        hj = np.asarray(jd.harris_score(a))
        ht = td.harris_score(torch.from_numpy(np.asarray(a))).numpy()
        np.testing.assert_allclose(ht, hj, rtol=0,
                                   atol=1e-5 * np.abs(hj).max())
    rng = np.random.default_rng(1)
    for a in (lj[0], lj[3]):
        H, W = a.shape
        xy = np.stack([rng.uniform(-3, W + 3, 200),
                       rng.uniform(-3, H + 3, 200)], -1).astype(np.float32)
        oj = np.asarray(jd.orb_orientation(a, jnp.asarray(xy)))
        ot = td.orb_orientation(_t(a), torch.from_numpy(xy)).numpy()
        np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-4)


def test_resize_matches_jax_without_x64(frames):
    """The JAX package at its default f32 (x64 off) computes the weights in
    f32: the same tolerance holds."""
    img = frames["rendered_752x480"]
    with jax.enable_x64(False):
        ref = np.asarray(jax.image.resize(jnp.asarray(img), (333, 522),
                                          method="bilinear"))
    got = td.resize_bilinear(torch.from_numpy(img), (333, 522)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * 255)


def _keyset(xy, level, mask):
    return {(float(x), float(y), int(lv))
            for (x, y), lv, m in zip(np.asarray(xy), np.asarray(level),
                                     np.asarray(mask)) if m}


@pytest.mark.parametrize("name", ["rendered_376x240", "rendered_752x480",
                                  "blobs7"])
def test_keypoints_and_descriptors(frames, name):
    img = frames[name]
    jp = jd.ORBDetectorParams(num_features=512)
    xj, rj, aj, levj, mj = (np.array(x) for x in
                            _jax_detect(jnp.asarray(img), jp))
    xt, rt, at, levt, mt = td.detect_orb_pyramid(
        torch.from_numpy(img), interop.params_from_jax(jp))
    sj, st = _keyset(xj, levj, mj), _keyset(xt, levt, mt)
    assert len(sj) >= 40
    assert len(sj & st) >= 0.99 * len(sj), (len(sj), len(st), len(sj & st))
    angle_j = {k: a for k, a in zip(
        [(float(x), float(y), int(lv)) for (x, y), lv in zip(xj, levj)], aj)}
    for (x, y), lv, a, m in zip(xt.numpy(), levt.numpy(), at.numpy(),
                                mt.numpy()):
        key = (float(x), float(y), int(lv))
        if m and key in sj:
            assert abs(a - angle_j[key]) <= 1e-4, key

    # the same keypoints and angles (the JAX package's) into both describers
    dj, _ = _jax_describe(jnp.asarray(img), xj, aj, levj, mj, 1.2, 8,
                          js.ORBDescriptorParams())
    dt, m2 = ts.orb_describe_pyramid(torch.from_numpy(img), _t(xj), _t(aj),
                                     _t(levj), _t(mj), 1.2, 8)
    assert dt.shape == (512, 8) and dt.dtype == torch.int32
    np.testing.assert_array_equal(m2.numpy(), mj)
    a = np.unpackbits(np.asarray(dj).view(np.uint8), axis=1)[mj]
    b = np.unpackbits(interop.desc_to_numpy(dt).view(np.uint8), axis=1)[mj]
    assert not interop.desc_to_numpy(dt)[~mj].any()  # masked rows zero
    level0 = levj[mj] == 0
    print(f"{name}: {len(sj)} keypoints, {len(sj & st)} shared, rBRIEF bits "
          f"equal {(a == b).mean():.5f}, level-0 rows equal "
          f"{(a == b)[level0].all(1).mean():.4f}")
    d1j, _ = js.orb_describe(jnp.asarray(img), xj, aj, mj)
    d1t, _ = ts.orb_describe(torch.from_numpy(img), _t(xj), _t(aj), _t(mj))
    a1 = np.unpackbits(np.asarray(d1j).view(np.uint8), axis=1)[mj]
    b1 = np.unpackbits(interop.desc_to_numpy(d1t).view(np.uint8), axis=1)[mj]
    print(f"single-image rBRIEF: bits equal {(a1 == b1).mean():.5f}, rows "
          f"{(a1 == b1).all(1).mean():.4f}")
    assert (a == b).mean() >= 0.99


@pytest.mark.parametrize("cross", [False, True])
def test_single_level_and_cross_level_nms(frames, cross):
    img = frames["rendered_376x240"]
    for jp in (jd.ORBDetectorParams(num_features=300, num_levels=1),
               jd.ORBDetectorParams(num_features=300, num_levels=4,
                                    cross_level_nms=cross)):
        xj, _, aj, mj = (np.array(x) for x in
                         jax.jit(jd.detect_orb, static_argnums=1)(
                             jnp.asarray(img), jp))
        xt, _, at, mt = td.detect_orb(torch.from_numpy(img),
                                      interop.params_from_jax(jp))
        sj = {tuple(p) for p, m in zip(xj, mj) if m}
        st = {tuple(p) for p, m in zip(xt.numpy(), mt.numpy()) if m}
        assert len(sj) > 10 and len(sj & st) >= 0.99 * len(sj)


def test_pattern_budgets_shapes_and_params():
    p = js.ORBDescriptorParams()
    for a, b in zip(js._brief_pattern(p), ts._brief_pattern(
            interop.params_from_jax(p))):
        np.testing.assert_array_equal(a, b)
    assert td._level_budgets(512, 1.2, 8) == jd._level_budgets(512, 1.2, 8)
    assert td._level_budgets(7, 1.0, 3) == jd._level_budgets(7, 1.0, 3)
    assert td.pyramid_shapes(480, 752, 1.2, 12) == jd.pyramid_shapes(
        480, 752, 1.2, 12)
    assert dataclasses.asdict(jd.ORBDetectorParams()) == dataclasses.asdict(
        td.ORBDetectorParams())
    for bad in (td.ORBDetectorParams(scale_factor=0.9),
                td.ORBDetectorParams(num_levels=13),
                td.ORBDetectorParams(fast_threshold=0.0)):
        with pytest.raises(ConfigError):
            validate(bad)
    orb = tf.FrontendParams(method="orb")
    assert tf._desc_words(orb) == jf._desc_words(jf.FrontendParams(
        method="orb")) == 8


def test_orb_front_end_bank_and_tracks(frames):
    """``detect_and_describe`` with ``method="orb"`` against the JAX
    package's on one frame (keypoints by overlap, descriptors of the shared
    level-0 keypoints), a batch of two frames equal to each alone, and
    ``track_sequence`` over 10 frames with the JAX ORB test's bounds
    (``tests/test_pixels_to_trajectory.py``: >= 40 ids, mean length >= 2)."""
    stack = frames["stack"]
    orb = tf.FrontendParams(method="orb")
    xj, dj, mj = (np.array(x) for x in jax.jit(
        jf.detect_and_describe, static_argnums=1)(
            jnp.asarray(stack[2]), jf.FrontendParams(method="orb")))
    xt, dt, mt = tf.detect_and_describe(torch.from_numpy(stack[2]), orb)
    rows_j = {tuple(p): d for p, d, m in zip(xj, dj, mj) if m}
    rows_t = {tuple(p): d for p, d, m in zip(
        xt.numpy(), interop.desc_to_numpy(dt), mt.numpy()) if m}
    shared = sorted(set(rows_j) & set(rows_t))
    assert len(shared) >= 0.99 * len(rows_j)
    bits = [np.unpackbits(np.stack([r[k] for k in shared]).view(np.uint8),
                          axis=1) for r in (rows_j, rows_t)]
    assert (bits[0] == bits[1]).mean() >= 0.99
    batch = tf.detect_and_describe(torch.from_numpy(stack[2:4]), orb)
    for b in range(2):
        one = tf.detect_and_describe(torch.from_numpy(stack[2 + b]), orb)
        for x, y in zip(batch, one):
            assert torch.equal(x[b], y)

    tracks = tf.track_sequence(stack[:10], params=orb,
                               generator=torch.Generator().manual_seed(0),
                               device="cpu")
    ids = np.unique(tracks[:, 1])
    lengths = np.bincount(tracks[:, 1].astype(int))
    lengths = lengths[lengths > 0]
    print(f"ORB tracks over 10 frames: {len(tracks)} rows, {len(ids)} ids, "
          f"mean length {lengths.mean():.3f}")
    assert len(ids) >= 40, len(ids)
    assert lengths.mean() >= 2.0, lengths.mean()
