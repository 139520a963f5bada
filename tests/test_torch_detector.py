"""The port's FAST detector (``libwave_tpu_torch.vision.detector``) against
the JAX package's, on the same numpy images.

Tolerance: exact. Scores are f32 sums of the same ring terms in the same
order, the NMS is a max, and the top-N keeps equal scores in ascending
index order in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.vision import detector as jd
from libwave_tpu_torch import bench_frontend, interop
from libwave_tpu_torch.utils.config import ConfigError, validate
from libwave_tpu_torch.vision import detector as td


def blob_image(rng, H=120, W=160, n_blobs=40, seed_shift=(0, 0)):
    """``tests/test_vision.py``'s random Gaussian blob texture."""
    ys = rng.uniform(10, H - 10, n_blobs) + seed_shift[0]
    xs = rng.uniform(10, W - 10, n_blobs) + seed_shift[1]
    amps = rng.uniform(50, 200, n_blobs)
    sig = rng.uniform(1.5, 3.0, n_blobs)
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.zeros((H, W))
    for y, x, a, s in zip(ys, xs, amps, sig):
        img += a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * s * s))
    return img.astype(np.float32)


def _rendered_frame():
    p = bench_frontend.EurocSimParams(
        duration=1.0, nb_landmarks=120, fx=229.0, fy=228.0, cx=188.0,
        cy=120.0, width=376, height_px=240,
    )
    return bench_frontend.make_euroc_frames(p, seed=0)[2].astype(np.float32)


def _tie_image():
    """Flat 4x4 blocks of a few grey levels: equal FAST scores everywhere."""
    rng = np.random.default_rng(5)
    levels = rng.integers(0, 4, (24, 32)) * 60.0
    return np.kron(levels, np.ones((4, 4))).astype(np.float32)


IMAGES = {
    "blobs0": blob_image(np.random.default_rng(0)),
    "blobs0_shifted": blob_image(np.random.default_rng(0), seed_shift=(3, 5)),
    "blobs7": blob_image(np.random.default_rng(7), H=140, W=180, n_blobs=50),
    "rendered_376x240": _rendered_frame(),
    "ties": _tie_image(),
}
PARAMS = [
    jd.FASTParams(threshold=20.0, num_features=512),
    jd.FASTParams(threshold=5.0, num_features=64, type="7_12"),
    jd.FASTParams(threshold=8.0, num_features=200, type="5_8",
                  nonmax_suppression=False),
]
_jax_fast_score = jax.jit(jd.fast_score, static_argnums=1)
_jax_detect = jax.jit(jd.detect_fast, static_argnums=1)


@pytest.mark.parametrize("name", list(IMAGES))
@pytest.mark.parametrize("p", PARAMS, ids=lambda p: f"{p.type}-t{p.threshold:g}")
def test_fast_score_nms_and_detect_exact(name, p):
    img = IMAGES[name]
    tp = interop.params_from_jax(p)
    sj, cj = _jax_fast_score(jnp.asarray(img), p)
    st, ct = td.fast_score(torch.as_tensor(img), tp)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(
        td.nonmax_suppress(st).numpy(), np.asarray(jd.nonmax_suppress(sj))
    )
    ref = _jax_detect(jnp.asarray(img), p)
    got = td.detect_fast(torch.as_tensor(img), tp)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_top_n_cut_inside_a_tie():
    """Cut the keypoint bank inside a run of equal responses: both packages
    keep the same members of the run (ascending flat index)."""
    img = IMAGES["ties"]
    s = td.nonmax_suppress(td.fast_score(torch.as_tensor(img))[0])
    vals = torch.sort(s.reshape(-1), descending=True)[0]
    cuts = [k for k in range(1, len(vals)) if vals[k] > 0 and vals[k - 1] == vals[k]]
    assert len(cuts) > 10  # many ties
    for k in cuts[len(cuts) // 2:len(cuts) // 2 + 2]:
        p = jd.FASTParams(num_features=k)
        ref = _jax_detect(jnp.asarray(img), p)
        got = td.detect_fast(torch.as_tensor(img), interop.params_from_jax(p))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_uint8_frame_detects_like_its_float_cast():
    img = IMAGES["rendered_376x240"]
    a = td.detect_fast(torch.as_tensor(img.astype(np.uint8)))
    b = td.detect_fast(torch.as_tensor(img))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_params_defaults_and_validation():
    for jcls, tcls in ((jd.FASTParams, td.FASTParams),
                       (jd.ORBDetectorParams, td.ORBDetectorParams)):
        assert dataclasses.asdict(jcls()) == dataclasses.asdict(tcls())
    for bad in (td.FASTParams(threshold=0), td.FASTParams(type="9_17"),
                td.FASTParams(num_features=0), td.ORBDetectorParams(num_levels=0)):
        with pytest.raises(ConfigError):
            validate(bad)
