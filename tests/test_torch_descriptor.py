"""The port's BRISK descriptor (``libwave_tpu_torch.vision.descriptor``)
against the JAX package's, on the same numpy images and keypoints.

Tolerances: the pattern arrays and the bit packing are exact (bit 31
included); the bilinear samples and the pre-smoothing within 1e-6 relative
to the image's largest value (the same f32 terms, summed in another order);
the descriptors agree on at least 99% of (keypoint, bit) pairs, because the
summation order of the smoothing and of the orientation gradient, and ulps
of atan2/cos, flip comparisons of near-equal smoothed samples.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.vision import descriptor as js
from libwave_tpu.vision import detector as jd
from libwave_tpu_torch import interop
from libwave_tpu_torch.utils.config import ConfigError, validate
from libwave_tpu_torch.vision import descriptor as ts
from test_torch_detector import IMAGES


def test_pattern_arrays_equal():
    for p in (js.BRISKParams(), js.BRISKParams(d_max=4.0, d_min=9.0)):
        for a, b in zip(js._brisk_pattern(p),
                        ts._brisk_pattern(interop.params_from_jax(p))):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    _, _, short, long_pairs = ts._brisk_pattern(ts.BRISKParams())
    assert (len(short), len(long_pairs)) == (512, 870)  # W = 16 words


@pytest.mark.parametrize("name", ["blobs0", "rendered_376x240"])
def test_smoothed_and_bilinear_within_rtol(name):
    img = IMAGES[name]
    sj = np.asarray(js._smoothed(jnp.asarray(img)))
    st = ts._smoothed(torch.as_tensor(img)).numpy()
    np.testing.assert_allclose(st, sj, rtol=1e-6, atol=1e-6 * np.abs(sj).max())
    rng = np.random.default_rng(1)
    H, W = img.shape
    ys = rng.uniform(-3, H + 3, 500).astype(np.float32)
    xs = rng.uniform(-3, W + 3, 500).astype(np.float32)
    bj = np.asarray(js._bilinear_sample(jnp.asarray(sj), jnp.asarray(ys),
                                        jnp.asarray(xs)))
    bt = ts._bilinear_sample(torch.from_numpy(sj.copy()), torch.as_tensor(ys),
                             torch.as_tensor(xs)).numpy()
    np.testing.assert_allclose(bt, bj, rtol=1e-6, atol=1e-6 * np.abs(sj).max())


def test_pack_bits_exact_with_bit_31():
    rng = np.random.default_rng(2)
    bits = rng.random((9, 100)) < 0.5
    bits[:, 31] = True  # top bit of word 0
    bits[0, :32] = True  # an all-ones word
    ref = np.asarray(js._pack_bits(jnp.asarray(bits)))
    got = ts._pack_bits(torch.as_tensor(bits))
    assert got.dtype == torch.int32 and got.shape == (9, 4)
    assert (got[:, 0] < 0).all()  # bit 31 is the int32 sign bit
    np.testing.assert_array_equal(interop.desc_to_numpy(got), ref)


@jax.jit
def _jax_detect_describe(img):
    xy, _, m = jd.detect_fast(img, jd.FASTParams(threshold=20.0,
                                                 num_features=128))
    return (xy, m) + js.brisk_describe(img, xy, m)


def test_brisk_describe_bit_agreement():
    """Identical keypoints (the JAX package's) into both describers."""
    shares = []
    for name in ("blobs0", "blobs0_shifted", "blobs7", "rendered_376x240"):
        img = IMAGES[name]
        xy, m, dj, mj = _jax_detect_describe(jnp.asarray(img))
        dt, mt = ts.brisk_describe(torch.as_tensor(img),
                                   torch.from_numpy(np.array(xy)),
                                   torch.from_numpy(np.array(m)))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        keep = np.asarray(m)
        a = np.unpackbits(np.asarray(dj).view(np.uint8), axis=1)[keep]
        b = np.unpackbits(interop.desc_to_numpy(dt).view(np.uint8), axis=1)[keep]
        assert not interop.desc_to_numpy(dt)[~keep].any()  # masked rows zero
        shares.append((a == b).mean())
    print(f"BRISK bit agreement per image: {shares}")
    assert min(shares) >= 0.99, shares


def test_params_defaults_and_validation():
    for jcls, tcls in ((js.BRISKParams, ts.BRISKParams),
                       (js.ORBDescriptorParams, ts.ORBDescriptorParams)):
        assert dataclasses.asdict(jcls()) == dataclasses.asdict(tcls())
    for bad in (ts.BRISKParams(radius_list=(0.0, 1.0), number_list=(1,)),
                ts.BRISKParams(d_max=9.0, d_min=8.0),
                ts.ORBDescriptorParams(tuple_size=3)):
        with pytest.raises(ConfigError):
            validate(bad)
