"""Parity of libwave_tpu_torch.matching.pointcloud with libwave_tpu's: the
int32 voxel hash (bit for bit, wrap included), voxel_downsample (the same
masks, means within 1e-12 at f64 and 1 ulp-scale at f32),
synthetic_scan (the same points from the same seed integer, the padded
tail valid as in the JAX package), transform_cloud, and the fixed-order
segment sum against a plain index_add_."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.geometry.se3 import SE3 as JSE3
from libwave_tpu.matching import pointcloud as jpc
from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.matching import pointcloud as tpc


def _cloud(rng, n=1024, dtype=np.float64, scale=20.0, masked=0.1):
    pts = (rng.uniform(-scale, scale, size=(n, 3))).astype(dtype)
    mask = rng.uniform(size=n) > masked
    return pts, mask


@pytest.mark.parametrize("leaf", [0.05, 0.3, 1.2])
def test_voxel_hash_bits(leaf, rng):
    # coordinates up to 5e3 m at 5 cm: the int32 products wrap
    pts = rng.uniform(-5e3, 5e3, size=(1024, 3))
    h_t = tpc._voxel_hash(torch.as_tensor(pts), leaf)
    h_j = np.asarray(jpc._voxel_hash(jnp.asarray(pts), leaf))
    assert h_t.dtype == torch.int32
    np.testing.assert_array_equal(h_t.numpy(), h_j)
    p32 = pts.astype(np.float32)
    np.testing.assert_array_equal(
        tpc._voxel_hash(torch.as_tensor(p32), leaf).numpy(),
        np.asarray(jpc._voxel_hash(jnp.asarray(p32), leaf)))


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12),
                                        (np.float32, 4e-6)])
@pytest.mark.parametrize("leaf", [0.6, 2.4])
def test_voxel_downsample(dtype, atol, leaf, rng):
    pts, mask = _cloud(rng, dtype=dtype)
    out_j = jpc.voxel_downsample(jpc.make_cloud(jnp.asarray(pts),
                                                jnp.asarray(mask)), leaf)
    out_t = tpc.voxel_downsample(tpc.make_cloud(torch.as_tensor(pts),
                                                torch.as_tensor(mask)), leaf)
    np.testing.assert_array_equal(out_t.mask.numpy(), np.asarray(out_j.mask))
    assert 0 < int(out_t.count()) < int(mask.sum())
    np.testing.assert_allclose(out_t.points.numpy(), np.asarray(out_j.points),
                               rtol=0, atol=atol)


def test_voxel_downsample_batched_equals_single(rng):
    clouds = [_cloud(rng, n=512) for _ in range(3)]
    batched = tpc.voxel_downsample(tpc.make_cloud(
        torch.as_tensor(np.stack([c[0] for c in clouds])),
        torch.as_tensor(np.stack([c[1] for c in clouds]))), 1.0)
    for b, (pts, mask) in enumerate(clouds):
        one = tpc.voxel_downsample(tpc.make_cloud(
            torch.as_tensor(pts), torch.as_tensor(mask)), 1.0)
        assert torch.equal(batched.mask[b], one.mask)
        assert torch.equal(batched.points[b], one.points)


def test_sorted_segment_sum_matches_index_add(rng):
    seg = np.sort(rng.integers(0, 40, size=(2, 300)), axis=-1)
    x = rng.normal(size=(2, 300, 4))
    got = tpc.sorted_segment_sum(torch.as_tensor(x), torch.as_tensor(seg), 50)
    for b in range(2):
        ref = torch.zeros(50, 4, dtype=torch.float64).index_add_(
            0, torch.as_tensor(seg[b]), torch.as_tensor(x[b]))
        np.testing.assert_allclose(got[b].numpy(), ref.numpy(), rtol=1e-13,
                                   atol=1e-13)


@pytest.mark.parametrize("n", [1024, 1021])
def test_synthetic_scan_matches_jax_seed(n):
    key = jax.random.key(7)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    j = jpc.synthetic_scan(key, n=n, dtype=jnp.float64)
    t = tpc.synthetic_scan(seed, n=n, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(t.points.numpy(), np.asarray(j.points))
    # n % 8 != 0: the zero padding stays valid, as in the JAX package
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert bool(t.mask.all())
    t32 = tpc.synthetic_scan(seed, n=n, device="cpu")
    assert t32.points.dtype == torch.float32
    np.testing.assert_array_equal(
        t32.points.numpy(),
        np.asarray(jpc.synthetic_scan(key, n=n).points))


def test_transform_cloud_batched(rng):
    pts = rng.normal(size=(2, 64, 3))
    q = rng.normal(size=(2, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(size=(2, 3))
    out = tpc.transform_cloud(SE3(q=torch.as_tensor(q), t=torch.as_tensor(t)),
                              tpc.make_cloud(torch.as_tensor(pts)))
    for b in range(2):
        ref = jpc.transform_cloud(JSE3(q=jnp.asarray(q[b]),
                                       t=jnp.asarray(t[b])),
                                  jpc.make_cloud(jnp.asarray(pts[b])))
        np.testing.assert_allclose(out.points[b].numpy(),
                                   np.asarray(ref.points), atol=1e-12)


def test_make_cloud_places_numpy_on_the_asked_device(rng):
    pts, _ = _cloud(rng, n=8)
    c = tpc.make_cloud(pts, device="cpu")
    assert c.points.device.type == "cpu" and c.mask.dtype == torch.bool
    assert int(c.count()) == 8 and c.capacity == 8


def test_interop_cloud_and_se3(rng):
    from libwave_tpu_torch import interop

    pts, mask = _cloud(rng, n=64)
    jc = jpc.make_cloud(jnp.asarray(np.stack([pts, pts])),
                        jnp.asarray(np.stack([mask, mask])))
    c = interop.point_cloud_from_numpy(jax.tree.map(np.asarray, jc),
                                       device="cpu", dtype=torch.float32)
    assert c.points.shape == (2, 64, 3) and c.points.dtype == torch.float32
    assert c.mask.dtype == torch.bool
    np.testing.assert_array_equal(c.mask.numpy(), np.stack([mask, mask]))
    T = JSE3(q=jnp.asarray([1.0, 0.0, 0.0, 0.0]), t=jnp.asarray(pts[0]))
    Tt = interop.se3_from_numpy(jax.tree.map(np.asarray, T), device="cpu")
    assert isinstance(Tt, SE3)
    np.testing.assert_array_equal(Tt.t.numpy(), pts[0])
