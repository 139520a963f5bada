"""Parity of libwave_tpu_torch.matching.ground_segmentation with
libwave_tpu's, on the JAX package test's labelled scene at its bins
(24 x 40, rmax 60 m).

The port takes the model mask as a select, which is what the JAX package
computes inside its compiled INSAC loop and under ``jax.jit``; called
without ``jit``, the JAX package's final GP prediction multiplies empty
bins' ``inf`` heights by 0 and every such sector's prediction turns NaN,
which relabels some drivable points as obstacles (ROADMAP.md §C). So the
reference here is ``jax.jit(segment_ground)``: equal labels at f64 and at
f32 (measured: 0 of 14,600 differ at either), and the eager call's
difference is pinned as found.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu import matching as jm
from libwave_tpu_torch import bench_lidar
from libwave_tpu_torch import matching as tm
from libwave_tpu_torch.utils.config import ConfigError, validate
from test_ground_segmentation import scene

BINS = dict(rmax=60.0, num_bins_a=24, num_bins_l=40)


def _labels_both(pts, params, dtype):
    jfn = jax.jit(lambda c: jm.segment_ground(
        c, jm.GroundSegmentationParams(**params)))
    rj = jfn(jm.make_cloud(jnp.asarray(pts.astype(dtype))))
    rt = tm.segment_ground(tm.make_cloud(torch.as_tensor(pts.astype(dtype))),
                           tm.GroundSegmentationParams(**params))
    return rj, rt


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_labels_equal_jit(dtype, rng):
    pts, true = scene(rng)
    rj, rt = _labels_both(np.array(pts), BINS, dtype)
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert rt.labels.dtype == torch.int32
    s = bench_lidar.ground_scores(rt.labels.numpy(), true)
    assert s["ground_recall"] > 0.85 and s["ground_precision"] > 0.9


def test_eager_reference_differs_only_where_nan(rng):
    pts, _ = scene(rng)
    pts = np.array(pts)
    eager = np.asarray(jm.segment_ground(
        jm.make_cloud(jnp.asarray(pts)),
        jm.GroundSegmentationParams(**BINS)).labels)
    port = tm.segment_ground(tm.make_cloud(torch.as_tensor(pts)),
                             tm.GroundSegmentationParams(**BINS)).labels
    diff = eager != port.numpy()
    # the eager call's NaN prediction turns points the port (and jit) call
    # drivable into obstacles, and nothing else
    assert diff.sum() == 32
    assert (eager[diff] == tm.OBSTACLE).all()
    assert (port.numpy()[diff] == tm.DRIVABLE).all()


def test_batched_clouds_equal_one_at_a_time(rng):
    clouds = [np.array(scene(rng, 3000, 600, 150)[0]) for _ in range(2)]
    p = tm.GroundSegmentationParams(**BINS)
    batched = tm.segment_ground(
        tm.make_cloud(torch.as_tensor(np.stack(clouds))), p)
    for k, c in enumerate(clouds):
        one = tm.segment_ground(tm.make_cloud(torch.as_tensor(c)), p)
        assert torch.equal(batched.labels[k], one.labels)


def test_masked_points_unlabeled_and_params(rng):
    pts, _ = scene(rng, 2000, 400, 80)
    pts = np.array(pts)
    mask = np.ones(len(pts), bool)
    mask[::7] = False
    rt = tm.segment_ground(tm.make_cloud(torch.as_tensor(pts),
                                         torch.as_tensor(mask)),
                           tm.GroundSegmentationParams(**BINS))
    rj = jax.jit(lambda c: jm.segment_ground(
        c, jm.GroundSegmentationParams(**BINS)))(
        jm.make_cloud(jnp.asarray(pts), jnp.asarray(mask)))
    np.testing.assert_array_equal(rt.labels.numpy(), np.asarray(rj.labels))
    assert (rt.labels.numpy()[~mask] == tm.UNLABELED).all()
    with pytest.raises(ConfigError):
        validate(tm.GroundSegmentationParams(num_bins_a=0))
    with pytest.raises(ConfigError):
        validate(tm.GroundSegmentationParams(rmax=-1))
    assert tm.GroundSegmentationParams() == tm.GroundSegmentationParams(**{
        f: getattr(jm.GroundSegmentationParams(), f)
        for f in jm.GroundSegmentationParams.__dataclass_fields__})
