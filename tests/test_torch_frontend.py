"""The port's whole visual front end (``libwave_tpu_torch.pipelines.
visual_frontend``) against the JAX package's, and the port's JAX-free frame
generator against the JAX package's rendered PNGs.

``track_sequence`` with RANSAC on is held to the bounds the JAX package holds
its own two execution modes to (``tests/test_pixels_to_trajectory.py:82-90``):
RANSAC samples differ (``torch.Generator`` vs ``jax.random``) and thresholds
turn ulp differences into discrete match flips, so the contract is
statistical: track rows and ids within 10%, mean track length within 0.5,
measurement-set overlap > 0.9. The frames are compared bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from libwave_tpu.datasets.euroc import load_euroc_camera_index
from libwave_tpu.pipelines import visual_frontend as jf
from libwave_tpu.sim import EurocSimParams, generate_euroc_sequence
from libwave_tpu.vision.images import read_image_sequence
from libwave_tpu_torch import bench_frontend, interop
from libwave_tpu_torch.pipelines import visual_frontend as tf
from test_torch_windowed_vio import one_torch_thread  # noqa: F401

SMALL = dict(nb_landmarks=120, fx=229.0, fy=228.0, cx=188.0, cy=120.0,
             width=376, height_px=240)


def _stats(t):
    lengths = np.bincount(t[:, 1].astype(int))
    return len(t), len(np.unique(t[:, 1])), lengths[lengths > 0].mean()


def test_frames_bit_identical_to_rendered_pngs(tmp_path):
    sim = EurocSimParams(duration=1.2, cam_hz=5.0, render_images=True, **SMALL)
    generate_euroc_sequence(str(tmp_path), sim, seed=3)
    _, paths = load_euroc_camera_index(str(tmp_path))
    ref = read_image_sequence(paths)
    got = bench_frontend.make_euroc_frames(
        bench_frontend.EurocSimParams(duration=1.2, cam_hz=5.0, **SMALL), seed=3
    )
    assert got.dtype == np.uint8 and got.shape == ref.shape == (7, 240, 376)
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def frames():
    p = bench_frontend.EurocSimParams(duration=6.0, cam_hz=5.0, **SMALL)
    return bench_frontend.make_euroc_frames(p, seed=0)[:8]


def test_track_sequence_statistically_equivalent(frames):
    t_jax = jf.track_sequence(frames, params=jf.FrontendParams(),
                              key=jax.random.key(0))
    t_port = tf.track_sequence(frames, params=tf.FrontendParams(),
                               generator=torch.Generator().manual_seed(0),
                               device="cpu")
    n1, ids1, len1 = _stats(t_jax)
    n2, ids2, len2 = _stats(t_port)
    print(f"JAX: {n1} rows, {ids1} ids, mean length {len1:.3f}; "
          f"port: {n2} rows, {ids2} ids, mean length {len2:.3f}")
    assert n2 >= 60
    assert abs(n1 - n2) <= 0.1 * max(n1, n2), (n1, n2)
    assert abs(ids1 - ids2) <= 0.1 * max(ids1, ids2), (ids1, ids2)
    assert abs(len1 - len2) <= 0.5, (len1, len2)
    s1 = {(int(f), round(u, 1), round(v, 1)) for f, _, u, v in t_jax}
    s2 = {(int(f), round(u, 1), round(v, 1)) for f, _, u, v in t_port}
    overlap = len(s1 & s2) / max(len(s1 | s2), 1)
    assert overlap > 0.9, overlap


def test_track_sequence_modes_and_inputs_agree(frames):
    """Whole stack on the device or one frame at a time, uint8 or float, a
    numpy array or a tensor: the same loop on the same frames gives the same
    tracks. Tracks are contiguous in frames, as the tracker promises."""
    p = tf.FrontendParams()
    ref = tf.track_sequence(frames[:4], params=p, scan=True, device="cpu")
    for kw in (dict(scan=False),
               dict(frames=torch.from_numpy(frames[:4].astype(np.float32))),
               dict(generator=torch.Generator().manual_seed(0))):
        args = {"frames": frames[:4], "params": p, "device": "cpu", **kw}
        np.testing.assert_array_equal(tf.track_sequence(**args), ref)
    assert ref.shape[1] == 4 and ref.dtype == np.float64
    lengths = np.bincount(ref[:, 1].astype(int))
    longest = ref[ref[:, 1] == np.argmax(lengths)]
    assert (np.diff(np.sort(longest[:, 0])) == 1).all()


def test_params_defaults_field_by_field():
    jp, tp = jf.FrontendParams(), tf.FrontendParams()
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    assert interop.params_from_jax(jp) == tp
    crossed = interop.params_from_jax(
        jf.FrontendParams(fast=jf.FASTParams(threshold=7.0, num_features=64),
                          tracker=jf.TrackerParams(num_features=64,
                                                   window_size=3))
    )
    assert crossed.fast.threshold == 7.0 and crossed.tracker.window_size == 3
    assert isinstance(crossed.tracker.matcher, tf.TrackerParams().matcher.__class__)
    assert tf._desc_words(tp) == jf._desc_words(jp) == 16


def test_params_checks():
    with pytest.raises(ValueError, match="unknown front-end method"):
        tf.FrontendParams(method="sift")
    with pytest.raises(ValueError, match="num_features"):
        tf.FrontendParams(tracker=tf.TrackerParams(num_features=100))
    with pytest.raises(ValueError, match="num_features"):
        tf.FrontendParams(method="orb", orb=tf.ORBDetectorParams(
            num_features=100))


@pytest.mark.parametrize("scan", [True, False])
def test_orb_track_sequence_modes_agree(frames, scan):
    """``method="orb"`` runs (it raised before the ORB port): both values
    of ``scan`` give the same tracks, with 8-word banks in the tracker."""
    orb = tf.FrontendParams(method="orb")
    ref = tf.track_sequence(frames[:3], params=orb, scan=True, device="cpu")
    got = tf.track_sequence(frames[:3], params=orb, scan=scan, device="cpu")
    np.testing.assert_array_equal(got, ref)
    assert len(ref) > 0 and set(np.unique(ref[:, 0])) <= {0.0, 1.0, 2.0}
    xy, desc, m = tf.detect_and_describe(torch.from_numpy(frames[0]), orb)
    assert desc.shape == (512, 8) and xy.shape == (512, 2) and m.any()
