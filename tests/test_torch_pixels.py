"""Pixels to trajectory in the port (``libwave_tpu_torch.pipelines.euroc_vio.
run_euroc_vio_from_images``) against the JAX package's, and the batched
tracker (``pipelines.visual_frontend.track_sequences_batched``) against the
port's own single-sequence tracker.

The pixels run takes the JAX test's sequence (``tests/
test_pixels_to_trajectory.py``: 6 s at 5 Hz, 120 landmarks, 376x240, seed
0), written by the JAX package's simulator (PIL) and read by each package's
own reader. RANSAC draws from other generators in the two packages, so the
end result is held as the tracker is: the port's ATE within 1.5x + 1 mm of
the JAX package's on the same directory, and the JAX test's own bounds
(ATE < 0.06 m and < 0.5x dead reckoning, >= 60 tracks).

``track_sequences_batched`` is held exactly: sequence b's tracks equal
``track_sequence`` of that sequence with the b-th generator.
"""

import numpy as np
import pytest
import torch

from libwave_tpu.pipelines import EurocVIOParams, run_euroc_vio_from_images
from libwave_tpu.sim import EurocSimParams, generate_euroc_sequence
from libwave_tpu_torch import bench_frontend
from libwave_tpu_torch.pipelines import euroc_vio as te
from libwave_tpu_torch.pipelines import visual_frontend as tf
from test_torch_windowed_vio import one_torch_thread  # noqa: F401

SIM = EurocSimParams(
    duration=6.0, cam_hz=5.0, nb_landmarks=120,
    fx=229.0, fy=228.0, cx=188.0, cy=120.0, width=376, height_px=240,
    render_images=True,
)
K = np.array([[SIM.fx, 0, SIM.cx], [0, SIM.fy, SIM.cy], [0, 0, 1.0]])
REPORT_KEYS = ("num_track_measurements", "num_tracks", "frontend_frames",
               "frontend_seconds", "frontend_frames_per_s")


def test_images_plus_imu_against_jax(tmp_path):
    root = str(tmp_path)
    generate_euroc_sequence(root, SIM, seed=0)
    _, rj = run_euroc_vio_from_images(root, EurocVIOParams(), K=K)
    _, rt = te.run_euroc_vio_from_images(
        root, te.EurocVIOParams(), K=K,
        generator=torch.Generator().manual_seed(0), device="cpu")
    print(f"ATE: port {rt['ate_rmse']:.6f} m, JAX {rj['ate_rmse']:.6f} m, "
          f"dead reckoning {rt['ate_rmse_deadreckon']:.6f}; tracks "
          f"{rt['num_tracks']} (JAX {rj['num_tracks']}), rows "
          f"{rt['num_track_measurements']} (JAX "
          f"{rj['num_track_measurements']})")
    assert rt["ate_rmse"] <= 1.5 * rj["ate_rmse"] + 1e-3
    assert rt["ate_rmse"] < 0.06
    assert rt["ate_rmse"] < 0.5 * rt["ate_rmse_deadreckon"]
    assert rt["num_tracks"] >= 60
    assert set(REPORT_KEYS) <= set(rt) and set(REPORT_KEYS) <= set(rj)
    assert rt["frontend_frames"] == rj["frontend_frames"] == 31
    assert rt["frontend_frames_per_s"] > 0
    n1, n2 = rt["num_track_measurements"], rj["num_track_measurements"]
    assert abs(n1 - n2) <= 0.1 * max(n1, n2)


@pytest.mark.parametrize("method", ["fast_brisk", "orb"])
def test_track_sequences_batched_equals_single(method):
    p = bench_frontend.EurocSimParams(
        duration=2.0, cam_hz=5.0, nb_landmarks=120, fx=229.0, fy=228.0,
        cx=188.0, cy=120.0, width=376, height_px=240)
    frames = bench_frontend.make_euroc_frames(p, seed=0)
    stack = np.stack([frames[:5], frames[4:9], frames[:5]])
    params = tf.FrontendParams(method=method)
    seeds = (5, 7, 9)
    batched = tf.track_sequences_batched(
        stack, params=params, device="cpu",
        generators=[torch.Generator().manual_seed(s) for s in seeds])
    assert len(batched) == 3
    for b, s in enumerate(seeds):
        single = tf.track_sequence(stack[b], params=params, device="cpu",
                                   generator=torch.Generator().manual_seed(s))
        assert len(single) > 0
        np.testing.assert_array_equal(batched[b], single)
    times = np.arange(5) * 0.2
    again = tf.track_sequences_batched(
        torch.from_numpy(stack[:1]), times=times, params=params, device="cpu")
    single = tf.track_sequence(stack[0], times=times, params=params,
                               device="cpu",
                               generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(again[0], single)
    with pytest.raises(ValueError, match="generators"):
        tf.track_sequences_batched(stack, params=params, device="cpu",
                                   generators=[torch.Generator()])
