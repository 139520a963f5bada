"""Parity of libwave_tpu_torch.sim.vo_dataset with libwave_tpu.sim.vo_dataset
at f64: given the JAX package's landmarks, the robot poses match to 1e-12,
the visibility masks and camera triggers are identical, and the pixels of
visible landmarks match to 1e-10 relative (sin/cos of two libraries along
a 300-step Euler recurrence)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from libwave_tpu.sim import vo_dataset as jvo
from libwave_tpu_torch.sim import vo_dataset as tvo

CONFIGS = [
    dict(nb_landmarks=30, steps=100, hz=10.0, fx=200.0, fy=200.0),
    dict(nb_landmarks=50, steps=300),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_same_landmarks_same_dataset(kw):
    dj = jvo.generate_vo_dataset(jvo.VoSimParams(**kw), jax.random.key(5))
    dt = tvo.generate_vo_dataset(tvo.VoSimParams(**kw),
                                 landmarks=np.asarray(dj.landmarks),
                                 device="cpu")
    assert dt.robot_p_GB.dtype == torch.float64
    for f in ("landmarks", "camera_K", "times"):
        np.testing.assert_array_equal(getattr(dt, f).numpy(),
                                      np.asarray(getattr(dj, f)))
    for f in ("robot_p_GB", "robot_q_GB"):
        np.testing.assert_allclose(getattr(dt, f).numpy(),
                                   np.asarray(getattr(dj, f)),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(dt.frame_has_obs.numpy(),
                                  np.asarray(dj.frame_has_obs))
    vis = np.asarray(dj.visible)
    np.testing.assert_array_equal(dt.visible.numpy(), vis)
    assert vis.any()
    np.testing.assert_allclose(dt.pixels.numpy()[vis],
                               np.asarray(dj.pixels)[vis], rtol=1e-10)
    assert dt.num_frames == dj.num_frames


def test_params_landmarks_and_checks():
    jp, tp = jvo.VoSimParams(), tvo.VoSimParams()
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    np.testing.assert_array_equal(tp.K(device="cpu").numpy(),
                                  np.asarray(jp.K()))
    np.testing.assert_allclose(tvo.q_BC(device="cpu").numpy(),
                               np.asarray(jvo.q_BC()), rtol=1e-15)
    p = tvo.VoSimParams(nb_landmarks=500)
    lm = tvo.draw_landmarks(p, seed=1)
    assert lm.shape == (500, 3)
    for k, (lo, hi) in enumerate((p.landmark_x_bounds, p.landmark_y_bounds,
                                  p.landmark_z_bounds)):
        assert lo <= lm[:, k].min() and lm[:, k].max() <= hi
    np.testing.assert_array_equal(lm, tvo.draw_landmarks(p, seed=1))
    ds = tvo.generate_vo_dataset(tvo.VoSimParams(nb_landmarks=20, steps=50),
                                 seed=1, device="cpu")
    np.testing.assert_array_equal(ds.landmarks.numpy(), tvo.draw_landmarks(
        tvo.VoSimParams(nb_landmarks=20, steps=50), seed=1))
    for bad in (dict(nb_landmarks=0), dict(hz=0.0), dict(dt=-1.0)):
        with pytest.raises(ValueError):
            tvo.generate_vo_dataset(tvo.VoSimParams(**bad), device="cpu")
