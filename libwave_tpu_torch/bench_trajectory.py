"""The trajectory back end's configurations and data: the GPS/INS
smoother, the NLLS curve fits and the planted float-descriptor banks.

Shared by ``chip_smoke.py``'s gps_trajectory, nlls and float_flann phases,
the CPU parity tests (``tests/test_torch_{factors,nlls,flann_float}.py``)
and the JAX anchors (``tests/trajectory_anchors.py``,
``tests/flann_float_anchors.py``), so every run feeds the same numpy
arrays to whichever package it drives:

- :func:`gps_truth`: a vehicle at 10 Hz on a constant twist with a slow
  yaw rate (speed, yaw rate and heading drawn from a numpy seed; the poses
  in closed form), a constant translational GPS bias and per-fix noise;
  :func:`gps_fixes` writes each fix as LLH about :data:`DATUM_LLH` with
  the port's ``llh_point_from_enu`` on the host CPU at f64;
- :func:`gps_fixes_enu`: on a device, the fixes back into ENU
  (``enu_point_from_llh``);
- :func:`gps_problem`: the fixes' ENU into a ``MeasurementBuffer`` by
  ``insert_batch``, each state's fix read back by ``get_interpolated``,
  and the factor banks (:func:`gps_residual_fns`) on a
  ``PoseVelBiasState`` started 0.1 m off the truth;
- :func:`curve_batch`: ``tests/test_nlls.py``'s exponential curve (68
  points, ``default_rng(0)``), a batch of noise draws whose first row is
  the test's;
- :func:`planted_float`: ``tests/test_flann.py``'s planted SIFT-like bank
  (``_planted_float``) at any size.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from libwave_tpu_torch.containers import measurement
from libwave_tpu_torch.geography import world_frame
from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.optim import factors
from libwave_tpu_torch.optim.states import PoseVelBiasState

# tests/test_geography.py's datum (Waterloo)
DATUM_LLH = (43.472285, -80.544858, 329.0)
GPS_STATES = 200  # 20 s at 10 Hz
GPS_DT = 0.1
GPS_SEED = 0
GPS_ITERS = 25
GPS_BIAS_M = (0.25, -0.15, 0.08)  # |bias| 0.30 m
GPS_NOISE_M = 0.03
GPS_OFFSET_M = 0.1  # the start: the true trajectory moved by this
# tests/test_factors.py:141-182's decaying-bias bank
BIAS_TAU = 1e9
BIAS_SQRT_INFO = 100.0
GPS_SENSOR = 0

# tests/test_nlls.py:74-88
CURVE_POINTS = 68
CURVE_M, CURVE_C, CURVE_SIGMA = 0.3, 0.1, 0.02
CURVE_BOUNDS = (0.02, 0.05)  # |m - 0.3|, |c - 0.1|
CURVE_ITERS = 100

# tests/test_flann.py:232-234's approximate-index parameters, and the JAX
# test's recall floors
FLANN_TEST = dict(num_trees=6, key_bits=6, bucket_capacity=96, num_probes=6)
RECALL_FLOORS = {"kdtree": 0.85, "kmeans": 0.9, "composite": 0.95}
FLANN_SEED = 42  # the tests' rng fixture


def gps_truth(T: int = GPS_STATES, seed: int = GPS_SEED) -> dict:
    """The true trajectory (numpy f64): ``times`` (T,), ``q`` (T, 4),
    ``p`` (T, 3), ``vel`` (T, 6) (the body twist [omega, v]), the GPS
    ``bias`` (3,) and per-fix ``noise`` (T, 3). A constant body twist
    moves the vehicle on a circle arc: heading theta_k = theta_0 + w k dt,
    p_k = p_0 + (v / w) [sin theta_k - sin theta_0,
    cos theta_0 - cos theta_k, 0]."""
    rng = np.random.default_rng(seed)
    speed = rng.uniform(5.0, 10.0)
    yaw_rate = rng.uniform(0.02, 0.05) * rng.choice([-1.0, 1.0])
    theta0 = rng.uniform(-math.pi, math.pi)
    p0 = rng.uniform(-50.0, 50.0, 3) * np.array([1.0, 1.0, 0.05])
    noise = GPS_NOISE_M * rng.standard_normal((T, 3))
    times = np.arange(T) * GPS_DT
    theta = theta0 + yaw_rate * times
    r = speed / yaw_rate
    p = np.stack([p0[0] + r * (np.sin(theta) - math.sin(theta0)),
                  p0[1] + r * (math.cos(theta0) - np.cos(theta)),
                  np.full(T, p0[2])], axis=-1)
    q = np.stack([np.cos(theta / 2), np.zeros(T), np.zeros(T),
                  np.sin(theta / 2)], axis=-1)
    vel = np.tile([0.0, 0.0, yaw_rate, speed, 0.0, 0.0], (T, 1))
    return {"times": times, "q": q, "p": p, "vel": vel,
            "bias": np.asarray(GPS_BIAS_M), "noise": noise}


def gps_fixes(truth: dict) -> np.ndarray:
    """Each GPS fix's position (truth + bias + noise, ENU about the datum)
    as LLH (T, 3), written on the host CPU at f64."""
    enu = truth["p"] + truth["bias"] + truth["noise"]
    return world_frame.llh_point_from_enu(enu, DATUM_LLH,
                                          device="cpu").numpy()


def gps_residual_fns(T_meas: SE3, prior: SE3, prior_vel: torch.Tensor):
    """The smoother's factor banks, each one call over all its instances:
    GPS-with-bias over every state, motion and decaying bias over (i, i+1),
    a pose and a twist prior on state 0 (the gauge)."""
    T = T_meas.t.shape[0]
    i = torch.arange(T, device=T_meas.t.device)
    a, b = i[:-1], i[1:]
    dts = torch.full((T - 1,), GPS_DT, dtype=T_meas.t.dtype,
                     device=T_meas.t.device)
    first = i[:1]
    return [
        lambda s: factors.gps_residual(s, i, T_meas),
        lambda s: factors.motion_residual(s, a, b, dts),
        lambda s: factors.decaying_bias_residual(s, a, b, dts, BIAS_TAU,
                                                 BIAS_SQRT_INFO),
        lambda s: factors.pose_prior_residual(s, first, prior),
        lambda s: factors.twist_prior_residual(s, first, prior_vel),
    ]


def gps_fixes_enu(llh: np.ndarray, device=None) -> torch.Tensor:
    """The fixes' LLH back in ENU about the datum, on ``device``."""
    return world_frame.enu_point_from_llh(llh, DATUM_LLH, device=device)


def gps_problem(truth: dict, enu: torch.Tensor):
    """The smoother's problem on the device of ``enu`` (T, 3), the fixes in
    ENU (:func:`gps_fixes_enu`): (state0, residual_fns, ok), ``ok`` (T,)
    the buffer's flags for each state's fix."""
    def dev(x):
        return torch.as_tensor(x, device=enu.device)

    T = enu.shape[0]
    times, q = dev(truth["times"]), dev(truth["q"])
    buf = measurement.measurement_buffer(T, 7, torch.float64, enu.device)
    buf = measurement.insert_batch(
        buf, times, torch.full((T,), GPS_SENSOR, dtype=torch.int32,
                               device=enu.device),
        torch.cat([enu, q], dim=-1))
    fix, ok = measurement.get_interpolated(buf, times, GPS_SENSOR)
    T_meas = SE3(q=fix[:, 3:7], t=fix[:, 0:3])
    p, vel = dev(truth["p"]), dev(truth["vel"])
    state0 = PoseVelBiasState(q=q, p=p + GPS_OFFSET_M, vel=vel,
                              bias=torch.zeros_like(p))
    prior = SE3(q=q[:1], t=p[:1])
    return state0, gps_residual_fns(T_meas, prior, vel[:1]), ok


def gps_errors(state, truth: dict) -> dict:
    """Worst position and bias errors of a solved state (m)."""
    p = state.p.detach().cpu().numpy()
    b = state.bias.detach().cpu().numpy()
    return {"position_m": float(np.abs(p - truth["p"]).max()),
            "bias_m": float(np.abs(b - truth["bias"]).max())}


def curve_batch(n: int = 1, seed: int = 0):
    """(x (68,), y (n, 68)) f64: the curve-fitting tutorial's samples,
    ``y = exp(0.3 x + 0.1) + 0.02 N(0, 1)``, one noise draw a row from one
    generator (row 0 is ``tests/test_nlls.py``'s draw)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 5, CURVE_POINTS)
    y = np.exp(CURVE_M * x + CURVE_C) + CURVE_SIGMA * rng.standard_normal(
        (n, CURVE_POINTS))
    return x, y


def planted_float(rng, n_train=2048, n_query=256, dim=128, noise=0.03):
    """``tests/test_flann.py``'s ``_planted_float``: unit-norm train rows,
    queries are noisy copies of the rows ``src``."""
    d2 = rng.normal(size=(n_train, dim)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    src = rng.choice(n_train, n_query, replace=False)
    d1 = d2[src] + noise * rng.normal(size=(n_query, dim)).astype(
        np.float32
    )
    return d1.astype(np.float32), d2, src
