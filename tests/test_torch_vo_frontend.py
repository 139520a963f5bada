"""The port's two-frame VO front end (``libwave_tpu_torch.pipelines.
vo_frontend.two_frame_pose``) against the JAX package's, on a rendered pair
of the simulated EuRoC sequence with its true relative rotation.

RANSAC's samples come from a ``torch.Generator`` in the port and from
``jax.random`` keys in the JAX package, and with a few dozen matches one
draw can land on another consensus set. So the two are held statistically:
the median rotation error against the truth over 8 generators is within
1.5x + 1e-3 rad of the JAX package's median over 8 keys. Everything before
RANSAC runs without randomness: the keypoints are the JAX package's, the
ratio-test survivors within 10% (or 2) of its count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.pipelines import vo_frontend as jv
from libwave_tpu_torch import bench_frontend, interop
from libwave_tpu_torch.pipelines import vo_frontend as tv
from test_torch_windowed_vio import one_torch_thread  # noqa: F401

SMALL = bench_frontend.EurocSimParams(
    duration=2.0, cam_hz=5.0, nb_landmarks=120, fx=229.0, fy=228.0,
    cx=188.0, cy=120.0, width=376, height_px=240)
SEEDS = range(8)


@pytest.fixture(scope="module")
def pair():
    return bench_frontend.vo_pair(SMALL, seed=0, i=2, j=4)


def test_two_frame_pose_rotation_error_against_jax(pair):
    a, b, K, R_true = pair
    run = jax.jit(jv.two_frame_pose, static_argnums=4)
    jax_res = [run(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
                   jnp.asarray(K, jnp.float32), jax.random.key(s),
                   jv.VOFrontendConfig()) for s in SEEDS]
    port_res = [tv.two_frame_pose(torch.from_numpy(a), torch.from_numpy(b), K,
                                  torch.Generator().manual_seed(s))
                for s in SEEDS]
    err_j = [bench_frontend.rotation_error(np.asarray(r.T_21.rotation()),
                                           R_true) for r in jax_res]
    err_t = [bench_frontend.rotation_error(r.T_21.rotation().numpy(), R_true)
             for r in port_res]
    print(f"rotation error (rad), true rotation "
          f"{bench_frontend.rotation_error(np.eye(3), R_true):.4f}: JAX median "
          f"{np.median(err_j):.5f} {np.round(err_j, 4)}, port median "
          f"{np.median(err_t):.5f} {np.round(err_t, 4)}")
    assert np.median(err_t) <= 1.5 * np.median(err_j) + 1e-3
    for r in port_res:
        assert abs(torch.linalg.norm(r.T_21.t).item() - 1.0) < 1e-5
        assert r.E.shape == (3, 3) and r.inliers.shape == (1024,)
        d = r.diagnostics
        assert int(d["num_epipolar_inliers"]) >= int(r.inliers.sum())
        assert int(d["cheirality_votes"].max()) == int(r.inliers.sum())
    # before RANSAC nothing is random: the keypoints are equal, and the
    # ratio-test survivors differ only where a BRISK bit does (>= 99% of the
    # bits agree, tests/test_torch_descriptor.py)
    dt, dj = port_res[0].diagnostics, jax_res[0].diagnostics
    assert int(dt["num_raw_matches"]) == int(dj["num_raw_matches"])
    nt, nj = int(dt["num_filtered_matches"]), int(dj["num_filtered_matches"])
    assert abs(nt - nj) <= max(2, 0.1 * nj), (nt, nj)
    np.testing.assert_array_equal(port_res[0].xy1.numpy(),
                                  np.asarray(jax_res[0].xy1))


def test_config_defaults_and_interop():
    jc, tc = jv.VOFrontendConfig(), tv.VOFrontendConfig()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert interop.params_from_jax(jc) == tc
    crossed = interop.params_from_jax(dataclasses.replace(
        jc, ransac_hypotheses=64,
        matcher=dataclasses.replace(jc.matcher, ratio_threshold=0.7)))
    assert crossed.ransac_hypotheses == 64
    assert crossed.matcher.ratio_threshold == 0.7
    assert not crossed.matcher.auto_remove_outliers
