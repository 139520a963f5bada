"""Parity of libwave_tpu_torch.pipelines.lidar_odometry with libwave_tpu's.

``_compose_scan`` (the doubling scan against ``lax.associative_scan``:
within 1e-12 at f64 on 37 random relative poses, measured 8.9e-15), and
``lidar_odometry`` on ``tests/test_pipelines.py``'s scan sequence (4
scans of 512 points, the same arrays in both packages:
``bench_lidar.scan_sequence`` rebuilds them bit for bit) with
full-resolution ICP, LUM information and pose-graph refinement, and with
NDT. At f64: equal iterations, trajectories within 1e-9, information
within rtol 1e-6. At f32: trajectories within 2e-6 m (ICP) and 3e-5 m
(NDT), measured 9.5e-7 and 1.8e-5 m; the LUM information is not compared at f32, since at an
exact fit its mean squared error is f32 rounding noise.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu import matching as jm
from libwave_tpu.geometry.se3 import SE3 as JSE3
from libwave_tpu.optim.pose_graph import PoseGraphConfig as JPGC
from libwave_tpu_torch import bench_lidar
from libwave_tpu_torch import matching as tm
from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.optim.pose_graph import PoseGraphConfig as TPGC
from test_pipelines import make_scan_sequence

# the packages export the function ``lidar_odometry`` over the module's name
jlo = importlib.import_module("libwave_tpu.pipelines.lidar_odometry")
tlo = importlib.import_module("libwave_tpu_torch.pipelines.lidar_odometry")

MATCHERS = {
    "icp": (jm.icp_match, tm.icp_match,
            dict(res=0, multiscale_steps=0, max_corr=1.0, max_iter=40),
            jm.ICPParams, tm.ICPParams, True),
    "ndt": (jm.ndt_match, tm.ndt_match, dict(res=2.0, max_iter=60),
            jm.NDTParams, tm.NDTParams, False),
}
F32_TOL = {"icp": 2e-6, "ndt": 3e-5}


def test_sequence_data_equals_the_jax_package_test():
    scans, poses = make_scan_sequence(T=4, n=512)
    pts, mask, q, p = bench_lidar.scan_sequence(T=4, n=512)
    np.testing.assert_array_equal(pts, np.asarray(scans.points))
    np.testing.assert_array_equal(mask, np.asarray(scans.mask))
    np.testing.assert_array_equal(q, np.stack([np.asarray(x.q)
                                               for x in poses]))
    np.testing.assert_array_equal(p, np.stack([np.asarray(x.t)
                                               for x in poses]))


@pytest.mark.parametrize("with_T0", [False, True])
def test_compose_scan(with_T0, rng):
    q = rng.normal(size=(37, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(size=(37, 3))
    T0 = None
    if with_T0:
        q0 = rng.normal(size=4)
        T0 = (q0 / np.linalg.norm(q0), rng.normal(size=3))
    got = tlo._compose_scan(
        SE3(q=torch.as_tensor(q), t=torch.as_tensor(t)),
        None if T0 is None else SE3(*(torch.as_tensor(a) for a in T0)))
    ref = jlo._compose_scan(
        JSE3(q=jnp.asarray(q), t=jnp.asarray(t)),
        None if T0 is None else JSE3(*(jnp.asarray(a) for a in T0)))
    assert got.q.shape == (38, 4)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", list(MATCHERS))
def test_lidar_odometry(name, dtype):
    jf, tf, params, jP, tP, refine = MATCHERS[name]
    pts, mask, _, p_true = bench_lidar.scan_sequence(T=4, n=512)
    pts = pts.astype(dtype)
    jc = jlo.LidarOdometryConfig(
        icp=jP(**params), refine_pose_graph=refine,
        pose_graph=JPGC(max_iterations=3, cg_max_iters=30))
    tc = tlo.LidarOdometryConfig(
        icp=tP(**params), refine_pose_graph=refine,
        pose_graph=TPGC(max_iterations=3, cg_max_iters=30))
    rj = jax.jit(lambda a, b: jlo.lidar_odometry(jm.PointCloud(a, b), jc,
                                                 matcher=jf))(
        jnp.asarray(pts), jnp.asarray(mask))
    rt = tlo.lidar_odometry(tm.PointCloud(torch.as_tensor(pts),
                                          torch.as_tensor(mask)), tc,
                            matcher=tf)
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    assert rt.information.shape == (3, 6, 6)
    tol = 1e-9 if dtype == np.float64 else F32_TOL[name]
    for a, b in zip(rt.trajectory, rj.trajectory):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol)
    for a, b in zip(rt.relative, rj.relative):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol)
    if dtype == np.float64:
        ij = np.asarray(rj.information)
        np.testing.assert_allclose(rt.information.numpy(), ij, rtol=0,
                                   atol=1e-6 * np.abs(ij).max())
    # the reference's own recovery bound (tests/test_pipelines.py)
    assert np.abs(rt.trajectory.t.numpy() - p_true).max() < 0.06


def test_bench_lidar_arrays_have_the_recorded_sha256():
    """The arrays chip_smoke.py checks on the card are the ones recorded
    (and fed to the JAX package by tests/lidar_anchors.py)."""
    got = {
        "pair": bench_lidar.scan_pair()[:2],
        "sequence": bench_lidar.scan_sequence(50, 4096)[:2],
        "ground": bench_lidar.ground_scene(),
    }
    for key, arrays in got.items():
        assert tuple(bench_lidar.sha256(a) for a in arrays) \
            == bench_lidar.SHA256[key], key
