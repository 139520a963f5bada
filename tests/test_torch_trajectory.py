"""Parity of libwave_tpu_torch.benchmark.trajectory with
libwave_tpu.benchmark.trajectory: interpolation at query times (inside,
between and outside the stream), pose and trajectory errors, Umeyama
alignment, ATE and RPE, on random f64 trajectories made with numpy
(rtol 1e-10), and the CSV export (identical files)."""

import jax.numpy as jnp
import numpy as np
import torch

from libwave_tpu.benchmark import trajectory as jt
from libwave_tpu.geometry import se3 as jse3
from libwave_tpu_torch.benchmark import trajectory as tt
from libwave_tpu_torch.geometry import se3 as tse3


def _close(t, j, rtol=1e-10):
    j = np.asarray(j)
    np.testing.assert_allclose(np.asarray(t), j, rtol=rtol,
                               atol=rtol * max(np.abs(j).max(), 1.0))


def _traj(rng, T=20, noise=0.0):
    xi = np.cumsum(rng.normal(size=(T, 6)) * 0.1, axis=0) + noise * \
        rng.normal(size=(T, 6))
    times = np.cumsum(rng.uniform(0.05, 0.15, T))
    Pj = jse3.exp(jnp.asarray(xi))
    return (jt.Trajectory(jnp.asarray(times), Pj),
            tt.Trajectory(torch.as_tensor(times),
                          tse3.SE3(torch.as_tensor(np.array(Pj.q)),
                                   torch.as_tensor(np.array(Pj.t)))))


def test_interpolate_and_errors(rng):
    truth_j, truth_t = _traj(rng)
    times = np.asarray(truth_j.times)
    qt = np.concatenate([[times[0] - 1.0], times[3:6],
                         0.5 * (times[7:10] + times[8:11]), [times[-1] + 1]])
    a = tt.interpolate_at(truth_t, torch.as_tensor(qt))
    b = jt.interpolate_at(truth_j, jnp.asarray(qt))
    _close(a.q, b.q)
    _close(a.t, b.t)
    est_j, est_t = _traj(rng)
    for x, y in zip(tt.trajectory_error(truth_t, est_t),
                    jt.trajectory_error(truth_j, est_j)):
        _close(x, y)


def test_umeyama_ate_rpe(rng):
    truth_j, truth_t = _traj(rng, T=30)
    # the estimate: the truth moved rigidly, plus noise
    R = jse3.exp(jnp.asarray([0.3, -0.2, 0.5, 1.0, 2.0, -0.5]))
    est_pos = np.asarray(R.apply(truth_j.poses.t)) + 0.01 * rng.normal(
        size=(30, 3))
    est_j = jt.Trajectory(truth_j.times, jse3.SE3(
        q=jnp.asarray(np.asarray(truth_j.poses.q)), t=jnp.asarray(est_pos)))
    est_t = tt.Trajectory(truth_t.times, tse3.SE3(
        q=truth_t.poses.q, t=torch.as_tensor(est_pos)))
    A = tt.align_trajectories_umeyama(truth_t.poses.t, est_t.poses.t)
    B = jt.align_trajectories_umeyama(truth_j.poses.t, est_j.poses.t)
    _close(A.rotation(), B.rotation())
    _close(A.t, B.t)
    for align in (True, False):
        a, ea = tt.absolute_trajectory_error(truth_t, est_t, align)
        b, eb = jt.absolute_trajectory_error(truth_j, est_j, align)
        _close(a, b)
        _close(ea, eb)
    assert float(tt.absolute_trajectory_error(truth_t, est_t)[0]) < 0.03
    for delta in (1, 4):
        a = tt.relative_pose_error(truth_t, est_t, delta)
        b = jt.relative_pose_error(truth_j, est_j, delta)
        _close(a[0], b[0])
        _close(a[1], b[1])
        _close(a[2][0], b[2][0])
        _close(a[2][1], b[2][1])


def test_write_error_csv(tmp_path, rng):
    truth_j, truth_t = _traj(rng)
    est_j, est_t = _traj(rng)
    tt.write_error_csv(tmp_path / "t.csv", truth_t.times,
                       *tt.trajectory_error(truth_t, est_t))
    jt.write_error_csv(tmp_path / "j.csv", truth_j.times,
                       *jt.trajectory_error(truth_j, est_j))
    a = np.loadtxt(tmp_path / "t.csv", delimiter=",")
    b = np.loadtxt(tmp_path / "j.csv", delimiter=",")
    assert a.shape == b.shape == (20, 7)
    _close(a, b)
