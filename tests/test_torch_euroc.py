"""EuRoC VIO from the ASL directory: the port's sequence writer
(``sim.euroc_sim``), loaders (``datasets.euroc``), problem build and solve
(``pipelines.euroc_vio``) against the JAX package's, on the CPU at f64.

The sequence is 3 s at 200 Hz IMU and 5 Hz camera, 40 landmarks, seed 3
(16 keyframes). Tolerances and why:

- sequence files: with the IMU sigmas at 0 both writers draw the same
  numbers from ``np.random.default_rng(seed)`` and compute the same f64
  formulas, so every CSV agrees numerically within 1e-9 (the IMU columns
  are written with 9 decimals) and the track rows are equal. With the
  sigmas on, the IMU noise comes from different generators (a
  ``torch.Generator`` against ``jax.random``): everything but ``imu0``
  agrees, and the port's noise has mean within 4 standard errors of 0 and a
  standard deviation within 10% of each sigma (1,800 draws per sensor:
  its standard error is 1.7%);
- loaders: both packages parse one directory into equal f64 arrays;
- build: every ``VIOProblem`` field and the initial state within rtol 1e-9
  (f64 preintegration and dead reckoning in another summation order;
  measured ~1e-13), integer fields and inlier masks equal;
- solve: 5 LM iterations of the dense solver, cost trajectories within
  rtol 1e-6 and ATE within 1e-6 m (measured ~2e-13 and ~2e-15).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.benchmark.trajectory import Trajectory as JTrajectory
from libwave_tpu.benchmark.trajectory import absolute_trajectory_error as jate
from libwave_tpu.benchmark.trajectory import relative_pose_error as jrpe
from libwave_tpu.datasets import euroc as jeu
from libwave_tpu.geometry.se3 import SE3 as JSE3
from libwave_tpu.pipelines import euroc_vio as jev
from libwave_tpu.pipelines import vio as jv
from libwave_tpu.sim import euroc_sim as jsim
from libwave_tpu_torch import interop
from libwave_tpu_torch.datasets import euroc as teu
from libwave_tpu_torch.pipelines import euroc_vio as tev
from libwave_tpu_torch.pipelines import vio as tv
from libwave_tpu_torch.sim import euroc_sim as tsim

SIM = dict(duration=3.0, nb_landmarks=40)
SEED = 3
CSVS = ("imu0/data.csv", "state_groundtruth_estimate0/data.csv",
        "cam0/data.csv", "cam0/tracks.csv")


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """The JAX package's and the port's sequence, noise-free and noisy."""
    out = {}
    for noisy in (False, True):
        kw = dict(SIM) if noisy else dict(SIM, gyro_sigma=0.0,
                                          accel_sigma=0.0)
        for pkg in ("jax", "torch"):
            root = str(tmp_path_factory.mktemp(f"{pkg}_{noisy}"))
            if pkg == "jax":
                jsim.generate_euroc_sequence(root, jsim.EurocSimParams(**kw),
                                             seed=SEED)
            else:
                tsim.generate_euroc_sequence(root, tsim.EurocSimParams(**kw),
                                             seed=SEED, device="cpu")
            out[pkg, noisy] = root
    return out


def _csv(root, name):
    """A sequence CSV as f64 rows; cam0/data.csv (stamp, file name) as its
    stamps."""
    return np.loadtxt(f"{root}/mav0/{name}", delimiter=",", comments="#",
                      ndmin=2, usecols=0 if name == "cam0/data.csv" else None)


def _text(root, name):
    with open(f"{root}/mav0/{name}") as fh:
        return fh.read()


@pytest.mark.parametrize("name", CSVS)
def test_sequence_without_imu_noise_matches(sequences, name):
    a = _csv(sequences["torch", False], name)
    b = _csv(sequences["jax", False], name)
    assert a.shape == b.shape and a.shape[0] > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    if name == "cam0/tracks.csv":
        np.testing.assert_array_equal(a, b)
    if name == "cam0/data.csv":
        assert _text(sequences["torch", False], name) == _text(
            sequences["jax", False], name)


@pytest.mark.parametrize("name", CSVS)
def test_sequence_with_imu_noise(sequences, name):
    a = _csv(sequences["torch", True], name)
    b = _csv(sequences["jax", True], name)
    assert a.shape == b.shape
    if name != "imu0/data.csv":
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
        return
    np.testing.assert_array_equal(a[:, 0], b[:, 0])  # the time stamps
    # the port's noise: its noisy samples less its noise-free ones
    noise = a[:, 1:] - _csv(sequences["torch", False], name)[:, 1:]
    p = tsim.EurocSimParams(**SIM)
    for cols, sigma in ((slice(0, 3), p.gyro_sigma),
                        (slice(3, 6), p.accel_sigma)):
        x = noise[:, cols].ravel()
        assert abs(x.mean()) < 4 * sigma / np.sqrt(x.size)
        assert abs(x.std() / sigma - 1) < 0.1


LOADERS = ("load_euroc_imu", "load_euroc_ground_truth",
           "load_euroc_camera_index", "load_euroc_tracks")


@pytest.mark.parametrize("loader", LOADERS)
def test_loaders_read_one_directory_alike(sequences, loader):
    root = sequences["jax", True]
    got = getattr(teu, loader)(root)
    ref = getattr(jeu, loader)(root)
    if loader == "load_euroc_tracks":
        got, ref = (got,), (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if isinstance(r, list):
            assert g == r
        else:
            assert g.dtype == np.float64
            np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(teu.EUROC_CAM0_K, jeu.EUROC_CAM0_K)


def test_loaders_reject_what_is_missing(tmp_path):
    with pytest.raises(FileNotFoundError, match="imu0"):
        teu.load_euroc_imu(str(tmp_path))
    (tmp_path / "cam0").mkdir()
    (tmp_path / "cam0" / "data.csv").write_text("#t,f\n1,1.png\n")
    with pytest.raises(FileNotFoundError, match="tracks.csv"):
        teu.load_euroc_tracks(str(tmp_path))


@pytest.fixture(scope="module")
def builds(sequences):
    root = sequences["jax", True]
    pj, sj, gj, kj = jev.build_euroc_vio_problem(root)
    pt, st, gt, kt = tev.build_euroc_vio_problem(root, device="cpu",
                                                 dtype=torch.float64)
    return root, (pj, sj, gj, kj), (pt, st, gt, kt)


def _close(got, ref, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    if np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    scale = max(np.abs(ref).max(initial=0.0), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9 * scale,
                               err_msg=what)


def _check_layout(ell, pj):
    """Each landmark's run of the port's layout lists slots of that
    landmark, and its weighted slots are the JAX problem's."""
    sigma, off = ell.sigma.numpy(), ell.offsets.numpy()
    lm, w = np.asarray(pj.lm_idx), np.asarray(pj.obs_weight)
    assert len(off) >= int(lm.max()) + 2
    for m in range(len(off) - 1):
        run = sigma[off[m]:off[m + 1]]
        assert (lm[run] == m).all()
        np.testing.assert_array_equal(
            np.sort(run[w[run] > 0]), np.nonzero((lm == m) & (w > 0))[0])


def test_build_matches_reference(builds):
    _, (pj, sj, gj, kj), (pt, st, gt, kt) = builds
    # the JAX package's problem carried into the port's containers
    pref = interop.vio_problem_from_jax_numpy(jax.tree.map(np.asarray, pj),
                                              device="cpu")
    for f in tv.VIOProblem._fields:
        a, b = getattr(pt, f), getattr(pref, f)
        if f == "pim":
            for g in a._fields:
                _close(getattr(a, g), getattr(b, g), f"pim.{g}")
        elif f == "ell":
            _check_layout(a, pj)
        elif isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype, f
            _close(a, b, f)
        else:
            assert a == b, f
    # the inlier masks: the same observations weighted 1, the rest 0
    np.testing.assert_array_equal(pt.obs_weight.numpy(),
                                  np.asarray(pj.obs_weight))
    assert set(np.unique(pt.obs_weight.numpy())) <= {0.0, 1.0}
    for f in tv.VIOState._fields:
        _close(getattr(st, f), getattr(sj, f), f"state.{f}")
    _close(gt.times, gj.times, "gt times")
    _close(gt.poses.q, gj.poses.q, "gt q")
    _close(gt.poses.t, gj.poses.t, "gt p")
    _close(kt, kj, "keyframe times")


def test_build_keeps_single_keyframe_landmarks_out(builds):
    """``min_track_length`` and the "< 2 inliers" drop leave no landmark
    whose live observations come from one keyframe (such a landmark's
    undamped 3x3 block is singular)."""
    _, _, (pt, st, _, _) = builds
    w = pt.obs_weight.numpy() > 0
    pose, lm = pt.pose_idx.numpy()[w], pt.lm_idx.numpy()[w]
    views = [len(np.unique(pose[lm == m])) for m in range(st.lm.shape[0])]
    assert 1 not in views, views


def test_times_are_sequence_relative_f64(builds):
    _, _, (_, _, gt, kt) = builds
    assert kt.dtype == gt.times.dtype == torch.float64
    assert float(kt[0]) == 0.0 and float(kt.max()) < 1e5
    assert (np.diff(kt.numpy().astype(np.float32)) > 0).all()


def test_f32_build_keeps_f64_times(sequences):
    pt, st, gt, kt = tev.build_euroc_vio_problem(sequences["jax", True],
                                                 device="cpu")
    assert pt.uv.dtype == st.q.dtype == pt.pim.dq.dtype == torch.float32
    assert kt.dtype == gt.times.dtype == gt.poses.q.dtype == torch.float64


@pytest.mark.parametrize("return_raw", [False, True])
def test_track_bank_and_camera_matrices(builds, return_raw):
    root, (pj, sj, *_), _ = builds
    tracks = jeu.load_euroc_tracks(root)
    got = tev._track_bank(tracks, 12, 3, frame_offset=2,
                          return_raw=return_raw)
    ref = jev._track_bank(tracks, 12, 3, frame_offset=2,
                          return_raw=return_raw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    qbc = np.asarray(tsim.default_q_BC(torch.float64, "cpu"))
    q, p = np.asarray(sj.q), np.asarray(sj.p)
    _close(tev._camera_P_mats(q, p, teu.EUROC_CAM0_K, qbc),
           jev._camera_P_mats(q, p, jeu.EUROC_CAM0_K, jnp.asarray(qbc)),
           "P matrices")


def test_run_euroc_vio_matches_reference(builds):
    root, (pj, sj, gj, kj), _ = builds
    params = tev.EurocVIOParams()
    kw = dict(max_iterations=5, cg_max_iters=150,
              huber_delta=params.huber_delta)
    sol, info = jax.jit(lambda p, s: jv.solve_vio(p, s, jv.VIOConfig(**kw)))(
        pj, sj)
    est = JTrajectory(kj, JSE3(q=sol.q, t=sol.p))
    ate_j = float(jate(gj, est)[0])
    rpe_j = float(jrpe(gj, est, delta=1)[0])
    state, rep = tev.run_euroc_vio(root, params, tv.VIOConfig(**kw),
                                   device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(rep["costs"], np.asarray(info["costs"]),
                               rtol=1e-6)
    np.testing.assert_allclose(rep["initial_cost"],
                               float(info["initial_cost"]), rtol=1e-6)
    assert abs(rep["ate_rmse"] - ate_j) < 1e-6
    assert abs(rep["rpe_trans_rmse"] - rpe_j) < 1e-6
    assert rep["final_cost"] < rep["initial_cost"]
    assert rep["ate_rmse"] < rep["ate_rmse_deadreckon"]
    assert rep["num_keyframes"] == sol.q.shape[0] == 16
    for f in tv.VIOState._fields:
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(sol, f)), rtol=1e-6,
                                   atol=1e-8)


def test_default_vio_config():
    p = tev.EurocVIOParams(huber_delta=2.5)
    assert tev.default_vio_config(p) == tv.VIOConfig(
        max_iterations=25, cg_max_iters=150, huber_delta=2.5)
    ref = jev.default_vio_config(jev.EurocVIOParams(huber_delta=2.5))
    assert (ref.max_iterations, ref.cg_max_iters, ref.huber_delta) == (
        25, 150, 2.5)
    assert tev.EurocVIOParams() == tev.EurocVIOParams(
        **jev.EurocVIOParams().__dict__)
    assert tsim.EurocSimParams() == tsim.EurocSimParams(
        **jsim.EurocSimParams().__dict__)
