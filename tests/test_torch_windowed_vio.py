"""Windowed VIO (``pipelines.windowed_vio``): the port against the JAX
package on the CPU at f64, in marginalization mode with the default
"split" boundary observations.

The sequence is written by the JAX package: 12 s at 5 Hz, 150 landmarks,
seed 0 (61 keyframes), run at ``window=20, overlap=5`` (4 windows, the last
padded past the end) with chunks of 4 LM iterations, at most 3 a window.
Tolerances and what they measured:

- the whole chain: window costs within rtol 1e-9 (measured ~3e-12),
  keyframe positions within 1e-8 m (~4e-11) and ATE within 1e-9 m; the
  same LM iteration counts;
- the carried prior after window 1, read from each package's checkpoint
  with ``stop_after_windows=1``: ``excl_pairs`` equal, ``prior_Lambda``
  within 1e-9 of max|Lambda| and ``prior_b`` within 1e-9 of max|b|. The
  marginalization problem keeps the reference's "at least 2 inlier
  observations" gate, so no landmark of it is seen from one keyframe and
  its 3x3 blocks are regular: the two packages' priors part by 1.9e-13 of
  max|Lambda| (5.4e-13 of max|b|) here, where a singular block amplified
  the summation orders' difference to ~1e-6 of max|H| (found on the
  full-batch reduced Hessian of a 9-keyframe problem).
"""

import os

import jax
import numpy as np
import pytest
import torch

from libwave_tpu.pipelines import windowed_vio as jw
from libwave_tpu.pipelines.euroc_vio import EurocVIOParams as JParams
from libwave_tpu.sim import euroc_sim as jsim
from libwave_tpu_torch.pipelines import windowed_vio as tw
from libwave_tpu_torch.pipelines.euroc_vio import EurocVIOParams as TParams

SIM = dict(duration=12.0, cam_hz=5.0, nb_landmarks=150)
WIN = dict(window=20, overlap=5, solve_iters_chunk=4, solve_chunks_max=3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's window solves are many small tensor ops: one intra-op
    thread runs them about as fast as eight (41 s against 48 s for
    ``test_torch_windowed_resume.py`` alone) and leaves the cores to the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wvio"))
    jsim.generate_euroc_sequence(root, jsim.EurocSimParams(**SIM), seed=0)
    return root


def run_both(root, ckpt=None, **kw):
    """Both packages' ``run_euroc_vio_windowed`` on ``root`` (f64, the
    port on the CPU), checkpointing into ``ckpt/{jax,torch}``."""
    wkw = dict(WIN, **kw.pop("wparams", {}))
    j = jw.run_euroc_vio_windowed(
        root, JParams(), jw.WindowedVIOParams(**wkw),
        checkpoint_dir=None if ckpt is None else os.path.join(ckpt, "jax"),
        **kw)
    t = tw.run_euroc_vio_windowed(
        root, TParams(), tw.WindowedVIOParams(**wkw),
        checkpoint_dir=None if ckpt is None else os.path.join(ckpt, "torch"),
        device="cpu", dtype=torch.float64, **kw)
    return j, t


def assert_chains_agree(j, t):
    (ej, rj), (et, rt) = j, t
    assert rt["num_windows"] == rj["num_windows"]
    assert rt["windows_done"] == rj["windows_done"]
    assert rt["completed"] == rj["completed"]
    np.testing.assert_allclose(rt["window_final_costs"],
                               rj["window_final_costs"], rtol=1e-9)
    np.testing.assert_allclose(et.poses.t.numpy(), np.asarray(ej.poses.t),
                               rtol=0, atol=1e-8)
    assert abs(rt["ate_rmse"] - rj["ate_rmse"]) < 1e-9
    for k in ("num_keyframes", "num_keyframes_solved", "mode", "passes",
              "window", "overlap", "hessian_dtype", "num_landmarks_padded",
              "pad_buckets", "pad_bucket_windows"):
        assert rt[k] == rj[k], k


def test_chain_matches_reference(root):
    j, t = run_both(root)
    assert_chains_agree(j, t)
    rep = t[1]
    assert rep["num_keyframes"] == 61 and rep["num_windows"] == 4
    assert rep["completed"] and rep["marg_host_fallbacks"] == 0
    # every window ran whole chunks of LM iterations
    assert all(n % WIN["solve_iters_chunk"] == 0 and
               0 < n <= WIN["solve_iters_chunk"] * WIN["solve_chunks_max"]
               for n in rep["window_iterations"])
    assert len(rep["window_iterations"]) == 4
    assert rep["ate_rmse"] < 0.05
    assert set(rep) - set(j[1]) == {"marg_host_fallbacks",
                                    "window_iterations"}


def test_prior_after_window_one_matches_reference(root, tmp_path):
    j, t = run_both(root, ckpt=str(tmp_path), stop_after_windows=1)
    assert_chains_agree(j, t)
    assert not t[1]["completed"] and t[1]["windows_done"] == 1
    with np.load(tmp_path / "jax" / "windowed_vio.npz") as fj, \
            np.load(tmp_path / "torch" / "windowed_vio.npz") as ft:
        assert sorted(fj) == sorted(ft)  # 12 leaves and the treedef
        # leaves in sorted-key order: ..., excl_pairs (5), ...,
        # prior_Lambda (7), prior_b (8)
        np.testing.assert_array_equal(ft["leaf_5"], fj["leaf_5"])
        assert ft["leaf_5"].shape[1] == 2 and len(ft["leaf_5"]) > 0
        for i in (7, 8):
            ref = fj[f"leaf_{i}"]
            np.testing.assert_allclose(ft[f"leaf_{i}"], ref, rtol=0,
                                       atol=1e-9 * np.abs(ref).max())
        assert ft["leaf_7"].shape == (5 * 15, 5 * 15)
