"""Windowed VIO on its own (on the CPU at f64): parameters, the device and
host Schur complements, short sequences, crash-resume, and the seam
alignment of a later pass against the reference's own loop.

The sequence is 12 s at 5 Hz, 150 landmarks, seed 0, written by the port
(61 keyframes), run at ``window=20, overlap=5`` with chunks of 4 LM
iterations, at most 3 a window. Tolerances:

- the device complement against the host f64 one: positions within
  5e-3 m and ATE within 1e-3 m, the JAX package's own bounds
  (``tests/test_windowed_vio.py:191-210``: the two use different ridge
  constants; measured ~1e-6 m here, where both run f64);
- a resumed chain against the uninterrupted one: positions and ATE within
  1e-9 (measured 0: the chain is deterministic), also when stopped inside
  the second pass, which the port's checkpoint makes exact by carrying the
  previous pass's estimates. A file without them (the JAX package's
  format) resumes as the reference does, from a snapshot of estimates that
  are partly this pass's, and so parts from the uninterrupted chain;
- the vectorized seam alignment against the reference's loop (copied
  below): within 1e-12.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from libwave_tpu.pipelines import windowed_vio as jw
from libwave_tpu.utils import checkpoint as jck
from libwave_tpu_torch.pipelines import windowed_vio as tw
from libwave_tpu_torch.pipelines.euroc_vio import EurocVIOParams
from libwave_tpu_torch.sim import euroc_sim
from test_torch_windowed_vio import one_torch_thread  # noqa: F401

WIN = dict(window=20, overlap=5, solve_iters_chunk=4, solve_chunks_max=3)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wvio_resume"))
    euroc_sim.generate_euroc_sequence(
        root, euroc_sim.EurocSimParams(duration=12.0, cam_hz=5.0,
                                       nb_landmarks=150),
        seed=0, device="cpu")
    return root


def run(root, params=EurocVIOParams(), **kw):
    wkw = dict(WIN, **kw.pop("wparams", {}))
    return tw.run_euroc_vio_windowed(root, params, tw.WindowedVIOParams(**wkw),
                                     device="cpu", dtype=torch.float64, **kw)


def test_params_match_reference():
    import dataclasses

    got = {f.name: f.default for f in dataclasses.fields(tw.WindowedVIOParams)}
    ref = {f.name: f.default for f in dataclasses.fields(jw.WindowedVIOParams)}
    assert got == ref


@pytest.mark.parametrize("kw,match", [
    (dict(window=50, overlap=50), "overlap"),
    (dict(window=50, overlap=0), "overlap"),
    (dict(window=50, overlap=30), "window // 2"),
    (dict(mode="nope"), "mode"),
    (dict(boundary_obs="half"), "boundary_obs"),
    (dict(hessian_dtype="float32"), "hessian_dtype"),
    (dict(pad_percentile=0.5), "pad_percentile"),
    (dict(pad_percentile=101.0), "pad_percentile"),
])
def test_validate(kw, match):
    with pytest.raises(ValueError, match=match):
        tw.WindowedVIOParams(**kw).validate()
    with pytest.raises(ValueError):
        jw.WindowedVIOParams(**kw).validate()
    # freeze mode allows a wide overlap
    tw.WindowedVIOParams(window=50, overlap=30, mode="freeze").validate()


def test_device_and_host_complements_agree(root):
    est_h, rep_h = run(root, wparams=dict(marg_device=False))
    est_d, rep_d = run(root, wparams=dict(marg_device=True))
    assert rep_h["num_windows"] == rep_d["num_windows"] == 4
    assert rep_d["marg_host_fallbacks"] == rep_h["marg_host_fallbacks"] == 0
    np.testing.assert_allclose(est_d.poses.t.numpy(), est_h.poses.t.numpy(),
                               rtol=0, atol=5e-3)
    assert abs(rep_d["ate_rmse"] - rep_h["ate_rmse"]) < 1e-3


def test_short_sequences_take_one_window(root):
    # at or below the overlap: a single window, not a zero march step
    _, rep = run(root, EurocVIOParams(max_keyframes=8),
                 wparams=dict(window=60, overlap=10))
    assert rep["num_windows"] == 1 and rep["num_keyframes"] == 8
    assert rep["overlap"] == 7 and np.isfinite(rep["ate_rmse"])
    # below the window: one full-batch-equivalent solve
    _, rep = run(root, EurocVIOParams(max_keyframes=15))
    assert rep["num_windows"] == 1 and rep["window"] == 15
    assert rep["completed"] and rep["ate_rmse"] < 0.05


def _assert_same(a, b, tol=1e-9):
    (ea, ra), (eb, rb) = a, b
    np.testing.assert_allclose(ea.poses.t.numpy(), eb.poses.t.numpy(),
                               rtol=0, atol=tol)
    assert abs(ra["ate_rmse"] - rb["ate_rmse"]) < tol


@pytest.mark.parametrize("passes,stop", [(1, 2), (2, 5)])
def test_crash_resume_equals_uninterrupted(root, tmp_path, passes, stop):
    wp = dict(passes=passes)
    ck = str(tmp_path / "ck")
    full = run(root, wparams=wp)
    _, part = run(root, wparams=wp, checkpoint_dir=ck,
                  stop_after_windows=stop)
    assert not part["completed"] and part["windows_done"] == stop % 4
    path = os.path.join(ck, "windowed_vio.npz")
    if passes == 2:
        # inside pass 2: the previous pass's 5 estimates ride after the
        # reference's 12 leaves; the JAX package reads the file too
        with np.load(path) as f:
            assert len([k for k in f if k.startswith("leaf_")]) == 17
        like = {k: np.zeros(0) for k in (
            "est_q", "est_p", "est_v", "est_bg", "est_ba", "solved_upto",
            "windows_done", "window_costs", "prior_Lambda", "prior_b",
            "excl_pairs", "pass_done")}
        snap = jck.load_checkpoint(path, like)
        assert int(snap["pass_done"]) == 1 and int(snap["windows_done"]) == 1
        # the same file without them, as the JAX package writes it
        ck_ref = str(tmp_path / "ck_ref")
        os.makedirs(ck_ref)
        jck.save_checkpoint(os.path.join(ck_ref, "windowed_vio.npz"),
                            {k: np.asarray(v) for k, v in snap.items()})
    resumed = run(root, wparams=wp, checkpoint_dir=ck)
    assert resumed[1]["completed"]
    assert resumed[1]["windows_done"] == full[1]["num_windows"]
    _assert_same(resumed, full)
    if passes == 2:
        est_r, rep_r = run(root, wparams=wp, checkpoint_dir=ck_ref)
        assert rep_r["completed"]
        parted = np.abs(est_r.poses.t.numpy() - full[0].poses.t.numpy()).max()
        assert parted > 1e-9, parted
        shutil.rmtree(ck_ref)


def _tail_reference(est, prev, s, W, head, nreal):
    """The reference's seam alignment (``libwave_tpu/pipelines/
    windowed_vio.py:686-719``), its loop as written there."""
    est_q, est_p, est_v, est_bg, est_ba = est
    prev_q, prev_p, prev_v, prev_bg, prev_ba = prev
    a0 = s + min(head, nreal) - 1
    R2 = jw._quat_to_rot_np(est_q[a0])
    R1 = jw._quat_to_rot_np(prev_q[a0])
    R_rel = R2 @ R1.T
    dyaw = np.arctan2(R_rel[1, 0], R_rel[0, 0])
    cz, sz = np.cos(dyaw), np.sin(dyaw)
    Rz = np.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]])
    qz = np.array([np.cos(dyaw / 2), 0.0, 0.0, np.sin(dyaw / 2)])
    dp = est_p[a0] - Rz @ prev_p[a0]

    def _tail(arr, rot=None, shift=None, quat=False):
        seg = arr[s: s + nreal].copy()
        if quat:
            seg = np.stack([jw._quat_mult_np(qz, qk) for qk in seg])
            seg /= np.linalg.norm(seg, axis=1, keepdims=True)
        elif rot is not None:
            seg = seg @ rot.T
            if shift is not None:
                seg = seg + shift
        return np.concatenate([seg, np.tile(seg[-1], (W - nreal, 1))])

    q0 = _tail(prev_q, quat=True)
    p0 = _tail(prev_p, rot=Rz, shift=dp)
    v0 = _tail(prev_v, rot=Rz)
    bg0, ba0 = _tail(prev_bg), _tail(prev_ba)
    h = min(head, nreal)
    for x, e in zip((q0, p0, v0, bg0, ba0), est):
        x[:h] = e[s: s + h]
    return q0, p0, v0, bg0, ba0


@pytest.mark.parametrize("s,W,head,nreal", [
    (12, 20, 8, 20), (24, 20, 1, 20), (36, 20, 8, 14), (36, 20, 14, 14),
    (36, 20, 20, 14), (0, 20, 20, 20),
])
def test_seam_alignment_matches_reference_loop(rng, s, W, head, nreal):
    N = 56

    def quats():
        q = rng.normal(size=(N, 4))
        return q / np.linalg.norm(q, axis=1, keepdims=True)

    est = (quats(),) + tuple(rng.normal(size=(N, 3)) for _ in range(4))
    prev = (quats(),) + tuple(rng.normal(size=(N, 3)) for _ in range(4))
    got = tw._seam_aligned_init(est, prev, s, W, head, nreal)
    ref = _tail_reference(est, prev, s, W, head, nreal)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (W, r.shape[1])
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12)
