"""Parity of libwave_tpu_torch.pipelines.vio with libwave_tpu.pipelines.vio
at f64, on the JAX package's synthetic VO dataset (30 landmarks, 100 steps,
10 Hz keyframes: 9 keyframes) and a state perturbed with numpy from a seed.

- ``vio_from_sim`` without noise (``key=None`` / no generator), fed the
  same landmarks: every problem field to 1e-9 relative (the IMU whitening
  inverts a covariance built from 1e-8-scale entries);
- ``vio_cost`` (with and without Huber, with a landmark behind a camera):
  rtol 1e-12;
- the ``_linearize_vio`` blocks: rtol 1e-10, atol 1e-12 * max; the IMU
  Jacobians also against central differences of the whitened residual to
  1e-3 of their largest entry (BASELINE.md);
- ``vio_marginalize_device`` and ``vio_reduced_hessian``: 1e-8 relative to
  the largest entry (a Cholesky of the stiff IMU chain), with the
  observations of landmarks seen from one keyframe dropped (their undamped
  blocks are singular);
- ``vio_dead_reckon``: 1e-12.

The JAX package's functions run under ``jax.jit`` (their eager dispatch
costs several times their compile). The solve trajectories are in
tests/test_torch_vio_solve.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.geometry import so3 as jso3
from libwave_tpu.pipelines import vio as jv
from libwave_tpu.sim import VoSimParams, generate_vo_dataset
from libwave_tpu_torch import interop
from libwave_tpu_torch.pipelines import vio as tv
from libwave_tpu_torch.sim import vo_dataset as tvo

PARAMS = dict(nb_landmarks=30, steps=100, hz=10.0, fx=200.0, fy=200.0)

_jax_cost = jax.jit(jv.vio_cost, static_argnames=("axis_name", "huber_delta"))
_jax_linearize = jax.jit(jv._linearize_vio)
_jax_imu = jax.jit(jv._imu_linearize)
_jax_marginalize = jax.jit(jv.vio_marginalize_device,
                           static_argnames=("keep_dim",))
_jax_reduced_hessian = jax.jit(jv.vio_reduced_hessian)


def _close(t, j, rtol, atol_rel=None):
    j = np.asarray(j)
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    atol = (rtol if atol_rel is None else atol_rel) * max(np.abs(j).max(),
                                                          1e-300)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def vio_pair():
    ds_j = generate_vo_dataset(VoSimParams(**PARAMS), jax.random.key(2))
    pj, gj = jv.vio_from_sim(ds_j)
    ds_t = tvo.generate_vo_dataset(tvo.VoSimParams(**PARAMS),
                                   landmarks=np.asarray(ds_j.landmarks),
                                   device="cpu")
    pt_own, gt_own = tv.vio_from_sim(ds_t, device="cpu")
    rng = np.random.default_rng(11)
    N, M = gj.q.shape[0], gj.lm.shape[0]
    init_j = jv.VIOState(
        q=jso3.quat_boxplus(gj.q, jnp.asarray(0.01 * rng.normal(size=(N, 3)))),
        p=gj.p + 0.03 * rng.normal(size=(N, 3)),
        v=gj.v + 0.01 * rng.normal(size=(N, 3)),
        bg=gj.bg + 1e-3 * rng.normal(size=(N, 3)),
        ba=gj.ba + 1e-2 * rng.normal(size=(N, 3)),
        lm=gj.lm + 0.2 * rng.normal(size=(M, 3)),
    )
    pt = interop.vio_problem_from_jax_numpy(jax.tree.map(np.asarray, pj),
                                            "cpu")
    st = interop.vio_state_from_jax_numpy(jax.tree.map(np.asarray, init_j),
                                          "cpu")
    return dict(pj=pj, gj=gj, pt_own=pt_own, gt_own=gt_own, init_j=init_j,
                pt=pt, st=st)


def test_vio_from_sim_without_noise(vio_pair):
    pj, pt = vio_pair["pj"], vio_pair["pt_own"]
    for f in ("K", "pose_idx", "lm_idx", "uv", "obs_weight", "imu_i",
              "imu_j", "imu_sqrt_info", "bias_walk_sqrt_info", "free_pose",
              "q_BC", "bias_prior_sqrt_info"):
        _close(getattr(pt, f), getattr(pj, f), 1e-9)
    for f in jv.PreintegratedImu._fields:
        _close(getattr(pt.pim, f), getattr(pj.pim, f), 1e-9)
    assert pt.pixel_sigma == pj.pixel_sigma and pt.gravity == pj.gravity
    for a, b in zip(vio_pair["gt_own"], vio_pair["gj"]):
        _close(a, b, 1e-9)
    # landmark runs: the real (weighted) slots of each landmark, slot order
    lm, w = np.asarray(pj.lm_idx), np.asarray(pj.obs_weight) > 0
    sig, off = pt.ell.sigma.numpy(), pt.ell.offsets.numpy()
    for m in range(vio_pair["gj"].lm.shape[0]):
        np.testing.assert_array_equal(sig[off[m]:off[m + 1]],
                                      np.nonzero((lm == m) & w)[0])


@pytest.mark.parametrize("huber", [None, 1.5])
def test_vio_cost(huber, vio_pair):
    pj, pt, init_j, st = (vio_pair[k] for k in ("pj", "pt", "init_j", "st"))
    cj = _jax_cost(pj, init_j, huber_delta=huber)
    ct = tv.vio_cost(pt, st, huber_delta=huber)
    assert ct.dtype == torch.float64
    _close(ct, cj, 1e-12)
    # a landmark observed by keyframe 0 moved behind that camera: the 1e10
    # cheirality penalty per observation
    m = int(np.asarray(pj.lm_idx)[0])
    lm = np.asarray(init_j.lm).copy()
    lm[m] = np.asarray(init_j.p)[0] - 5.0 * np.asarray(
        jso3.quat_rotate(jso3.quat_multiply(init_j.q[0], pj.q_BC),
                         jnp.asarray([0.0, 0.0, 1.0])))
    bj = _jax_cost(pj, init_j._replace(lm=jnp.asarray(lm)),
                   huber_delta=huber)
    bt = tv.vio_cost(pt, st._replace(lm=torch.as_tensor(lm)), huber_delta=huber)
    assert float(bt) > 1e10
    _close(bt, bj, 1e-12)


def test_linearize_blocks_and_imu_jacobians(vio_pair):
    pj, pt, init_j, st = (vio_pair[k] for k in ("pj", "pt", "init_j", "st"))
    bj = _jax_linearize(pj, init_j, 1e-4)
    bt = tv._linearize_vio(pt, st, torch.tensor(1e-4, dtype=torch.float64))
    for f in ("Hpp", "Hll_inv", "W", "bp", "bl", "C", "ci", "cj",
              "free_pose"):
        assert getattr(bt, f).shape == getattr(bj, f).shape, f
        _close(getattr(bt, f), getattr(bj, f), 1e-10, 1e-12)
    r, Ji, Jj = tv._imu_linearize(pt, st)
    rj, Jij, Jjj = _jax_imu(pj, init_j)
    for a, b in ((r, rj), (Ji, Jij), (Jj, Jjj)):
        _close(a, b, 1e-10, 1e-12)
    # central differences of the whitened residual, one keyframe block at
    # a time, through the same product retraction
    res, z = tv._imu_whitened(pt, st)
    eps = 1e-6
    for J, first in ((Ji, True), (Jj, False)):
        num = torch.zeros_like(J)
        for k in range(tv.D):
            d = torch.zeros_like(z)
            d[:, k] = eps
            args_p = (d, z) if first else (z, d)
            args_m = (-d, z) if first else (z, -d)
            num[..., k] = (res(*args_p) - res(*args_m)) / (2 * eps)
        scale = float(num.abs().max())
        assert float((J - num).abs().max()) <= 1e-3 * scale


def test_widened_hessian_blocks(vio_pair):
    pt, st = vio_pair["pt"], vio_pair["st"]
    f32 = lambda x: x.float() if isinstance(x, torch.Tensor) and \
        x.is_floating_point() else x
    p32 = pt._replace(pim=type(pt.pim)(*map(f32, pt.pim)),
                      **{f: f32(getattr(pt, f)) for f in pt._fields
                         if f not in ("pim", "ell")})
    s32 = tv.VIOState(*map(f32, st))
    b = tv._linearize_vio(p32, s32, torch.tensor(1e-4), None, None,
                          "float64")
    assert b.Hpp.dtype == b.bp.dtype == b.C.dtype == torch.float64
    assert b.W.dtype == b.Hll_inv.dtype == torch.float32
    ref = tv._linearize_vio(pt, st, torch.tensor(1e-4, dtype=torch.float64))
    _close(b.Hpp, ref.Hpp.numpy(), 0.0, 1e-5)


def test_reduced_hessian_and_marginalization(vio_pair):
    pj, pt, init_j, st = (vio_pair[k] for k in ("pj", "pt", "init_j", "st"))
    # undamped, a landmark seen from one keyframe has a singular (rank 2)
    # block whose inverse amplifies the two packages' different summation
    # orders to 1e-6: its observations are dropped in both, which leaves it
    # like a landmark nobody sees
    lm, w = np.asarray(pj.lm_idx), np.asarray(pj.obs_weight)
    seen = np.bincount(lm[w > 0], minlength=np.asarray(init_j.lm).shape[0])
    w = np.where(seen[lm] >= 2, w, 0.0)
    pj = pj._replace(obs_weight=jnp.asarray(w))
    pt = pt._replace(obs_weight=torch.as_tensor(w))
    keep = 2 * tv.D
    Lj, mj = _jax_marginalize(pj, init_j, keep_dim=keep)
    Lt, mt = tv.vio_marginalize_device(pt, st, keep)
    assert Lt.shape == (keep, keep)
    _close(Lt, Lj, 1e-8, 1e-8)
    _close(mt, mj, 1e-8, 1e-8)
    Hj, bj = _jax_reduced_hessian(pj, init_j)
    Ht, bt = tv.vio_reduced_hessian(pt, st)
    _close(Ht, Hj, 1e-8, 1e-10)
    _close(bt, bj, 1e-8, 1e-10)


def test_dead_reckon(vio_pair):
    pj, pt, gj = vio_pair["pj"], vio_pair["pt"], vio_pair["gj"]
    out_j = jv.vio_dead_reckon(pj, gj.q[0], gj.p[0], gj.v[0], gj.lm)
    args = (torch.as_tensor(np.array(x)) for x in (gj.q[0], gj.p[0],
                                                   gj.v[0], gj.lm))
    out_t = tv.vio_dead_reckon(pt, *args)
    for a, b in zip(out_t, out_j):
        _close(a, b, 1e-12)
    # noise-free preintegration reproduces the ground-truth keyframes
    np.testing.assert_allclose(out_t.p.numpy(), np.asarray(gj.p), atol=1e-3)
