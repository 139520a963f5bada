"""The port's two-view geometry (``libwave_tpu_torch.vision.epipolar``) and
the rest of its pinhole camera (``vision.camera``) against the JAX
package's, at f64 on the same numpy inputs.

Tolerance: 1e-9 (f64 LAPACK in both, summed in another order). The SVD's
signs are the library's choice, so ``decompose_essential``'s four
candidates are compared as a set, and ``recover_pose``'s votes as a
multiset; its winner, its pose and its inliers must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.vision import camera as jc
from libwave_tpu.vision import epipolar as je
from libwave_tpu_torch.vision import camera as tc
from libwave_tpu_torch.vision import epipolar as te

K = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1.0]])
TOL = 1e-9


def _rot(v):
    """Rotation matrix of an axis-angle vector (Rodrigues)."""
    th = np.linalg.norm(v)
    k = v / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def _scene(seed, n=80, outliers=0.0):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -2, 4], [2, 2, 9], (n, 3))
    R = _rot(rng.normal(0, 0.05, 3))
    t = rng.normal(0, 1, 3)
    t /= np.linalg.norm(t)
    X2 = X @ R.T + t
    p1 = (X @ K.T)[:, :2] / X[:, 2:]
    p2 = (X2 @ K.T)[:, :2] / X2[:, 2:]
    bad = rng.random(n) < outliers
    p2[bad] = rng.uniform(0, 700, (bad.sum(), 2))
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Kinv = np.linalg.inv(K)
    F = Kinv.T @ (tx @ R) @ Kinv
    F += rng.normal(0, 1e-12 * np.abs(F).max(), (3, 3))  # off the manifold
    valid = np.ones(n, bool)
    valid[::11] = False
    return X, R, t, p1, p2, F, valid


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_essential_decompose_triangulate_f64(seed):
    X, R, t, p1, p2, F, _ = _scene(seed)
    Ej = np.asarray(je.essential_from_fundamental(jnp.asarray(F),
                                                  jnp.asarray(K)))
    Et = te.essential_from_fundamental(_t(F), _t(K)).numpy()
    np.testing.assert_allclose(Et, Ej, rtol=0, atol=TOL * np.abs(Ej).max())
    np.testing.assert_allclose(
        te.essential_from_fundamental(_t(F), _t(K), _t(K)).numpy(), Et)

    Rj, tj = (np.asarray(a) for a in je.decompose_essential(jnp.asarray(Ej)))
    Rt, tt = (a.numpy() for a in te.decompose_essential(_t(Ej)))
    for a in (Rt, Rj):
        np.testing.assert_allclose(np.linalg.det(a), 1.0, atol=TOL)
    for i in range(4):  # the same four candidates, in any order
        gap = [max(np.abs(Rt[i] - Rj[k]).max(), np.abs(tt[i] - tj[k]).max())
               for k in range(4)]
        assert min(gap) < TOL, gap

    Kinv = np.linalg.inv(K)
    x1 = (np.c_[p1, np.ones(len(p1))] @ Kinv.T)[:, :2]
    x2 = (np.c_[p2, np.ones(len(p2))] @ Kinv.T)[:, :2]
    outs_j = je.triangulate(jnp.asarray(R), jnp.asarray(t), jnp.asarray(x1),
                            jnp.asarray(x2))
    outs_t = te.triangulate(_t(R), _t(t), _t(x1), _t(x2))
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL * 10)
    np.testing.assert_allclose(outs_t[0].numpy(), X, rtol=0, atol=1e-8)


@pytest.mark.parametrize("seed,outliers", [(0, 0.0), (3, 0.2), (4, 0.4)])
def test_recover_pose_f64(seed, outliers):
    X, R, t, p1, p2, F, valid = _scene(seed, outliers=outliers)
    E = np.asarray(je.essential_from_fundamental(jnp.asarray(F),
                                                 jnp.asarray(K)))
    Tj, gj, vj = je.recover_pose(jnp.asarray(E), jnp.asarray(p1),
                                 jnp.asarray(p2), jnp.asarray(K),
                                 jnp.asarray(valid))
    Tt, gt, vt = te.recover_pose(_t(E), _t(p1), _t(p2), _t(K), _t(valid))
    np.testing.assert_allclose(Tt.rotation().numpy(),
                               np.asarray(Tj.rotation()), rtol=0, atol=TOL)
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert sorted(vt.tolist()) == sorted(np.asarray(vj).tolist())
    # the truth, up to monocular scale
    np.testing.assert_allclose(Tt.rotation().numpy(), R, atol=1e-6)
    np.testing.assert_allclose(Tt.t.numpy(), t, atol=1e-6)


def test_camera_functions_f64():
    rng = np.random.default_rng(5)
    fov = np.array([1.1, 0.8])
    np.testing.assert_allclose(
        tc.focal_length(_t(fov), (752, 480)).numpy(),
        np.asarray(jc.focal_length(jnp.asarray(fov), (752, 480))), rtol=1e-15)
    q = rng.normal(size=(5, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p = rng.normal(size=(5, 3))
    pts = rng.normal(size=(30, 3)) * 3
    uv_j, f_j = jc.pinhole_project_frames(jnp.asarray(K), jnp.asarray(q),
                                          jnp.asarray(p), jnp.asarray(pts))
    uv_t, f_t = tc.pinhole_project_frames(_t(K), _t(q), _t(p), _t(pts))
    assert uv_t.shape == (5, 30, 2)
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-12)
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    uv = rng.uniform(0, 700, (5, 2))
    depth = rng.uniform(1, 9, 5)
    Xj = jc.backproject(jnp.asarray(K), jnp.asarray(q), jnp.asarray(p),
                        jnp.asarray(uv), jnp.asarray(depth))
    Xt = tc.backproject(_t(K), _t(q), _t(p), _t(uv), _t(depth))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0, atol=1e-12)
    # back-projected points project back to their pixels
    back, front = tc.pinhole_project(_t(K), _t(q), _t(p), Xt)
    np.testing.assert_allclose(back.numpy(), uv, atol=1e-9)
    assert front.all()
