"""Parity of libwave_tpu_torch.matching.gicp and .ndt with libwave_tpu's.

The 1,024-point scan pair of ``test_torch_icp.py`` through both packages'
``gicp_match`` and ``ndt_match``. At f64: equal iteration counts,
transforms within 1e-9, the GICP covariances and the NDT grid (keys,
masks, means within 1e-12, inverse covariances within rtol 1e-9). At f32:
equal iterations, GICP within 1e-4 m and NDT within 2e-5 m (measured
1.2e-5 and 1.6e-6 m). A batch of pairs equals the pairs one at a time.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu import matching as jm
from libwave_tpu.matching import gicp as jgicp
from libwave_tpu_torch import matching as tm
from libwave_tpu_torch.matching import gicp as tgicp
from libwave_tpu_torch.utils.config import ConfigError, validate
from test_torch_icp import scan_pair

jndt = importlib.import_module("libwave_tpu.matching.ndt")
tndt = importlib.import_module("libwave_tpu_torch.matching.ndt")

MATCHERS = {
    "gicp": (jm.gicp_match, tm.gicp_match,
             dict(res=0.2, max_iter=30), jm.GICPParams, tm.GICPParams),
    "ndt": (jm.ndt_match, tm.ndt_match,
            dict(res=2.0, max_iter=40), jm.NDTParams, tm.NDTParams),
}
F32_T_TOL = {"gicp": 1e-4, "ndt": 2e-5}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", list(MATCHERS))
def test_matcher(name, dtype):
    jf, tf, params, jP, tP = MATCHERS[name]
    a, b = scan_pair(dtype)
    rj = jax.jit(lambda r, t: jf(jm.make_cloud(r), jm.make_cloud(t),
                                 jP(**params)))(jnp.asarray(a), jnp.asarray(b))
    rt = tf(tm.make_cloud(torch.as_tensor(a)),
            tm.make_cloud(torch.as_tensor(b)), tP(**params))
    assert int(rt.iterations) == int(rj.iterations)
    assert bool(rt.converged) == bool(rj.converged)
    tol = 1e-9 if dtype == np.float64 else F32_T_TOL[name]
    np.testing.assert_allclose(rt.transform.t.numpy(),
                               np.asarray(rj.transform.t), rtol=0, atol=tol)
    np.testing.assert_allclose(rt.transform.q.numpy(),
                               np.asarray(rj.transform.q), rtol=0, atol=tol)
    if name == "ndt":
        assert torch.equal(rt.information,
                           torch.eye(6, dtype=rt.information.dtype))


def test_gicp_covariances_f64():
    a, _ = scan_pair()
    cj = jm.voxel_downsample(jm.make_cloud(jnp.asarray(a)), 0.2)
    ct = tm.voxel_downsample(tm.make_cloud(torch.as_tensor(a)), 0.2)
    Cj = np.asarray(jgicp._point_covariances(cj, 10, 1e-3))
    Ct = tgicp._point_covariances(ct, 10, 1e-3).numpy()
    m = ct.mask.numpy()
    np.testing.assert_allclose(Ct[m], Cj[m], atol=1e-9)


@pytest.mark.parametrize("res", [1.0, 2.0])
def test_ndt_grid_f64(res):
    a, _ = scan_pair()
    mask = np.random.default_rng(3).uniform(size=len(a)) > 0.05
    gj = jndt.build_ndt_grid(jm.make_cloud(jnp.asarray(a), jnp.asarray(mask)),
                             res)
    gt = tndt.build_ndt_grid(tm.make_cloud(torch.as_tensor(a),
                                           torch.as_tensor(mask)), res)
    np.testing.assert_array_equal(gt.keys.numpy(), np.asarray(gj.keys))
    np.testing.assert_array_equal(gt.valid.numpy(), np.asarray(gj.valid))
    v = gt.valid.numpy()
    np.testing.assert_allclose(gt.means.numpy()[v], np.asarray(gj.means)[v],
                               atol=1e-12)
    ij = np.asarray(gj.inv_covs)[v]
    np.testing.assert_allclose(gt.inv_covs.numpy()[v], ij, rtol=0,
                               atol=1e-9 * np.abs(ij).max())
    pts = a[:200] + 0.3
    for x, y in zip(tndt._lookup(gt, torch.as_tensor(pts), res),
                    jndt._lookup(gj, jnp.asarray(pts), res)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("name", list(MATCHERS))
def test_batched_pairs_equal_one_at_a_time(name):
    _, tf, params, _, tP = MATCHERS[name]
    pairs = [scan_pair(n=512, dx=(0.1 * k, 0.05, 0.0), drot=(0, 0, 0.01 * k))
             for k in range(3)]
    batched = tf(tm.make_cloud(torch.as_tensor(np.stack([p[0] for p in pairs]))),
                 tm.make_cloud(torch.as_tensor(np.stack([p[1] for p in pairs]))),
                 tP(**params))
    for k, (a, b) in enumerate(pairs):
        one = tf(tm.make_cloud(torch.as_tensor(a)),
                 tm.make_cloud(torch.as_tensor(b)), tP(**params))
        assert int(one.iterations) == int(batched.iterations[k])
        np.testing.assert_allclose(batched.transform.t[k].numpy(),
                                   one.transform.t.numpy(), atol=1e-12)


def test_params():
    with pytest.raises(ConfigError):
        validate(tm.GICPParams(k_neighbors=2))
    with pytest.raises(ConfigError):
        validate(tm.NDTParams(res=0.01))
    with pytest.raises(ConfigError):
        validate(tm.NDTParams(max_iter=0))
    for jP, tP in ((jm.GICPParams, tm.GICPParams),
                   (jm.NDTParams, tm.NDTParams)):
        assert tP() == tP(**{f: getattr(jP(), f)
                             for f in jP.__dataclass_fields__})
