"""Parity of libwave_tpu_torch.matching.icp with libwave_tpu's.

The same 1,024-point synthetic scan (the JAX package's ``synthetic_scan``
seed, drawn by the port from the same integer) and its moved copy go
through both packages' ``icp_match`` at full resolution, downsampled and
multiscale. At f64: equal iteration counts, correspondences and masks,
transforms within 1e-9, LUM and Censi information within rtol 1e-6. At
f32: full resolution within 5e-6 m, a downsampled scale within 1e-4 m, the
multiscale pyramid within 1e-3 m and 2 iterations (measured 9.4e-7,
2.6e-5 and 2.2e-4 m, 13 against 14 iterations: t_eps 1e-8 lies below f32
rounding, so the last trips stop on noise); LUM within rtol 1e-5 at one
scale and 1e-3 multiscale (measured 7.0e-7, 6.5e-5), Censi within 1e-4
(measured 6.6e-5), all relative to the largest entry.
A batch of pairs equals the pairs one at a time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu import matching as jm
from libwave_tpu.geometry import so3 as jso3
from libwave_tpu.geometry.se3 import SE3 as JSE3
from libwave_tpu.matching import icp as jicp
from libwave_tpu.utils.config import ConfigError as JConfigError
from libwave_tpu_torch import matching as tm
from libwave_tpu_torch.matching import icp as ticp
from libwave_tpu_torch.utils.config import ConfigError, validate

CASES = {
    "full": dict(res=-1.0, multiscale_steps=0, max_iter=30),
    "downsampled": dict(res=0.2, multiscale_steps=0, max_iter=40),
    "multiscale": dict(res=0.2, multiscale_steps=2, max_iter=25),
}
F32_T_TOL = {"full": 5e-6, "downsampled": 1e-4, "multiscale": 1e-3}


def scan_pair(dtype=np.float64, n=1024, dx=(0.2, 0.1, 0.05),
              drot=(0.0, 0.0, 0.03), seed_key=0):
    key = jax.random.key(seed_key)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    scan = tm.synthetic_scan(seed, n=n, dtype=torch.float64,
                             device="cpu").points.numpy()
    T = JSE3(q=jso3.exp_quat(jnp.asarray(drot, jnp.float64)),
             t=jnp.asarray(dx, jnp.float64))
    tgt = np.asarray(T.apply(jnp.asarray(scan)))
    return scan.astype(dtype), tgt.astype(dtype)


def run_both(a, b, params):
    rj = jax.jit(lambda r, t: jm.icp_match(jm.make_cloud(r), jm.make_cloud(t),
                                           jm.ICPParams(**params)))(
        jnp.asarray(a), jnp.asarray(b))
    rt = tm.icp_match(tm.make_cloud(torch.as_tensor(a)),
                      tm.make_cloud(torch.as_tensor(b)),
                      tm.ICPParams(**params))
    return rj, rt


@pytest.fixture(scope="module")
def results():
    out = {}
    for dtype in (np.float64, np.float32):
        a, b = scan_pair(dtype)
        for name, params in CASES.items():
            out[dtype, name] = run_both(a, b, params)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_icp_f64(name, results):
    rj, rt = results[np.float64, name]
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_array_equal(rt.correspondences.numpy(),
                                  np.asarray(rj.correspondences))
    np.testing.assert_array_equal(rt.corr_valid.numpy(),
                                  np.asarray(rj.corr_valid))
    np.testing.assert_array_equal(rt.ref_ds.mask.numpy(),
                                  np.asarray(rj.ref_ds.mask))
    for a, b in zip(rt.transform, rj.transform):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9)
    assert bool(rt.converged) and bool(rj.converged)


@pytest.mark.parametrize("name", list(CASES))
def test_icp_f32(name, results):
    rj, rt = results[np.float32, name]
    assert rt.transform.t.dtype == torch.float32
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 2
    np.testing.assert_allclose(rt.transform.t.numpy(),
                               np.asarray(rj.transform.t), rtol=0,
                               atol=F32_T_TOL[name])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", list(CASES))
def test_information(dtype, name, results):
    rj, rt = results[dtype, name]
    lum_j = np.asarray(jax.jit(jicp.estimate_info_lum)(rj))
    lum_t = ticp.estimate_info_lum(rt).numpy()
    params = dict(CASES[name], covar_estimator="CENSI")
    cen_j = np.asarray(jax.jit(lambda r: jicp.estimate_info_censi(
        r, jm.ICPParams(**params)))(rj))
    cen_t = tm.estimate_info_censi(rt, tm.ICPParams(**params))
    assert cen_t.dtype == torch.float64 if dtype == np.float64 \
        else cen_t.dtype == torch.float32
    cen_t = cen_t.numpy()
    if dtype == np.float64:
        lum_tol, cen_tol = 1e-6, 1e-6
    else:
        lum_tol = 1e-5 if name != "multiscale" else 1e-3
        cen_tol = 1e-4
    for got, ref, tol in ((lum_t, lum_j, lum_tol), (cen_t, cen_j, cen_tol)):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=tol * np.abs(ref).max())
        assert (np.linalg.eigvalsh(got.astype(np.float64)) > 0).all()


def test_estimate_info_dispatch(results):
    _, rt = results[np.float64, "full"]
    p = tm.ICPParams(covar_estimator="LUMold")
    assert torch.equal(ticp.estimate_info(rt, p), ticp.estimate_info_lum(rt))
    p = tm.ICPParams(covar_estimator="CENSI")
    assert torch.equal(ticp.estimate_info(rt, p),
                       ticp.estimate_info_censi(rt, p))


def test_batched_pairs_equal_one_at_a_time():
    pairs = [scan_pair(n=512, dx=(0.1 * k, 0.05, 0.0), drot=(0, 0, 0.01 * k))
             for k in range(3)]
    params = tm.ICPParams(**CASES["multiscale"])
    refs = tm.make_cloud(torch.as_tensor(np.stack([p[0] for p in pairs])))
    tgts = tm.make_cloud(torch.as_tensor(np.stack([p[1] for p in pairs])))
    batched = tm.multi_match(refs, tgts, params)
    lum = tm.estimate_info_lum(batched)
    cen = tm.estimate_info_censi(batched, params)
    for k, (a, b) in enumerate(pairs):
        one = tm.icp_match(tm.make_cloud(torch.as_tensor(a)),
                           tm.make_cloud(torch.as_tensor(b)), params)
        assert int(one.iterations) == int(batched.iterations[k])
        assert torch.equal(one.correspondences, batched.correspondences[k])
        np.testing.assert_allclose(batched.transform.t[k].numpy(),
                                   one.transform.t.numpy(), atol=1e-12)
        np.testing.assert_allclose(lum[k].numpy(),
                                   tm.estimate_info_lum(one).numpy(),
                                   rtol=1e-9)
        np.testing.assert_allclose(
            cen[k].numpy(), tm.estimate_info_censi(one, params).numpy(),
            rtol=1e-6)


def test_params_validate_and_sharded_is_not_ported():
    for bad in (dict(max_iter=0), dict(covar_estimator="nope")):
        with pytest.raises(ConfigError):
            validate(tm.ICPParams(**bad))
        with pytest.raises(JConfigError):
            jm.ICPParams(**bad).validate()
    assert tm.ICPParams() == tm.ICPParams(**{
        f: getattr(jm.ICPParams(), f)
        for f in jm.ICPParams.__dataclass_fields__})
    # multi_match_sharded (a stub that raised before the distributed
    # layer was ported) keeps the reference's error: the batch must divide
    # the ranks of the axis (a 2-rank axis, checked before any collective)
    from libwave_tpu_torch.parallel.mesh import Axis, Mesh

    mesh = Mesh(np.arange(2), ("dp",), torch.device("cpu"), None,
                {"dp": Axis("dp", 2, 0)})
    a, b = scan_pair(n=64)
    refs = tm.make_cloud(torch.as_tensor(np.stack([a] * 3)))
    tgts = tm.make_cloud(torch.as_tensor(np.stack([b] * 3)))
    with pytest.raises(ValueError, match="divisible"):
        tm.multi_match_sharded(refs, tgts, mesh)
