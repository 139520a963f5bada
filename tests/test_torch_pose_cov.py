"""Parity of libwave_tpu_torch.geometry.{frames,pose_cov} with
libwave_tpu's, at f64 on the same numpy inputs within 1e-9 (the frame maps
exactly: they permute and negate), and the frames and pose-covariance
cases of tests/test_geometry.py on the port (Jacobians by
``torch.func.jacfwd`` where the JAX test takes ``jax.jacobian``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.geometry import frames as jfr
from libwave_tpu.geometry import pose_cov as jpc
from libwave_tpu.geometry.se3 import SE3 as JSE3
from libwave_tpu_torch.geometry import frames as tfr
from libwave_tpu_torch.geometry import pose_cov as tpc
from libwave_tpu_torch.geometry import se3
from libwave_tpu_torch.geometry.se3 import SE3


def t64(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def close(t, j, atol=1e-9):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0,
                               atol=atol)


def random_pair(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[q[:, 0] < 0] *= -1
    t = rng.normal(size=(n, 3))
    return JSE3(q=jnp.asarray(q), t=jnp.asarray(t)), SE3(q=t64(q), t=t64(t))


def random_cov(rng, n):
    A = rng.normal(size=(n, 6, 6))
    return 0.01 * A @ np.swapaxes(A, -1, -2)


@pytest.mark.parametrize("name", ["enu2nwu", "nwu2enu", "ned2enu", "nwu2edn",
                                  "ned2nwu_quat", "nwu2ned_quat"])
def test_frame_maps_match_jax(rng, name):
    v = rng.normal(size=(7, 4 if "quat" in name else 3))
    np.testing.assert_array_equal(getattr(tfr, name)(t64(v)).numpy(),
                                  np.asarray(getattr(jfr, name)(
                                      jnp.asarray(v))))


def test_frames_cases(rng):
    """tests/test_geometry.py TestFrames on the port."""
    v = t64(rng.normal(size=(6, 3)))
    close(tfr.nwu2enu(tfr.enu2nwu(v)), v)
    close(tfr.ned2enu(tfr.ned2enu(v)), v)
    close(tfr.enu2nwu(t64([1.0, 0, 0])), [0, -1, 0])
    close(tfr.nwu2edn(t64([1.0, 0, 0])), [0, 0, 1])
    q = t64(rng.normal(size=(5, 4)))
    close(tfr.nwu2ned_quat(tfr.ned2nwu_quat(q)), q, atol=0.0)


def test_compose_matches_jax(rng):
    (j1, t1), (j2, t2) = random_pair(rng, 3), random_pair(rng, 3)
    S1, S2 = random_cov(rng, 3), random_cov(rng, 3)
    oj = jpc.compose_pose_with_covariance(jpc.PoseWithCovariance(j1, S1),
                                          jpc.PoseWithCovariance(j2, S2))
    ot = tpc.compose_pose_with_covariance(
        tpc.PoseWithCovariance(t1, t64(S1)),
        tpc.PoseWithCovariance(t2, t64(S2)))
    close(ot.pose.q, oj.pose.q)
    close(ot.pose.t, oj.pose.t)
    close(ot.cov, oj.cov)
    # tests/test_geometry.py test_compose_cov_propagation
    Ad = se3.adjoint(t2.inverse())
    close(ot.cov, Ad @ t64(S1) @ Ad.transpose(-1, -2) + t64(S2), atol=1e-12)
    assert (np.linalg.eigvalsh(ot.cov.numpy()) > -1e-10).all()


def test_compose_chain_matches_jax(rng):
    """A chain of compositions (chip_smoke.py's leaves phase at 50 steps)."""
    (jp, tp) = random_pair(rng, 1)
    steps = [random_pair(rng, 1) for _ in range(50)]
    covs = 1e-4 * random_cov(rng, 50)
    aj = jpc.PoseWithCovariance.certain(jp)
    at = tpc.PoseWithCovariance.certain(tp)
    for (js, ts), c in zip(steps, covs):
        aj = jpc.compose_pose_with_covariance(
            aj, jpc.PoseWithCovariance(js, jnp.asarray(c[None])))
        at = tpc.compose_pose_with_covariance(
            at, tpc.PoseWithCovariance(ts, t64(c[None])))
    close(at.pose.t, aj.pose.t)
    close(at.cov, aj.cov)


def test_compose_jacobian_matches_autodiff(rng):
    """The closed-form propagation against the Jacobian of the composition
    map (tests/test_geometry.py's oracle, forward mode)."""
    _, T1 = random_pair(rng, 1)
    _, T2 = random_pair(rng, 1)
    T1, T2 = SE3(q=T1.q[0], t=T1.t[0]), SE3(q=T2.q[0], t=T2.t[0])
    z = torch.zeros(6, dtype=torch.float64)

    def perturbed(e1, e2):
        return se3.boxminus(se3.boxplus(T1, e1).compose(se3.boxplus(T2, e2)),
                            T1.compose(T2))

    J1 = torch.func.jacfwd(perturbed, argnums=0)(z, z)
    J2 = torch.func.jacfwd(perturbed, argnums=1)(z, z)
    close(J1, se3.adjoint(T2.inverse()), atol=1e-6)
    close(J2, np.eye(6), atol=1e-6)


def test_transform_point_matches_jax(rng):
    (jT, tT) = random_pair(rng, 4)
    x = rng.normal(size=(4, 3))
    S = random_cov(rng, 4)
    xc = 0.01 * np.eye(3) * rng.uniform(0.5, 2.0, (4, 1, 1))
    pj = jpc.PoseWithCovariance(jT, jnp.asarray(S))
    pt = tpc.PoseWithCovariance(tT, t64(S))
    for cov in (None, xc):
        yj, cj = jpc.transform_point_with_covariance(
            pj, jnp.asarray(x), None if cov is None else jnp.asarray(cov))
        yt, ct = tpc.transform_point_with_covariance(
            pt, t64(x), None if cov is None else t64(cov))
        close(yt, yj)
        close(ct, cj)
    # tests/test_geometry.py test_transform_point_cov: the Jacobian oracle
    T0 = SE3(q=tT.q[0], t=tT.t[0])
    _, c0 = tpc.transform_point_with_covariance(
        tpc.PoseWithCovariance(T0, 0.01 * torch.eye(6, dtype=torch.float64)),
        t64(x[0]))
    J = torch.func.jacfwd(lambda e: se3.boxplus(T0, e).apply(t64(x[0])))(
        torch.zeros(6, dtype=torch.float64))
    close(c0, 0.01 * J @ J.T)


def test_monte_carlo(rng):
    """Sampled composition statistics match the propagated covariance."""
    (_, T1), (_, T2) = random_pair(rng, 1), random_pair(rng, 1)
    T1, T2 = SE3(q=T1.q[0], t=T1.t[0]), SE3(q=T2.q[0], t=T2.t[0])
    s1, s2 = 0.02, 0.015
    eye = torch.eye(6, dtype=torch.float64)
    out = tpc.compose_pose_with_covariance(
        tpc.PoseWithCovariance(T1, s1 ** 2 * eye),
        tpc.PoseWithCovariance(T2, s2 ** 2 * eye))
    n = 20000
    e1 = t64(rng.normal(size=(n, 6))) * s1
    e2 = t64(rng.normal(size=(n, 6))) * s2
    errs = se3.boxminus(se3.boxplus(T1, e1).compose(se3.boxplus(T2, e2)),
                        out.pose)
    close(torch.einsum("ni,nj->ij", errs, errs) / n, out.cov, atol=3e-4)


def test_certain_is_zero_cov(rng):
    _, T = random_pair(rng, 3)
    p = tpc.PoseWithCovariance.certain(T)
    assert p.cov.shape == (3, 6, 6) and not p.cov.any()
