"""The port's matcher (``libwave_tpu_torch.vision.matcher``) against the JAX
package's, from the same numpy inputs.

Tolerances: the ratio test, the distance heuristic (with and without cross
check) and ``match_descriptors`` without outlier removal give exactly equal
``idx2``/``valid`` (integer distances, first-occurrence ties in both); the
8-point F agrees at f64 to rtol 1e-8 once normalized by its norm and sign
(two LAPACK eigensolvers); RANSAC and LMedS, fed the JAX package's own
sample indices, give the same inlier masks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.geometry import so3 as jso3
from libwave_tpu.vision import descriptor as js
from libwave_tpu.vision import detector as jd
from libwave_tpu.vision import matcher as jm
from libwave_tpu.vision.camera import pinhole_project
from libwave_tpu_torch import interop
from libwave_tpu_torch.utils.config import ConfigError, validate
from libwave_tpu_torch.vision import matcher as tm
from test_torch_detector import IMAGES


@jax.jit
def _jax_bank(img):
    xy, _, m = jd.detect_fast(img, jd.FASTParams(num_features=64))
    desc, _ = js.brisk_describe(img, xy, m)
    return xy, desc, m


@pytest.fixture(scope="module")
def banks():
    """The JAX package's banks of a blob image and its shifted copy, as
    numpy, with a few masked rows on each side."""
    out = []
    for name in ("blobs0", "blobs0_shifted"):
        xy, desc, m = (np.array(x) for x in _jax_bank(jnp.asarray(IMAGES[name])))
        m[::9] = False
        out.append((xy, desc, m))
    return out


def _torch_bank(xy, desc, m):
    return (torch.from_numpy(xy), interop.desc_from_numpy(desc, "cpu"),
            torch.from_numpy(m))


def test_distance_matrix_ratio_and_heuristic_exact(banks):
    (xy1, d1, m1), (xy2, d2, m2) = banks
    dj = jm.hamming_distance_matrix(jnp.asarray(d1), jnp.asarray(d2),
                                    jnp.asarray(m1), jnp.asarray(m2))
    _, t1, tm1 = _torch_bank(xy1, d1, m1)
    _, t2, tm2 = _torch_bank(xy2, d2, m2)
    dt = tm.hamming_distance_matrix(t1, t2, tm1, tm2)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    # a few tied rows: duplicate reference rows
    dj2 = jnp.concatenate([dj, dj[:, :10]], axis=1)
    dt2 = torch.cat([dt, dt[:, :10]], dim=1)
    for ratio in (0.8, 1.0):
        for a, b in zip(tm.match_ratio_test(dt2, ratio),
                        jm.match_ratio_test(dj2, ratio)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for thr, cross in ((5.0, False), (5.0, True), (2.0, True), (50.0, False)):
        for a, b in zip(tm.match_distance_heuristic(dt2, thr, cross),
                        jm.match_distance_heuristic(dj2, thr, cross)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mp", [
    jm.MatcherParams(auto_remove_outliers=False),
    jm.MatcherParams(auto_remove_outliers=False, use_fused_top2=True),
    jm.MatcherParams(auto_remove_outliers=False, use_knn=False),
    jm.MatcherParams(auto_remove_outliers=False, use_knn=False,
                     cross_check=True),
], ids=["knn-matrix", "knn-fused", "heuristic", "heuristic-cross"])
def test_match_descriptors_exact(banks, mp):
    (xy1, d1, m1), (xy2, d2, m2) = banks
    ij, vj, diag_j = jm.match_descriptors(
        *(jnp.asarray(a) for a in (d1, d2, xy1, xy2, m1, m2)),
        jax.random.key(0), mp,
    )
    it, vt, diag_t = tm.match_descriptors(
        *_torch_bank(xy1, d1, m1)[1:2], *_torch_bank(xy2, d2, m2)[1:2],
        torch.from_numpy(xy1), torch.from_numpy(xy2), torch.from_numpy(m1),
        torch.from_numpy(m2), None, interop.params_from_jax(mp),
    )
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    for k in diag_j:
        assert int(diag_t[k]) == int(diag_j[k]), k
    assert int(diag_t["num_good_matches"]) >= 10


def _two_view(dtype):
    """``tests/test_vision.py``'s two-view geometry with parallax: 60 points,
    15 of them corrupted in the second view."""
    rng = np.random.default_rng(3)
    n = 60
    X = np.stack([rng.uniform(-5, 5, n), rng.uniform(-4, 4, n),
                  rng.uniform(6, 20, n)], axis=-1)
    K = jnp.asarray([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    q2 = jso3.exp_quat(jnp.asarray([0.02, -0.05, 0.01]))
    uv1, _ = pinhole_project(K, jso3.quat_identity((), jnp.float64),
                             jnp.zeros(3), jnp.asarray(X))
    uv2, _ = pinhole_project(K, q2, jnp.asarray([1.0, 0.2, 0.1]), jnp.asarray(X))
    uv1, uv2 = np.array(uv1), np.array(uv2)
    outliers = rng.choice(n, 15, replace=False)
    uv2[outliers] += rng.uniform(15, 60, (15, 2)) * rng.choice([-1, 1], (15, 2))
    valid = np.ones(n, bool)
    valid[[4, 17]] = False
    return uv1.astype(dtype), uv2.astype(dtype), valid, outliers


_jax_ransac = jax.jit(jm.find_fundamental_ransac,
                      static_argnames=("reproj_px", "lmeds"))
_jax_eight_point = jax.jit(jm._eight_point)


@jax.jit
def _jax_samples(key, valid, dtype_like):
    """The (256, 8) indices ``libwave_tpu.vision.matcher.find_fundamental_ransac``
    draws from ``key`` (matcher.py:209-217)."""
    def sample(k):
        g = jax.random.gumbel(k, (valid.shape[0],), dtype=dtype_like.dtype)
        return jax.lax.top_k(jnp.where(valid, g, -jnp.inf), 8)[1]

    return jax.vmap(sample)(jax.random.split(key, 256))


def _normalized(F):
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F)
    return F * np.sign(F.flat[np.argmax(np.abs(F))])


def test_eight_point_f64():
    uv1, uv2, _, outliers = _two_view(np.float64)
    clean = np.setdiff1d(np.arange(len(uv1)), outliers)
    rng = np.random.default_rng(4)
    w = rng.uniform(0.5, 2.0, len(uv1))
    for p1, p2, ww in ((uv1[clean], uv2[clean], w[clean]), (uv1, uv2, w),
                       (uv1[:8], uv2[:8], np.ones(8))):
        Fj = _jax_eight_point(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(ww))
        Ft = tm._eight_point(torch.from_numpy(p1), torch.from_numpy(p2),
                             torch.from_numpy(ww))
        np.testing.assert_allclose(_normalized(Ft.numpy()), _normalized(Fj),
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(
            tm._sampson_distance(Ft, torch.from_numpy(p1), torch.from_numpy(p2)).numpy(),
            np.asarray(jm._sampson_distance(Fj, jnp.asarray(p1), jnp.asarray(p2))),
            rtol=1e-6, atol=1e-12,
        )


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("lmeds", [False, True])
def test_ransac_and_lmeds_same_inliers(dtype, lmeds):
    uv1, uv2, valid, outliers = _two_view(dtype)
    key = jax.random.key(1)
    reproj = 1.5
    _, inl_j = _jax_ransac(
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid), key,
        reproj_px=reproj, lmeds=lmeds,
    )
    idx = np.array(_jax_samples(key, jnp.asarray(valid), jnp.zeros((), dtype)))
    _, inl_t = tm.find_fundamental_ransac(
        torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(valid),
        reproj_px=reproj, lmeds=lmeds, sample_idx=torch.from_numpy(idx),
    )
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert not inl_t.numpy()[outliers].any() and inl_t.numpy().sum() >= 40


def test_ransac_generator_samples_rejects_outliers():
    """The port's own sampling (a torch.Generator) finds the same geometry."""
    uv1, uv2, valid, outliers = _two_view(np.float64)
    g = torch.Generator().manual_seed(0)
    idx = tm.ransac_samples(torch.from_numpy(valid), 256, g, torch.float64)
    assert idx.shape == (256, 8)
    assert torch.from_numpy(valid)[idx].all()
    _, inl = tm.find_fundamental_ransac(
        torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(valid),
        torch.Generator().manual_seed(0), reproj_px=1.5,
    )
    clean = np.setdiff1d(np.flatnonzero(valid), outliers)
    assert inl.numpy()[clean].sum() >= len(clean) - 2
    assert inl.numpy()[outliers].sum() <= 2


def test_nanmedian_midpoint_is_numpy_rule():
    x = torch.tensor([[3.0, float("nan"), 1.0, 4.0, 2.0],
                      [5.0, 1.0, float("nan"), float("nan"), 2.0],
                      [float("nan")] * 5])
    got = tm._nanmedian_midpoint(x).numpy()
    np.testing.assert_array_equal(got[:2], np.nanmedian(x.numpy()[:2], axis=1))
    assert np.isnan(got[2])


def test_params_defaults_validation_and_lsh(banks):
    """Defaults and checks; ``method="lsh"`` runs and, without outlier
    removal, gives the JAX package's matches on the frame banks exactly
    (``tests/test_torch_flann.py`` holds the index itself)."""
    assert dataclasses.asdict(jm.MatcherParams()) == dataclasses.asdict(
        tm.MatcherParams())
    for bad in (tm.MatcherParams(ratio_threshold=1.5),
                tm.MatcherParams(fm_method="7point-nope"),
                tm.MatcherParams(distance_threshold=-1.0),
                tm.MatcherParams(method="kdtree")):
        with pytest.raises(ConfigError):
            validate(bad)
    (xy1, d1, m1), (xy2, d2, m2) = banks
    jp = jm.MatcherParams(method="lsh", auto_remove_outliers=False)
    ij, vj, dj = jm.match_descriptors(d1, d2, xy1, xy2, m1, m2,
                                      jax.random.key(0), jp)
    it, vt, dt = tm.match_descriptors(
        *_torch_bank(xy1, d1, m1)[1:2], *_torch_bank(xy2, d2, m2)[1:2],
        torch.from_numpy(xy1), torch.from_numpy(xy2), torch.from_numpy(m1),
        torch.from_numpy(m2), None, interop.params_from_jax(jp))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt["num_candidates"].numpy(),
                                  np.asarray(dj["num_candidates"]))
    assert int(dt["num_good_matches"]) == int(dj["num_good_matches"]) > 0
