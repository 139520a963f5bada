"""Parity of libwave_tpu_torch.vision.flann_float with libwave_tpu's float
FLANN indexes, on tests/test_flann.py's planted SIFT-like banks (2,048
train rows, 256 queries, 128 f32 dims, ``default_rng(42)``): the random
projections and the k-means start centroids bit for bit (the same numpy
draws), the kd keys equal, the centroids after the Lloyd iterations within
1e-5 (the port sums each cell in row order, as XLA's CPU segment sum
does), ``exact``'s indices and valid flags equal outside near ties (rows
whose best and second distances differ by at most 1e-5 of the best, in
f64), each method's recall within 0.01 of the JAX package's, and a
JAX-built index, carried across, giving the port's ``float_match`` the JAX
package's matches. Then every float case of tests/test_flann.py on the
port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.vision import flann_float as jff
from libwave_tpu_torch import bench_trajectory as bt
from libwave_tpu_torch import interop
from libwave_tpu_torch.utils.config import ConfigError
from libwave_tpu_torch.vision import flann_float as tff

METHODS = ("exact", "kdtree", "kmeans", "composite")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def banks():
    d1, d2, src = bt.planted_float(np.random.default_rng(bt.FLANN_SEED))
    return d1, d2, src


def params(method, **kw):
    return (jff.FloatIndexParams(method=method, **bt.FLANN_TEST, **kw),
            tff.FloatIndexParams(method=method, **bt.FLANN_TEST, **kw))


_jax_build = jax.jit(jff.build_float_index, static_argnums=2)
_jax_match = jax.jit(jff.float_match, static_argnums=3)


def run_both(d1, d2, method, m2=None):
    pj, pt = params(method)
    m2 = np.ones(d2.shape[0], bool) if m2 is None else m2
    m1 = np.ones(d1.shape[0], bool)
    ij = _jax_build(jnp.asarray(d2), jnp.asarray(m2), pj)
    it = tff.build_float_index(torch.as_tensor(d2), torch.as_tensor(m2), pt)
    rj = _jax_match(jnp.asarray(d1), jnp.asarray(m1), ij, pj)
    rt = tff.float_match(torch.as_tensor(d1), torch.as_tensor(m1), it, pt)
    return ij, it, rj, rt


def clear_rows(d1, d2, m2=None):
    """Rows whose f64 best and second distances differ by more than 1e-5
    of the best (ties and near ties may round either way)."""
    a, b = d1.astype(np.float64), d2.astype(np.float64)
    d = (a * a).sum(1)[:, None] + (b * b).sum(1)[None] - 2.0 * a @ b.T
    if m2 is not None:
        d = np.where(m2[None], d, np.inf)
    s = np.sort(d, axis=1)
    return s[:, 1] - s[:, 0] > 1e-5 * s[:, 0]


def test_projections_and_start_centroids_bit_equal(banks):
    _, d2, _ = banks
    pj, pt = params("composite")
    np.testing.assert_array_equal(
        tff._kd_projections(pt, 128, "cpu").numpy(),
        np.asarray(jff._kd_projections(pj, 128)))
    m2 = np.ones(d2.shape[0], bool)
    cj = jff._fit_kmeans(jnp.asarray(d2), jnp.asarray(m2), 64, 0, pj.seed)
    ct = tff._fit_kmeans(torch.as_tensor(d2), torch.as_tensor(m2), 64, 0,
                         pt.seed)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_kd_keys_and_centroids(banks):
    _, d2, _ = banks
    ij, it, _, _ = run_both(d2[:4], d2, "composite")
    np.testing.assert_allclose(it.center.numpy(), np.asarray(ij.center),
                               atol=1e-7)
    pj, pt = params("composite")
    center = np.array(ij.center)
    kj = jff._kd_keys(jnp.asarray(d2), jnp.asarray(center),
                      jff._kd_projections(pj, 128))
    kt = tff._kd_keys(torch.as_tensor(d2), torch.as_tensor(center),
                      tff._kd_projections(pt, 128, "cpu"))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_allclose(it.centroids.numpy(),
                               np.asarray(ij.centroids), atol=1e-5)
    # the bucket tables follow from keys and cells
    np.testing.assert_array_equal(it.offsets.numpy(), np.asarray(ij.offsets))
    np.testing.assert_array_equal(it.sorted_ids.numpy(),
                                  np.asarray(ij.sorted_ids))


def test_exact_equal_outside_near_ties(banks):
    d1, d2, src = banks
    _, _, (idx_j, val_j, _), (idx_t, val_t, diag) = run_both(d1, d2, "exact")
    ok = clear_rows(d1, d2)
    assert ok.mean() > 0.99
    np.testing.assert_array_equal(idx_t.numpy()[ok], np.asarray(idx_j)[ok])
    np.testing.assert_array_equal(val_t.numpy()[ok], np.asarray(val_j)[ok])
    assert idx_t.dtype == torch.int32
    assert int(diag["num_good_matches"]) == int(val_t.sum())


@pytest.mark.parametrize("method", METHODS[1:])
def test_recall_matches_jax(banks, method):
    d1, d2, src = banks
    _, _, (idx_j, _, dj), (idx_t, _, dt) = run_both(d1, d2, method)
    rec_j = float(np.mean(np.asarray(idx_j) == src))
    rec_t = float(np.mean(idx_t.numpy() == src))
    assert abs(rec_t - rec_j) <= 0.01, (rec_t, rec_j)
    assert rec_t > bt.RECALL_FLOORS[method], rec_t  # the JAX test's floor
    assert int(dt["num_candidates"].max()) < d2.shape[0]
    np.testing.assert_array_equal(dt["num_candidates"].numpy(),
                                  np.asarray(dj["num_candidates"]))


@pytest.mark.parametrize("method", METHODS)
def test_jax_built_index_queried_by_port(banks, method):
    d1, d2, _ = banks
    pj, pt = params(method)
    m = np.ones(d2.shape[0], bool)
    ij = _jax_build(jnp.asarray(d2), jnp.asarray(m), pj)
    idx_j, val_j, _ = _jax_match(jnp.asarray(d1), jnp.asarray(m[:256]), ij,
                                 pj)
    it = interop.float_index_from_jax_numpy(jax.tree.map(np.asarray, ij),
                                            device="cpu")
    idx_t, val_t, _ = tff.float_match(torch.as_tensor(d1),
                                      torch.ones(256, dtype=torch.bool),
                                      it, pt)
    ok = clear_rows(d1, d2)
    np.testing.assert_array_equal(idx_t.numpy()[ok], np.asarray(idx_j)[ok])
    np.testing.assert_array_equal(val_t.numpy()[ok], np.asarray(val_j)[ok])


def test_exact_matches_numpy_oracle(banks):
    """tests/test_flann.py test_exact_matches_numpy_oracle on the port."""
    d1, d2, src = banks
    p = tff.FloatIndexParams(method="exact")
    index = tff.build_float_index(torch.as_tensor(d2),
                                  torch.ones(2048, dtype=torch.bool), p)
    idx, valid, _ = tff.float_match(torch.as_tensor(d1),
                                    torch.ones(256, dtype=torch.bool),
                                    index, p)
    dists = ((d1 ** 2).sum(1)[:, None] + (d2 ** 2).sum(1)[None]
             - 2 * d1 @ d2.T)
    np.testing.assert_array_equal(idx.numpy(), dists.argmin(1))
    assert float(np.mean(idx.numpy() == src)) > 0.99
    assert bool(valid.any())


def test_masked_train_rows_never_match():
    """tests/test_flann.py's masked case (512 rows, 64 queries) on both."""
    d1, d2, src = bt.planted_float(np.random.default_rng(bt.FLANN_SEED),
                                   n_train=512, n_query=64)
    m2 = np.ones(d2.shape[0], bool)
    m2[src] = False
    for method in ("composite", "exact"):
        p = tff.FloatIndexParams(method=method, bucket_capacity=64)
        index = tff.build_float_index(torch.as_tensor(d2),
                                      torch.as_tensor(m2), p)
        idx, valid, _ = tff.float_match(torch.as_tensor(d1),
                                        torch.ones(64, dtype=torch.bool),
                                        index, p)
        idx, valid = idx.numpy(), valid.numpy()
        assert not np.any(idx[valid] == src[valid])
        assert not np.any(m2[idx[valid]] == 0)


def test_param_validation():
    with pytest.raises(ConfigError):
        tff.FloatIndexParams(method="kd").validate()
    with pytest.raises(ConfigError):
        tff.FloatIndexParams(key_bits=0).validate()
    with pytest.raises(ConfigError):
        tff.FloatIndexParams(ratio_threshold=0.0).validate()
    with pytest.raises(ConfigError):
        tff.build_float_index(torch.zeros(4, 8), torch.ones(4, dtype=bool),
                              tff.FloatIndexParams(num_probes=0))
    tff.FloatIndexParams().validate()
