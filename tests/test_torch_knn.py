"""Parity of libwave_tpu_torch.matching.knn with libwave_tpu's: the same
neighbour indices and squared distances (within 1e-12 at f64) over
several chunks, masked queries and targets, a batch of clouds against
each cloud alone, and the running top-k with ties (lower index first, as
``lax.top_k``)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the packages export the function ``knn`` over the module's name
jknn = importlib.import_module("libwave_tpu.matching.knn")
tknn = importlib.import_module("libwave_tpu_torch.matching.knn")


def _data(rng, n=200, m=777, dtype=np.float64):
    q = rng.normal(size=(n, 3)).astype(dtype) * 5
    t = rng.normal(size=(m, 3)).astype(dtype) * 5
    qm = rng.uniform(size=n) > 0.1
    tm = rng.uniform(size=m) > 0.2
    return q, qm, t, tm


def _both(fn_t, fn_j, args, **kw):
    out_t = fn_t(*(torch.as_tensor(a) for a in args), **kw)
    out_j = fn_j(*(jnp.asarray(a) for a in args), **kw)
    return out_t, out_j


@pytest.mark.parametrize("chunk", [64, 2048])
def test_nearest_neighbor(chunk, rng):
    (it, dt), (ij, dj) = _both(tknn.nearest_neighbor, jknn.nearest_neighbor,
                               _data(rng), chunk=chunk)
    qm = _data(np.random.default_rng(42))[1]
    np.testing.assert_array_equal(it.numpy()[qm], np.asarray(ij)[qm])
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-12)
    assert it.dtype == torch.int32


@pytest.mark.parametrize("chunk", [100, 2048])
def test_knn(chunk, rng):
    (it, dt), (ij, dj) = _both(tknn.knn, jknn.knn, _data(rng, m=300),
                               k=10, chunk=chunk)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-12)


def test_knn_ties_take_the_lower_index():
    # targets on a grid: many equal distances
    g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3), -1).reshape(-1, 3)
    q = g[:20] + 0.5
    args = (q, np.ones(20, bool), g, np.ones(64, bool))
    (it, dt), (ij, dj) = _both(tknn.knn, jknn.knn, args, k=8, chunk=16)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_batched_equals_single(rng):
    data = [_data(rng, n=100, m=300) for _ in range(3)]
    stacked = [torch.as_tensor(np.stack([d[k] for d in data]))
               for k in range(4)]
    ib, db = tknn.nearest_neighbor(*stacked, chunk=128)
    kb, kd = tknn.knn(*stacked, k=4, chunk=128)
    for b, d in enumerate(data):
        i1, d1 = tknn.nearest_neighbor(*(torch.as_tensor(a) for a in d),
                                       chunk=128)
        assert torch.equal(ib[b], i1) and torch.equal(db[b], d1)
        k1, kd1 = tknn.knn(*(torch.as_tensor(a) for a in d), k=4, chunk=128)
        assert torch.equal(kb[b], k1) and torch.equal(kd[b], kd1)


def test_f32_neighbours(rng):
    q, qm, t, tm = _data(rng, dtype=np.float32)
    qm[:] = True
    (it, dt), (ij, dj) = _both(tknn.nearest_neighbor, jknn.nearest_neighbor,
                               (q, qm, t, tm))
    # f32: the winner may differ only where two targets lie within the
    # distance's rounding (measured: none on this draw)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-4)
