"""The port's landmark container (``libwave_tpu_torch.containers.landmark``)
against the JAX package's: the same operations from the same numpy inputs
give exactly equal buffers, leaf by leaf, including ring wrap-around at
capacity and masked rows in batched inserts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from libwave_tpu.containers import landmark as jl
from libwave_tpu_torch import interop
from libwave_tpu_torch.containers import landmark as tl


def _assert_buf_equal(tb, jb):
    for f in jl.LandmarkBuffer._fields:
        np.testing.assert_array_equal(
            getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), err_msg=f
        )


def _batch(rng, n, t0, masked_share):
    times = (t0 + np.arange(n) * 0.5).astype(np.float32)
    sensors = rng.integers(0, 2, n).astype(np.int32)
    ids = rng.integers(0, 9, n).astype(np.int32)
    images = rng.integers(0, 6, n).astype(np.int32)
    values = rng.standard_normal((n, 2)).astype(np.float32)
    mask = rng.random(n) >= masked_share
    return times, sensors, ids, images, values, mask


_jax_insert_batch = jax.jit(jl.insert_landmark_batch)
_jax_get_ids = jax.jit(jl.get_landmark_ids, static_argnums=1)
_jax_get_track = jax.jit(jl.get_track, static_argnums=3)


def test_batched_inserts_wrap_and_masks():
    rng = np.random.default_rng(0)
    bj = jl.landmark_buffer(13)
    bt = tl.landmark_buffer(13, device="cpu")
    _assert_buf_equal(bt, bj)
    # masked rows in the middle, at the end, all masked; then enough valid
    # rows to wrap the 13-slot ring twice
    for i, share in enumerate((0.4, 0.0, 1.0, 0.5, 0.2, 0.0)):
        times, sensors, ids, images, values, mask = _batch(rng, 8, 10.0 * i, share)
        mask[-1] = share < 1.0 and not mask[-1]  # a trailing masked row
        bj = _jax_insert_batch(
            bj, jnp.asarray(times), jnp.asarray(sensors), jnp.asarray(ids),
            jnp.asarray(images), jnp.asarray(values), mask=jnp.asarray(mask),
        )
        bt = tl.insert_landmark_batch(
            bt, torch.as_tensor(times), torch.as_tensor(sensors),
            torch.as_tensor(ids), torch.as_tensor(images),
            torch.as_tensor(values), mask=torch.as_tensor(mask),
        )
        _assert_buf_equal(bt, bj)
    assert int(bt.cursor) != 0 and int(tl.landmark_size(bt)) == 13
    # no mask: every row real
    times, sensors, ids, images, values, _ = _batch(rng, 5, 99.0, 0.0)
    bj = jl.insert_landmark_batch(bj, times, sensors, ids, images, values)
    bt = tl.insert_landmark_batch(bt, torch.as_tensor(times), sensors, ids,
                                  images, values)
    _assert_buf_equal(bt, bj)


def test_single_inserts_overwrite_and_wrap():
    bj = jl.landmark_buffer(4)
    bt = tl.landmark_buffer(4, device="cpu")
    rows = [(1.0, 0, 5, 0, (1.0, 2.0)), (2.0, 0, 5, 1, (3.0, 4.0)),
            (1.0, 0, 5, 0, (9.0, 9.0)),  # same key: overwrite in place
            (1.0, 1, 5, 0, (7.0, 7.0)), (3.0, 0, 6, 2, (5.0, 6.0)),
            (4.0, 0, 7, 3, (0.5, 0.5)),  # wraps the ring
            (5.0, 0, 8, 4, (0.25, 0.25))]
    for t, s, lid, img, v in rows:
        bj = jl.insert_landmark(bj, t, s, lid, img, jnp.asarray(v, jnp.float32))
        bt = tl.insert_landmark(bt, t, s, lid, img, torch.tensor(v))
        _assert_buf_equal(bt, bj)
    assert int(tl.landmark_size(bt)) == int(jl.landmark_size(bj)) == 4


def test_queries_equal():
    rng = np.random.default_rng(1)
    bj = jl.landmark_buffer(40)
    for i in range(4):
        args = _batch(rng, 12, 12.0 * i, 0.3)
        bj = _jax_insert_batch(bj, *(jnp.asarray(a) for a in args[:5]),
                               mask=jnp.asarray(args[5]))
    bt = interop.landmark_buffer_from_jax_numpy(
        jl.LandmarkBuffer(*(np.asarray(x) for x in bj)), "cpu"
    )
    _assert_buf_equal(bt, bj)
    times = np.asarray(bj.times)[np.asarray(bj.valid)]
    for t, s, lid in [(float(times[3]), 0, 2), (float(times[3]), 1, 3),
                      (float(times[7]), 1, 8), (-5.0, 0, 1)]:
        vj, okj = jl.get_exact(bj, t, s, lid)
        vt, okt = tl.get_exact(bt, t, s, lid)
        assert bool(okt) == bool(okj)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    for window in ((None, None), (15.0, 30.0), (100.0, 101.0)):
        for max_ids in (3, 12):
            oj, cj = _jax_get_ids(bj, max_ids, *window)
            ot, ct = tl.get_landmark_ids(bt, max_ids, *window)
            np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
            assert int(ct) == int(cj)
    for s in (0, 1):
        for lid in range(9):
            for window in ((None, None), (15.0, 30.0)):
                for a, b in zip(tl.get_track(bt, s, lid, 6, *window),
                                _jax_get_track(bj, s, lid, 6, *window)):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for cutoff in (0, 3, 9):
        _assert_buf_equal(tl.erase_older_than_image(bt, cutoff),
                          jl.erase_older_than_image(bj, cutoff))
