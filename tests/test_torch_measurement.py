"""Parity of libwave_tpu_torch.containers.measurement with libwave_tpu's
MeasurementBuffer, at f64 on the same numpy inputs: every call returns a
new buffer equal to the JAX package's (times and values within 1e-12,
ids, flags and the cursor exactly), interpolated reads within 1e-9 with
``ok`` equal, masks and the stable time order exactly equal.
``get_interpolated`` takes reads of any leading shape and is held against
``jax.vmap(get_interpolated, (None, 0, None))``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.containers import measurement as jm
from libwave_tpu_torch import interop
from libwave_tpu_torch.containers import measurement as tm

_jax_get = jax.jit(jax.vmap(jm.get_interpolated, (None, 0, None)))


def same(bt, bj):
    for f in tm.MeasurementBuffer._fields:
        a, b = getattr(bt, f).numpy(), np.asarray(getattr(bj, f))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        else:
            np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype, f


def filled(rng, capacity=40, n=32, sensors=3):
    """The same records in both packages: shuffled times per sensor."""
    times = np.round(rng.uniform(0, 10, n), 3)
    sensors_ = rng.integers(0, sensors, n).astype(np.int32)
    values = rng.normal(size=(n, 4))
    bj = jm.insert_batch(jm.measurement_buffer(capacity, 4, jnp.float64),
                         jnp.asarray(times), jnp.asarray(sensors_),
                         jnp.asarray(values))
    bt = tm.insert_batch(tm.measurement_buffer(capacity, 4, torch.float64,
                                               device="cpu"),
                         torch.as_tensor(times), torch.as_tensor(sensors_),
                         torch.as_tensor(values))
    return bj, bt, times, sensors_


def test_empty_and_batch(rng):
    bj, bt, _, _ = filled(rng)
    same(bt, bj)
    assert int(tm.size(bt)) == int(jm.size(bj)) == 32
    assert bt.capacity == 40
    empty = tm.measurement_buffer(5, 2, device="cpu")
    same(empty, jm.measurement_buffer(5, 2))


def test_batch_wraps_the_ring(rng):
    bj, bt, _, _ = filled(rng, capacity=40, n=32)
    t2 = rng.uniform(20, 30, 16)
    s2 = np.ones(16, np.int32)
    v2 = rng.normal(size=(16, 4))
    bj = jm.insert_batch(bj, jnp.asarray(t2), jnp.asarray(s2), jnp.asarray(v2))
    bt = tm.insert_batch(bt, torch.as_tensor(t2), torch.as_tensor(s2),
                         torch.as_tensor(v2))
    same(bt, bj)
    assert int(bt.cursor) == 8


def test_insert_overwrites_erase(rng):
    bj, bt, times, sensors = filled(rng)
    steps = [(times[3], sensors[3], rng.normal(size=4)),  # existing key
             (11.5, 2, rng.normal(size=4)),  # new key
             (11.5, 1, rng.normal(size=4))]  # same time, other sensor
    for t, s, v in steps:
        bj = jm.insert(bj, t, s, jnp.asarray(v))
        bt = tm.insert(bt, t, s, torch.as_tensor(v))
        same(bt, bj)
    for t, s in ((times[5], sensors[5]), (99.0, 0), (11.5, 1)):
        bj = jm.erase(bj, t, s)
        bt = tm.erase(bt, t, s)
        same(bt, bj)
    assert int(tm.size(bt)) == int(jm.size(bj))


def test_interpolated_reads(rng):
    bj, bt, times, sensors = filled(rng)
    reads = np.concatenate([times[:6], rng.uniform(-1, 11, 40)])
    for s in range(4):  # sensor 3 has no records: ok False everywhere
        vj, okj = _jax_get(bj, jnp.asarray(reads), s)
        vt, okt = tm.get_interpolated(bt, torch.as_tensor(reads), s)
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                                   atol=1e-9)
    # an exact record reads back exactly
    v, ok = tm.get_interpolated(bt, times[0], int(sensors[0]))
    assert bool(ok) and v.shape == (4,)
    np.testing.assert_array_equal(v.numpy(), bt.values[0].numpy())


def test_reads_of_any_shape_and_in_chunks(rng, monkeypatch):
    bj, bt, times, _ = filled(rng)
    reads = rng.uniform(0, 10, (3, 5, 7))
    vj, okj = _jax_get(bj, jnp.asarray(reads.reshape(-1)), 1)
    monkeypatch.setattr(tm, "_SWEEP_ELEMENTS", 40 * 9)  # chunks of 9 reads
    vt, okt = tm.get_interpolated(bt, torch.as_tensor(reads), 1)
    assert vt.shape == (3, 5, 7, 4) and okt.shape == (3, 5, 7)
    np.testing.assert_array_equal(okt.reshape(-1).numpy(), np.asarray(okj))
    np.testing.assert_allclose(vt.reshape(-1, 4).numpy(), np.asarray(vj),
                               rtol=0, atol=1e-9)


def test_masks_and_sorted_indices(rng):
    bj, bt, _, _ = filled(rng)
    bj = jm.insert(bj, 5.0, 0, jnp.ones(4))
    bt = tm.insert(bt, 5.0, 0, torch.ones(4, dtype=torch.float64))
    bj = jm.insert(bj, 5.0, 1, jnp.ones(4))  # a tie in time
    bt = tm.insert(bt, 5.0, 1, torch.ones(4, dtype=torch.float64))
    for mt, mj in ((tm.get_time_window(bt, 2.0, 6.5),
                    jm.get_time_window(bj, 2.0, 6.5)),
                   (tm.get_all_from_sensor(bt, 1),
                    jm.get_all_from_sensor(bj, 1)),
                   (bt.valid, bj.valid)):
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        np.testing.assert_array_equal(tm.sorted_indices(bt, mt).numpy(),
                                      np.asarray(jm.sorted_indices(bj, mj)))


def test_carried_across(rng):
    bj, _, _, _ = filled(rng)
    bt = interop.measurement_buffer_from_jax_numpy(
        jax.tree.map(np.asarray, bj), device="cpu")
    same(bt, bj)
    bt = tm.insert(bt, 1.25, 2, torch.zeros(4, dtype=torch.float64))
    same(bt, jm.insert(bj, 1.25, 2, jnp.zeros(4)))
