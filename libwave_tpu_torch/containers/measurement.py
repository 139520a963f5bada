"""Time/sensor-indexed measurement table with interpolating lookup (port of
``libwave_tpu.containers.measurement``).

The reference's ``MeasurementContainer<T>``
(wave_containers/include/wave/containers/measurement_container.hpp:47;
index machinery impl/measurement_container.hpp:33-68) stores ``{time_point,
sensor_id, value}`` records in a Boost.MultiIndex with two ordered-unique
composite keys and offers:

- ``insert``/``emplace``/``erase`` keyed by (time, sensor) (unique),
- ``get(t, s)`` that linearly interpolates between the two neighbouring
  measurements of sensor ``s`` when no exact record exists,
- ``getTimeWindow(start, end)`` and ``getAllFromSensor(s)``.

Here the container is a fixed-capacity struct of tensors with a validity
mask, and every query is a masked reduction over the capacity axis. Calls
are functional: each returns a new buffer. Single-record writes select
with ``torch.where`` against the slot index, so none reads a slot number
back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libwave_tpu_torch.utils.device import resolve

_INF = float("inf")
# Interpolated reads are swept in chunks of at most this many (read, slot)
# pairs, so a large batch of reads against a large buffer stays in memory.
_SWEEP_ELEMENTS = 1 << 25


class MeasurementBuffer(NamedTuple):
    """Fixed-capacity measurement table."""

    times: torch.Tensor  # (C,) float
    sensor_ids: torch.Tensor  # (C,) int32
    values: torch.Tensor  # (C, D) float
    valid: torch.Tensor  # (C,) bool
    cursor: torch.Tensor  # () int32: next insertion slot (ring)

    @property
    def capacity(self) -> int:
        return self.times.shape[0]


def measurement_buffer(capacity: int, value_dim: int, dtype=torch.float32,
                       device=None) -> MeasurementBuffer:
    """Allocate an empty buffer on ``device`` (default: the card)."""
    device = resolve(device)
    return MeasurementBuffer(
        times=torch.full((capacity,), -_INF, dtype=dtype, device=device),
        sensor_ids=torch.full((capacity,), -1, dtype=torch.int32,
                              device=device),
        values=torch.zeros((capacity, value_dim), dtype=dtype, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        cursor=torch.zeros((), dtype=torch.int32, device=device),
    )


def size(buf: MeasurementBuffer) -> torch.Tensor:
    """Number of valid records (reference ``size()``)."""
    return torch.sum(buf.valid.to(torch.int32))


def _scalar(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def _match_slot(buf: MeasurementBuffer, t, sensor_id) -> torch.Tensor:
    """Slot index holding (t, sensor) exactly, or -1."""
    hit = buf.valid & (buf.sensor_ids == sensor_id) & (buf.times == t)
    idx = torch.argmax(hit.to(torch.int8))
    return torch.where(torch.any(hit), idx, -1).to(torch.int32)


def _slots(buf: MeasurementBuffer) -> torch.Tensor:
    return torch.arange(buf.capacity, dtype=torch.int32,
                        device=buf.times.device)


def insert(buf: MeasurementBuffer, t, sensor_id, value) -> MeasurementBuffer:
    """Insert a measurement. (time, sensor) is a unique key: an existing
    record is overwritten, as the reference's ordered_unique index does.
    Otherwise the record goes to the ring cursor's slot (evicting whatever
    was there when the buffer is full)."""
    dev = buf.times.device
    t = _scalar(t, buf.times.dtype, dev)
    sensor_id = _scalar(sensor_id, torch.int32, dev)
    value = _scalar(value, buf.values.dtype, dev)
    existing = _match_slot(buf, t, sensor_id)
    use_cursor = existing < 0
    slot = torch.where(use_cursor, buf.cursor, existing)
    new_cursor = torch.where(
        use_cursor, (buf.cursor + 1) % buf.capacity, buf.cursor
    ).to(torch.int32)
    at = _slots(buf) == slot
    return MeasurementBuffer(
        times=torch.where(at, t, buf.times),
        sensor_ids=torch.where(at, sensor_id, buf.sensor_ids),
        values=torch.where(at[:, None], value, buf.values),
        valid=buf.valid | at,
        cursor=new_cursor,
    )


def insert_batch(buf: MeasurementBuffer, times, sensor_ids,
                 values) -> MeasurementBuffer:
    """Bulk insert N new records at consecutive ring slots (no dedup check:
    for streaming sensor feeds)."""
    dev = buf.times.device
    times = torch.as_tensor(times, dtype=buf.times.dtype, device=dev)
    n = times.shape[0]
    slots = ((buf.cursor + torch.arange(n, dtype=torch.int32, device=dev))
             % buf.capacity).long()
    sensor_ids = torch.as_tensor(sensor_ids, device=dev).to(torch.int32)
    values = torch.as_tensor(values, dtype=buf.values.dtype, device=dev)
    return MeasurementBuffer(
        times=buf.times.index_put((slots,), times),
        sensor_ids=buf.sensor_ids.index_put(
            (slots,), sensor_ids.expand(n)),
        values=buf.values.index_put((slots,), values),
        valid=buf.valid.index_put(
            (slots,), torch.ones((), dtype=torch.bool, device=dev)),
        cursor=((buf.cursor + n) % buf.capacity).to(torch.int32),
    )


def erase(buf: MeasurementBuffer, t, sensor_id) -> MeasurementBuffer:
    """Erase the record with key (t, sensor) if present."""
    dev = buf.times.device
    slot = _match_slot(buf, _scalar(t, buf.times.dtype, dev),
                       _scalar(sensor_id, torch.int32, dev))
    return buf._replace(valid=buf.valid & (_slots(buf) != slot))


def _interpolate(buf: MeasurementBuffer, t: torch.Tensor, sensor_mask):
    """(value (N, D), ok (N,)) for the flat reads ``t`` (N,)."""
    dt = buf.times - t[:, None]  # (N, C)
    below = sensor_mask & (dt <= 0)
    above = sensor_mask & (dt >= 0)
    # nearest below: the largest dt among below (dt <= 0)
    i_lo = torch.argmax(torch.where(below, dt, -_INF), dim=1)
    i_hi = torch.argmin(torch.where(above, dt, _INF), dim=1)
    ok = torch.any(below, dim=1) & torch.any(above, dim=1)
    lo_t, hi_t = buf.times[i_lo], buf.times[i_hi]
    lo_v, hi_v = buf.values[i_lo], buf.values[i_hi]
    denom = hi_t - lo_t
    w = torch.where(denom > 0,
                    (t - lo_t) / torch.where(denom == 0, 1.0, denom), 0.0)
    return lo_v + w[:, None] * (hi_v - lo_v), ok


def get_interpolated(buf: MeasurementBuffer, t, sensor_id):
    """Value of sensor ``sensor_id`` at time(s) ``t`` (any leading shape).

    The exact record if it exists; otherwise linear interpolation between
    the nearest neighbours below and above (the reference's interpolating
    ``get``, impl/measurement_container.hpp). Returns ``(value (..., D),
    ok (...))``: ``ok`` is False where no bracketing pair exists (the
    reference throws std::out_of_range there; this never raises). Many
    reads are swept against the buffer in chunks."""
    dev = buf.times.device
    t = torch.as_tensor(t, dtype=buf.times.dtype, device=dev)
    sensor_mask = buf.valid & (buf.sensor_ids == sensor_id)
    flat = t.reshape(-1)
    step = max(1, _SWEEP_ELEMENTS // max(buf.capacity, 1))
    parts = [_interpolate(buf, flat[k:k + step], sensor_mask)
             for k in range(0, flat.shape[0], step)]
    if parts:
        value = torch.cat([v for v, _ in parts])
        ok = torch.cat([o for _, o in parts])
    else:
        value = buf.values.new_zeros((0, buf.values.shape[1]))
        ok = torch.zeros((0,), dtype=torch.bool, device=dev)
    return (value.reshape(t.shape + buf.values.shape[1:]),
            ok.reshape(t.shape))


def get_time_window(buf: MeasurementBuffer, start, end) -> torch.Tensor:
    """Boolean mask of records with start <= time <= end (reference
    ``getTimeWindow``)."""
    return buf.valid & (buf.times >= start) & (buf.times <= end)


def get_all_from_sensor(buf: MeasurementBuffer, sensor_id) -> torch.Tensor:
    """Boolean mask of records from ``sensor_id`` (reference
    ``getAllFromSensor``)."""
    return buf.valid & (buf.sensor_ids == sensor_id)


def sorted_indices(buf: MeasurementBuffer, mask: torch.Tensor) -> torch.Tensor:
    """Slot indices sorted by time with masked-out entries last (a stable
    argsort), for time-ordered gathers like the reference's ordered
    iteration."""
    key = torch.where(mask, buf.times, _INF)
    return torch.argsort(key, stable=True)
