"""Landmark measurement table with track extraction (port of
``libwave_tpu.containers.landmark``).

Records are ``{time, sensor_id, landmark_id, image, value}`` with a unique
(time, sensor, landmark) key, exact ``get``, ``getLandmarkIDs`` and
``getTrack`` returning a time-sorted track. Struct-of-arrays, fixed
capacity, masked: every function is a pure function of tensors that returns
new tensors (the inputs are never written), and none reads a device value
on the host.

Scatter writes never share an index. The reference's batched insert lets a
masked row write its slot's old value to the slot the next valid row writes
too, and relies on XLA applying the two in row order; ``index_put_`` gives
no order on a GPU, so here masked rows write to a scratch slot past the end,
which is then dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libwave_tpu_torch.utils.device import resolve

_INT32_MAX = 2**31 - 1


class LandmarkBuffer(NamedTuple):
    times: torch.Tensor  # (C,)
    sensor_ids: torch.Tensor  # (C,) int32
    landmark_ids: torch.Tensor  # (C,) int32
    images: torch.Tensor  # (C,) int32 - frame number
    values: torch.Tensor  # (C, D) - pixel (u, v) for D=2
    valid: torch.Tensor  # (C,) bool
    cursor: torch.Tensor  # () int32

    @property
    def capacity(self) -> int:
        return self.times.shape[-1]


def landmark_buffer(capacity: int, value_dim: int = 2, dtype=torch.float32,
                    device=None) -> LandmarkBuffer:
    """Empty buffer of ``capacity`` rows on ``device`` (default: the card)."""
    device = resolve(device)

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return LandmarkBuffer(
        times=full((capacity,), -float("inf"), dtype),
        sensor_ids=full((capacity,), -1, torch.int32),
        landmark_ids=full((capacity,), -1, torch.int32),
        images=full((capacity,), -1, torch.int32),
        values=full((capacity, value_dim), 0, dtype),
        valid=full((capacity,), False, torch.bool),
        cursor=full((), 0, torch.int32),
    )


def landmark_size(buf: LandmarkBuffer) -> torch.Tensor:
    return torch.sum(buf.valid.to(torch.int32))


def _as(x, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``like``'s device in ``dtype`` (default
    ``like``'s). A Python number becomes a fill, not a host-to-device
    copy."""
    dtype = like.dtype if dtype is None else dtype
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=dtype)
    if isinstance(x, (bool, int, float)):
        return torch.full((), x, dtype=dtype, device=like.device)
    return torch.as_tensor(x, dtype=dtype, device=like.device)


def _match_slot(buf: LandmarkBuffer, t, sensor_id, landmark_id) -> torch.Tensor:
    hit = (
        buf.valid
        & (buf.sensor_ids == sensor_id)
        & (buf.landmark_ids == landmark_id)
        & (buf.times == t)
    )
    first = torch.argmax(hit.to(torch.int32))
    return torch.where(torch.any(hit), first, -1).to(torch.int32)


def insert_landmark(buf: LandmarkBuffer, t, sensor_id, landmark_id, image,
                    value) -> LandmarkBuffer:
    """Insert one observation; (time, sensor, landmark) is unique-key:
    overwrite on collision, else write at the ring cursor."""
    t = _as(t, buf.times)
    existing = _match_slot(buf, t, sensor_id, landmark_id)
    use_cursor = existing < 0
    slot = torch.where(use_cursor, buf.cursor, existing).to(torch.int64)[None]

    def put(arr, v):
        return arr.index_put((slot,), v.expand(arr[slot].shape))

    return LandmarkBuffer(
        times=put(buf.times, t),
        sensor_ids=put(buf.sensor_ids, _as(sensor_id, buf.sensor_ids)),
        landmark_ids=put(buf.landmark_ids, _as(landmark_id, buf.landmark_ids)),
        images=put(buf.images, _as(image, buf.images)),
        values=put(buf.values, _as(value, buf.values)),
        valid=put(buf.valid, _as(True, buf.valid)),
        cursor=torch.where(
            use_cursor, (buf.cursor + 1) % buf.capacity, buf.cursor
        ).to(torch.int32),
    )


def insert_landmark_batch(buf: LandmarkBuffer, times, sensor_ids, landmark_ids,
                          images, values, mask=None) -> LandmarkBuffer:
    """Bulk insert N observations at consecutive ring slots from the cursor.
    ``mask`` marks the real rows: they are compacted into consecutive slots
    and the masked rows consume none. A batch of buffers (leading dimension
    B on every field, ``cursor`` (B,)) takes rows (B, N), each buffer its
    own."""
    times = _as(times, buf.times)
    lead = buf.cursor.shape
    k = len(lead)
    n = times.shape[-1]
    if mask is None:
        mask = torch.ones(times.shape, dtype=torch.bool, device=times.device)
    m32 = mask.to(torch.int32)
    offsets = torch.cumsum(m32, -1) - m32  # valid rows before each row
    C = buf.capacity
    slots = ((buf.cursor[..., None] + offsets) % C).to(torch.int64)
    # masked rows go to a scratch slot at index C, dropped after the write
    slots = torch.where(mask, slots, C)
    grid = torch.meshgrid(
        *(torch.arange(d, device=slots.device) for d in lead + (n,)),
        indexing="ij")[:k]
    index = tuple(grid) + (slots,)

    def upd(arr, vals):
        vals = _as(vals, arr).expand(lead + (n,) + arr.shape[k + 1:])
        ext = torch.cat([arr, arr.narrow(k, 0, 1)], dim=k)
        return ext.index_put_(index, vals).narrow(k, 0, C)

    n_new = torch.sum(m32, dim=-1)
    return LandmarkBuffer(
        times=upd(buf.times, times),
        sensor_ids=upd(buf.sensor_ids, sensor_ids),
        landmark_ids=upd(buf.landmark_ids, landmark_ids),
        images=upd(buf.images, images),
        values=upd(buf.values, values),
        valid=upd(buf.valid, mask),
        cursor=((buf.cursor + n_new) % C).to(torch.int32),
    )


def get_exact(buf: LandmarkBuffer, t, sensor_id, landmark_id):
    """Exact lookup (no interpolation; landmark_measurement_container.hpp:167).
    Returns (value, ok)."""
    slot = _match_slot(buf, _as(t, buf.times), sensor_id, landmark_id)
    ok = slot >= 0
    # a 1-element index tensor: a 0-d one would be read on the host
    return buf.values[torch.clamp(slot, min=0).to(torch.int64).reshape(1)][0], ok


def get_landmark_ids(buf: LandmarkBuffer, max_ids: int, t_start=None,
                     t_end=None):
    """Unique landmark ids (optionally within a time window) as a
    fixed-length ascending array plus count (``getLandmarkIDs`` /
    ``getLandmarkIDsInWindow``, landmark_measurement_container.hpp:167-196)."""
    m = buf.valid
    if t_start is not None:
        m = m & (buf.times >= t_start) & (buf.times <= t_end)
    sentinel = torch.full_like(buf.landmark_ids, _INT32_MAX)
    sorted_ids = torch.sort(torch.where(m, buf.landmark_ids, sentinel))[0]
    first = torch.cat(
        [torch.ones((1,), dtype=torch.bool, device=m.device),
         sorted_ids[1:] != sorted_ids[:-1]]
    )
    keep = first & (sorted_ids != _INT32_MAX)
    order = torch.sort((~keep).to(torch.int8), stable=True)[1]
    out = torch.where(keep[order], sorted_ids[order],
                      torch.full_like(sorted_ids, -1))[:max_ids]
    return out, torch.sum(keep.to(torch.int32))


def get_track(buf: LandmarkBuffer, sensor_id, landmark_id, max_len: int,
              t_start=None, t_end=None):
    """Time-sorted track of one landmark from one sensor: ``(times, images,
    values, mask)`` of length ``max_len`` (mask False past the end)
    (``getTrack``/``getTrackInWindow``, landmark_measurement_container.hpp:196).
    """
    m = buf.valid & (buf.sensor_ids == sensor_id) & (buf.landmark_ids == landmark_id)
    if t_start is not None:
        m = m & (buf.times >= t_start) & (buf.times <= t_end)
    key = torch.where(m, buf.times, torch.full_like(buf.times, float("inf")))
    order = torch.sort(key, stable=True)[1][:max_len]
    mask = m[order]
    return (
        torch.where(mask, buf.times[order], torch.zeros_like(key[order])),
        torch.where(mask, buf.images[order], torch.full_like(buf.images[order], -1)),
        torch.where(mask[:, None], buf.values[order],
                    torch.zeros_like(buf.values[order])),
        mask,
    )


def erase_older_than_image(buf: LandmarkBuffer, image_cutoff) -> LandmarkBuffer:
    """Invalidate all observations with image < cutoff: the sliding-window
    purge of the tracker (reference impl/tracker.hpp:90-101)."""
    return buf._replace(valid=buf.valid & (buf.images >= image_cutoff))
