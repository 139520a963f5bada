"""Fixed-capacity feature tracker with persistent landmark IDs (port of
``libwave_tpu.vision.tracker``).

Per frame: match the previous frame's keypoint bank against the current
one; a matched current keypoint inherits the previous keypoint's ID, and a
first-time match mints a new monotonic ID and back-fills the previous
frame's measurement; measurements go to a :class:`LandmarkBuffer`, and with
``window_size > 0`` measurements older than the window are purged.

IDs are scattered onto the current rows with an explicit winner rule. The
reference writes ``curr_ids.at[safe_idx2].set(...)``, where invalid rows
write -1 to slot 0 and two previous rows may match one current keypoint,
and XLA applies the writes in row order, so the last row wins. Here the
winner for each slot is the largest row index among the rows that write
there (``scatter_reduce`` "amax"), and its value is its ID if the row is a
valid match and -1 otherwise: the reference's result on every device,
including its loss of matches onto current keypoint 0 (ROADMAP.md, C).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from libwave_tpu_torch.containers.landmark import (
    LandmarkBuffer,
    erase_older_than_image,
    get_track,
    insert_landmark_batch,
    landmark_buffer,
)
from libwave_tpu_torch.utils.config import ConfigError
from libwave_tpu_torch.utils.device import resolve
from libwave_tpu_torch.vision.matcher import MatcherParams, match_descriptors


@dataclasses.dataclass(frozen=True)
class TrackerParams:
    """tracker.hpp:50-52 parity: window_size >= 0 (0 = keep everything)."""

    window_size: int = 0
    num_features: int = 512
    buffer_capacity: int = 16384
    sensor_id: int = 0
    matcher: MatcherParams = MatcherParams()

    def validate(self):
        if self.window_size < 0:
            raise ConfigError("window_size cannot be negative!")


class TrackerState(NamedTuple):
    prev_xy: torch.Tensor  # (N, 2)
    prev_desc: torch.Tensor  # (N, W) int32 words (uint32 bit patterns)
    prev_mask: torch.Tensor  # (N,) bool
    prev_ids: torch.Tensor  # (N,) int32, -1 = no ID assigned yet
    prev_time: torch.Tensor  # ()
    image_count: torch.Tensor  # () int32, images added so far
    next_id: torch.Tensor  # () int32, monotonic ID source
    landmarks: LandmarkBuffer


def tracker_init(params: TrackerParams, desc_words: int, dtype=torch.float32,
                 device=None) -> TrackerState:
    """Empty tracker state on ``device`` (default: the card)."""
    device = resolve(device)
    N = params.num_features
    return TrackerState(
        prev_xy=torch.zeros((N, 2), dtype=dtype, device=device),
        prev_desc=torch.zeros((N, desc_words), dtype=torch.int32, device=device),
        prev_mask=torch.zeros((N,), dtype=torch.bool, device=device),
        prev_ids=torch.full((N,), -1, dtype=torch.int32, device=device),
        prev_time=torch.zeros((), dtype=dtype, device=device),
        image_count=torch.zeros((), dtype=torch.int32, device=device),
        next_id=torch.zeros((), dtype=torch.int32, device=device),
        landmarks=landmark_buffer(params.buffer_capacity, 2, dtype=dtype,
                                  device=device),
    )


def _scatter_last_wins(index: torch.Tensor, values: torch.Tensor, size: int,
                       fill: int) -> torch.Tensor:
    """out[..., index[..., i]] = values[..., i], the largest i winning where
    indices repeat (XLA's row-order scatter), ``fill`` where no row writes;
    along the last dimension, any leading ones."""
    rows = torch.arange(index.shape[-1], device=index.device).expand(index.shape)
    winner = torch.full(index.shape[:-1] + (size,), -1, dtype=rows.dtype,
                        device=index.device)
    winner.scatter_reduce_(-1, index, rows, "amax")
    picked = torch.gather(values, -1, torch.clamp(winner, min=0))
    return torch.where(winner >= 0, picked, torch.full_like(picked, fill))


def add_image_features(
    state: TrackerState,
    xy: torch.Tensor,
    desc: torch.Tensor,
    mask: torch.Tensor,
    time,
    generator,
    params: TrackerParams,
    sample_idx: torch.Tensor | None = None,
) -> TrackerState:
    """Register one frame's detected features (the core of addImage after
    detectAndCompute). Returns the new tracker state; ``state`` is not
    written. ``sample_idx`` fixes the RANSAC samples (tests).

    A batch of B trackers (every state field with a leading dimension B,
    ``image_count`` (B,)) takes banks (B, N, ...), times (B,) and a list of
    B generators: tracker b steps as it would alone."""
    N = params.num_features
    first = state.image_count == 0
    lead = state.image_count.shape

    idx2, valid, _ = match_descriptors(
        state.prev_desc, desc, state.prev_xy, xy,
        state.prev_mask, mask, generator, params.matcher, sample_idx,
    )
    valid = valid & ~first[..., None]  # no matches into an empty tracker

    # ID assignment per previous keypoint row (match query side)
    had_id = state.prev_ids >= 0
    needs_new = valid & ~had_id
    nn32 = needs_new.to(torch.int32)
    new_rank = torch.cumsum(nn32, -1, dtype=torch.int32) - nn32
    minted = state.next_id[..., None] + new_rank
    prev_ids_updated = torch.where(needs_new, minted, state.prev_ids)
    ids_for_match = torch.where(
        valid, prev_ids_updated, torch.full_like(prev_ids_updated, -1)
    )
    num_minted = torch.sum(nn32, dim=-1)

    # scatter IDs onto current keypoint rows (last row wins, see above)
    safe_idx2 = torch.where(valid, idx2, torch.zeros_like(idx2))
    curr_ids = _scatter_last_wins(safe_idx2, ids_for_match, N, -1)

    img = state.image_count  # current image index (0-based)
    dtype = state.prev_xy.dtype
    t = (time.to(device=img.device, dtype=dtype) if isinstance(time, torch.Tensor)
         else torch.full((), time, dtype=dtype, device=img.device))
    t = t.expand(lead)

    def col(x):
        return x[..., None].expand(lead + (N,))

    sensor = torch.full(lead + (N,), params.sensor_id, dtype=torch.int32,
                        device=img.device)
    matched_xy = torch.gather(
        xy, -2, safe_idx2[..., None].expand(safe_idx2.shape + (2,)))
    # back-fill previous-frame measurements for newly-minted IDs
    # (impl/tracker.hpp:62-81), then insert current-frame measurements
    lm = insert_landmark_batch(
        state.landmarks, col(state.prev_time), sensor, prev_ids_updated,
        col(img - 1), state.prev_xy, mask=needs_new,
    )
    lm = insert_landmark_batch(
        lm, col(t), sensor, ids_for_match, col(img), matched_xy, mask=valid,
    )

    # sliding window purge (impl/tracker.hpp:90-101): with window_size w and
    # images 0..img, drop measurements at images < img + 1 - w
    if params.window_size > 0:
        cutoff = (img + 1 - params.window_size)[..., None]
        purged = erase_older_than_image(lm, torch.clamp(cutoff, min=0))
        lm = lm._replace(valid=torch.where(cutoff > 0, purged.valid, lm.valid))

    return TrackerState(
        prev_xy=xy,
        prev_desc=desc,
        prev_mask=mask,
        prev_ids=curr_ids,
        prev_time=t,
        image_count=(img + 1).to(torch.int32),
        next_id=(state.next_id + num_minted).to(torch.int32),
        landmarks=lm,
    )


def make_add_image(detect_describe: Callable, params: TrackerParams) -> Callable:
    """Compose detect/describe with feature registration into the
    reference's ``addImage(image, time)`` signature. ``detect_describe(image)
    -> (xy, desc, mask)``."""

    def add_image(state: TrackerState, image, time, generator):
        xy, desc, mask = detect_describe(image)
        return add_image_features(state, xy, desc, mask, time, generator, params)

    return add_image


def offline_tracker(
    detect_describe: Callable,
    images: torch.Tensor,
    times: torch.Tensor,
    generator: torch.Generator | None,
    params: TrackerParams,
    desc_words: int,
) -> TrackerState:
    """Track a whole (T, H, W) sequence (offlineTracker parity): a Python
    loop over the frames, one generator threading through them."""
    add_image = make_add_image(detect_describe, params)
    state = tracker_init(params, desc_words, dtype=times.dtype,
                         device=images.device)
    for i in range(images.shape[0]):
        state = add_image(state, images[i], times[i], generator)
    return state


def get_tracks(state: TrackerState, params: TrackerParams, max_len: int,
               landmark_id):
    """Time-sorted track of one landmark (getTracks building block)."""
    return get_track(state.landmarks, params.sensor_id, landmark_id, max_len)
