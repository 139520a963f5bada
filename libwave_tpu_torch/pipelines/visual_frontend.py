"""Image-sequence front end: pixels -> persistent feature tracks (port of
``libwave_tpu.pipelines.visual_frontend``).

Per frame: FAST detect -> BRISK describe (or the ORB pyramid and its
scale-aware rBRIEF) -> Hamming match (the fused top-2 kernel on the card) +
ratio test + RANSAC -> masked ID inheritance into the landmark buffer. The
resulting track bank exports as the framework's (frame, landmark_id, u, v)
array.

The reference runs the sequence either as one ``lax.scan`` program or as one
jitted step per frame. PyTorch runs eagerly, so both values of ``scan`` run
the same per-frame loop; they differ only in whether the uint8 stack goes to
the device at once. ``track_sequences_batched`` (the reference's ``vmap``
over sequences) runs B sequences through the same step with a leading batch
dimension: one detect/describe per frame for all of them, the top-2 kernel
and RANSAC once per sequence, one generator per sequence.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libwave_tpu_torch.vision.descriptor import (
    BRISKParams,
    ORBDescriptorParams,
    _brief_pattern,
    _brisk_pattern,
    brisk_describe,
    orb_describe_pyramid,
)
from libwave_tpu_torch.vision.detector import (
    FASTParams,
    ORBDetectorParams,
    build_pyramid,
    detect_fast,
    detect_orb_pyramid,
)
from libwave_tpu_torch.utils.device import resolve
from libwave_tpu_torch.vision.tracker import (
    TrackerParams,
    TrackerState,
    add_image_features,
    tracker_init,
)

__all__ = [
    "FrontendParams",
    "detect_and_describe",
    "track_sequence",
    "track_sequences_batched",
    "tracks_from_state",
]

_STACK_ON_DEVICE_BYTES = 512 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class FrontendParams:
    """Composed front-end configuration (detector + descriptor + tracker),
    the composition axis of the reference's templated
    ``Tracker<TDetector, TDescriptor, TMatcher>`` (tracker.hpp:34).

    ``method``: "fast_brisk" (FAST corners + BRISK descriptors) or "orb"
    (multi-level oFAST/Harris pyramid + scale-aware rBRIEF)."""

    method: str = "fast_brisk"
    fast: FASTParams = dataclasses.field(
        default_factory=lambda: FASTParams(threshold=20.0, num_features=512)
    )
    brisk: BRISKParams = dataclasses.field(default_factory=BRISKParams)
    orb: ORBDetectorParams = dataclasses.field(
        default_factory=lambda: ORBDetectorParams(num_features=512)
    )
    orb_desc: ORBDescriptorParams = dataclasses.field(
        default_factory=ORBDescriptorParams
    )
    tracker: TrackerParams = dataclasses.field(
        default_factory=lambda: TrackerParams(
            num_features=512, buffer_capacity=65536
        )
    )

    def __post_init__(self):
        if self.method not in ("fast_brisk", "orb"):
            raise ValueError(f"unknown front-end method {self.method!r}")
        det = self.fast if self.method == "fast_brisk" else self.orb
        if self.tracker.num_features != det.num_features:
            raise ValueError(
                "tracker.num_features must equal the detector's "
                f"({self.tracker.num_features} != {det.num_features})"
            )


def detect_and_describe(image: torch.Tensor, params: FrontendParams):
    """One frame's (xy, desc, mask) bank, or a batch of frames' (leading
    dimensions). Accepts uint8 or float frames; integer frames are cast to
    f32 on their own device."""
    if not image.is_floating_point():
        image = image.to(torch.float32)
    if params.method == "orb":
        levels = build_pyramid(image, params.orb.scale_factor,
                               params.orb.num_levels)
        xy, _, angle, level, m = detect_orb_pyramid(image, params.orb, levels)
        desc, m = orb_describe_pyramid(
            image, xy, angle, level, m,
            params.orb.scale_factor, params.orb.num_levels, params.orb_desc,
            levels,
        )
        return xy, desc, m
    xy, _, m = detect_fast(image, params.fast)
    desc, m = brisk_describe(image, xy, m, params.brisk)
    return xy, desc, m


def _frontend_step(state: TrackerState, image, time, generator,
                   params: FrontendParams) -> TrackerState:
    xy, desc, m = detect_and_describe(image, params)
    return add_image_features(state, xy, desc, m, time, generator,
                              params.tracker)


def _desc_words(params: FrontendParams) -> int:
    if params.method == "orb":
        a, _ = _brief_pattern(params.orb_desc)
        return (len(a) + 31) // 32
    _, _, short, _ = _brisk_pattern(params.brisk)
    return (len(short) + 31) // 32


def track_sequence(frames, times=None,
                   params: FrontendParams = FrontendParams(),
                   generator: torch.Generator | None = None,
                   scan: bool | None = None, device=None) -> np.ndarray:
    """Track a (T, H, W) image stack; return the (K, 4) float64 track array
    ``(frame, landmark_id, u, v)``.

    ``frames`` is a numpy array or a tensor, uint8 or float; the frames run
    on ``device`` (default: the card; ``"cpu"`` when the caller asks).
    ``times`` defaults to the frame index. ``generator`` draws the RANSAC
    samples (default: a generator on ``device`` seeded with 0). With
    ``scan`` True the whole stack goes to the device in its own dtype at
    once, with False one frame at a time; None (default) picks True when the
    stack is under 512 MB. The float cast happens on the device.
    """
    device = resolve(device)
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    T = frames.shape[0]
    if times is None:
        times = np.arange(T, dtype=np.float64)
    times32 = torch.as_tensor(np.asarray(times, np.float32), device=device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    if scan is None:
        scan = frames.numel() * frames.element_size() < _STACK_ON_DEVICE_BYTES
    if scan:
        frames = frames.to(device)

    state = tracker_init(params.tracker, desc_words=_desc_words(params),
                         device=device)
    for i in range(T):
        state = _frontend_step(state, frames[i].to(device), times32[i],
                               generator, params)
    return tracks_from_state(state)


def track_sequences_batched(frames, times=None,
                            params: FrontendParams = FrontendParams(),
                            generators=None, device=None) -> list:
    """Track a batch of sequences, a (B, T, H, W) stack, with a leading batch
    dimension through the per-frame step (the reference's vmapped
    whole-sequence program, the throughput mode: the per-frame chain is
    sequential, sequences are not). Returns a list of B (K, 4) track
    arrays, sequence b's equal to ``track_sequence(frames[b],
    generator=generators[b])``.

    ``generators``: B ``torch.Generator``s on ``device`` (default: one per
    sequence, sequence b's seeded with b). ``times`` (B, T) or (T,) defaults
    to the frame index. The stack goes to ``device`` in its own dtype.
    """
    device = resolve(device)
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    B, T = frames.shape[:2]
    if times is None:
        times = np.arange(T, dtype=np.float64)
    times32 = torch.as_tensor(
        np.broadcast_to(np.asarray(times, np.float32), (B, T)).copy(),
        device=device)
    if generators is None:
        generators = [torch.Generator(device=device).manual_seed(b)
                      for b in range(B)]
    if len(generators) != B:
        raise ValueError(f"{len(generators)} generators for {B} sequences")
    frames = frames.to(device)

    one = tracker_init(params.tracker, desc_words=_desc_words(params),
                       device=device)
    state = TrackerState(*(
        type(x)(*(f.expand((B,) + f.shape).clone() for f in x))
        if isinstance(x, tuple) else x.expand((B,) + x.shape).clone()
        for x in one
    ))
    for i in range(T):
        state = _frontend_step(state, frames[:, i], times32[:, i],
                               generators, params)
    return [tracks_from_state(_sequence(state, b)) for b in range(B)]


def _sequence(state: TrackerState, b: int) -> TrackerState:
    """Sequence ``b``'s tracker state of a batched one."""
    return TrackerState(*(
        type(x)(*(f[b] for f in x)) if isinstance(x, tuple) else x[b]
        for x in state
    ))


def tracks_from_state(state: TrackerState) -> np.ndarray:
    """Export the tracker's landmark buffer as (frame, id, u, v) rows,
    sorted by (frame, id) (``LandmarkMeasurementContainer`` iteration
    order, landmark_measurement_container.hpp:196)."""
    buf = state.landmarks
    valid = buf.valid.cpu().numpy()
    frames = buf.images.cpu().numpy()[valid]
    ids = buf.landmark_ids.cpu().numpy()[valid]
    uv = buf.values.cpu().numpy()[valid]
    order = np.lexsort((ids, frames))
    out = np.zeros((len(frames), 4), np.float64)
    out[:, 0] = frames[order]
    out[:, 1] = ids[order]
    out[:, 2:] = uv[order]
    return out
