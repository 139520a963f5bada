"""Image-sequence front end: pixels -> persistent feature tracks (port of
``libwave_tpu.pipelines.visual_frontend``).

Per frame: FAST detect -> BRISK describe -> Hamming match (the fused top-2
kernel on the card) + ratio test + RANSAC -> masked ID inheritance into the
landmark buffer. The resulting track bank exports as the framework's
(frame, landmark_id, u, v) array.

The reference runs the sequence either as one ``lax.scan`` program or as one
jitted step per frame. PyTorch runs eagerly, so both values of ``scan`` run
the same per-frame loop; they differ only in whether the uint8 stack goes to
the device at once. The ORB front end (``method="orb"``) and the batched
mode (``track_sequences_batched``) are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libwave_tpu_torch.vision.descriptor import (
    BRISKParams,
    ORBDescriptorParams,
    _brisk_pattern,
    brisk_describe,
)
from libwave_tpu_torch.vision.detector import (
    FASTParams,
    ORBDetectorParams,
    detect_fast,
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
    "tracks_from_state",
]

_STACK_ON_DEVICE_BYTES = 512 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class FrontendParams:
    """Composed front-end configuration (detector + descriptor + tracker),
    the composition axis of the reference's templated
    ``Tracker<TDetector, TDescriptor, TMatcher>`` (tracker.hpp:34).

    ``method``: "fast_brisk" (FAST corners + BRISK descriptors) or "orb"
    (accepted, but not ported yet: running it raises)."""

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
    """One frame's (xy, desc, mask) bank. Accepts uint8 or float frames;
    integer frames are cast to f32 on their own device."""
    if params.method == "orb":
        raise NotImplementedError(
            "the ORB front end (method='orb') is not ported yet: see ROADMAP.md"
        )
    if not image.is_floating_point():
        image = image.to(torch.float32)
    xy, _, m = detect_fast(image, params.fast)
    desc, m = brisk_describe(image, xy, m, params.brisk)
    return xy, desc, m


def _frontend_step(state: TrackerState, image, time, generator,
                   params: FrontendParams) -> TrackerState:
    xy, desc, m = detect_and_describe(image, params)
    return add_image_features(state, xy, desc, m, time, generator,
                              params.tracker)


def _desc_words(params: FrontendParams) -> int:
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
