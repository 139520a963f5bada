"""End-to-end pipelines (port of ``libwave_tpu.pipelines``' visual front
end)."""

from libwave_tpu_torch.pipelines.visual_frontend import (  # noqa: F401
    FrontendParams,
    detect_and_describe,
    track_sequence,
    tracks_from_state,
)
