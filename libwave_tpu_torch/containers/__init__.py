"""Measurement containers (port of ``libwave_tpu.containers``): the
interpolating measurement table and the landmark table."""

from libwave_tpu_torch.containers.measurement import (  # noqa: F401
    MeasurementBuffer,
    measurement_buffer,
    insert,
    insert_batch,
    erase,
    get_interpolated,
    get_time_window,
    get_all_from_sensor,
    size,
    sorted_indices,
)
from libwave_tpu_torch.containers.landmark import (  # noqa: F401
    LandmarkBuffer,
    landmark_buffer,
    insert_landmark,
    get_exact,
    get_landmark_ids,
    get_track,
    landmark_size,
)
