"""Geodetic conversions (port of ``libwave_tpu.geography``; parity:
wave_geography)."""

from libwave_tpu_torch.geography.world_frame import (  # noqa: F401
    ecef_from_enu_transform,
    ecef_point_from_llh,
    enu_from_ecef_transform,
    enu_point_from_llh,
    llh_point_from_ecef,
    llh_point_from_enu,
)
