"""Rotation algebra (port of ``libwave_tpu.geometry``)."""
