"""Measurement containers (port of ``libwave_tpu.containers``' landmark
table)."""
