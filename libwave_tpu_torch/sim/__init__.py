"""Synthetic image rendering (numpy only; a copy of ``libwave_tpu.sim.render``,
whose package imports JAX)."""
