"""Simulation: synthetic image rendering (numpy only; a copy of
``libwave_tpu.sim.render``, whose package imports JAX) and the synthetic VO
dataset (``vo_dataset``)."""

from libwave_tpu_torch.sim.vo_dataset import (  # noqa: F401
    VoDataset,
    VoSimParams,
    draw_landmarks,
    generate_vo_dataset,
    q_BC,
)
