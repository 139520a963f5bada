"""Simulation: synthetic image rendering (numpy only; a copy of
``libwave_tpu.sim.render``, whose package imports JAX), the synthetic VO
dataset (``vo_dataset``) and the EuRoC-format sequence writer
(``euroc_sim``)."""

from libwave_tpu_torch.sim.euroc_sim import (  # noqa: F401
    EurocSimParams,
    generate_euroc_sequence,
)
from libwave_tpu_torch.sim.vo_dataset import (  # noqa: F401
    VoDataset,
    VoSimParams,
    draw_landmarks,
    generate_vo_dataset,
    q_BC,
)
