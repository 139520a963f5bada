"""Robot motion models (port of the part of ``libwave_tpu.kinematics`` that
the synthetic VO dataset needs)."""

from libwave_tpu_torch.kinematics.two_wheel import two_wheel_step  # noqa: F401
