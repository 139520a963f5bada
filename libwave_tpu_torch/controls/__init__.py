"""Controllers (port of ``libwave_tpu.controls``; parity: wave_controls)."""

from libwave_tpu_torch.controls.pid import (  # noqa: F401
    PIDGains,
    PIDState,
    pid_init,
    pid_update,
)
