"""Utilities shared by the port."""

from libwave_tpu_torch.utils.checkpoint import (  # noqa: F401
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
    solve_with_checkpoints,
)
