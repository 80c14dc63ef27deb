"""Checkpoints of the port, in the JAX package's layout."""
from repro_torch.checkpoint.checkpointer import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    restore_fsdp_checkpoint,
    save_checkpoint,
)

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint",
           "restore_fsdp_checkpoint", "save_checkpoint"]
