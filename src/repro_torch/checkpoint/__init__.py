"""Checkpoints of the port, in the JAX package's layout, and the elastic
re-cut of a checkpoint's global arrays onto another mesh."""
from repro_torch.checkpoint.checkpointer import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    restore_fsdp_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.elastic import reshard, shardings_for, unshard

__all__ = ["AsyncCheckpointer", "latest_step", "reshard",
           "restore_checkpoint", "restore_fsdp_checkpoint", "save_checkpoint",
           "shardings_for", "unshard"]
