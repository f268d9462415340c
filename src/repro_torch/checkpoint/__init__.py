"""Fault-tolerant checkpointing (manifest format 1, shared with the JAX
package)."""

from repro_torch.checkpoint.io import (  # noqa: F401
    Checkpointer,
    CheckpointCorruptionError,
    CheckpointStructureError,
    available_steps,
    latest_step,
    read_checkpoint_extra,
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)
