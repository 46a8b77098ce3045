"""Checkpoints of the port, in the JAX package's on-disk format."""
from repro_torch.ckpt.store import (CheckpointManager, latest_step,
                                    read_manifest, restore_checkpoint,
                                    save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "read_manifest",
           "restore_checkpoint", "save_checkpoint"]
