"""Checkpoint substrate: atomic, async, keep-k, in the JAX package's
format (port of ``repro.checkpoint``)."""

from repro_torch.checkpoint.manager import (CheckpointManager, restore_tree,
                                            save_tree)

__all__ = ["CheckpointManager", "restore_tree", "save_tree"]
