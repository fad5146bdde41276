"""Checkpoints with atomic commit and async writes, and the pipeline
manifests that a failover replica restores."""
from .store import (CheckpointManager, latest_step, restore,
                    restore_pipeline, save, save_pipeline)

__all__ = ["CheckpointManager", "latest_step", "restore",
           "restore_pipeline", "save", "save_pipeline"]
