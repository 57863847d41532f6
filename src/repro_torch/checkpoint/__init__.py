"""Atomic, restart-safe checkpoints of tensor trees, and the training
loop's async writer."""

from .checkpoint import (CheckpointManager, latest_step,  # noqa: F401
                         load_checkpoint, save_checkpoint)
