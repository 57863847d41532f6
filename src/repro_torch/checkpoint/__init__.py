"""Atomic, restart-safe checkpoints of tensor trees."""

from .checkpoint import (latest_step, load_checkpoint,  # noqa: F401
                         save_checkpoint)
