"""Checkpointing of training state (port of ``repro.checkpoint``)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
