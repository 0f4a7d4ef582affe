"""CRC-checked async checkpoints (twin of repro.checkpoint)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
