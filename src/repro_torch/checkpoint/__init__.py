"""Checkpoints of the port: trees of tensors in the reference's ``.npz``
layout (``checkpoint``)."""
from .checkpoint import CheckpointManager, metadata, restore, save

__all__ = ["CheckpointManager", "save", "restore", "metadata"]
