"""Checkpoints: the QTensor-native packed encoding (`qsave`) and the atomic,
async `CheckpointManager`, in the reference package's on-disk format."""
from . import qsave
from .manager import CheckpointManager

__all__ = ["CheckpointManager", "qsave"]
