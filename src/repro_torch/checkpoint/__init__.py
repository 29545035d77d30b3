"""Checkpointing substrate of the port: compressed npz shards with an atomic
commit and async writes, in the reference's format (``repro.checkpoint``)."""

from .store import CheckpointManager, latest_step, load_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "latest_step", "load_checkpoint", "save_checkpoint"]
