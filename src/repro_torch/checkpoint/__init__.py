"""Checkpoint substrate: async, atomic, restore onto the state's device
(the port of the reference's ``checkpoint/``)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
