"""Training substrate of the port.  So far only the checkpoint manager,
which the join service's durable state (DESIGN.md §16) rides on."""
from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
