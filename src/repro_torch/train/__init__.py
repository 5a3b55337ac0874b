"""Training substrate of the port: the checkpoint manager (which the join
service's durable state, DESIGN.md §16, also rides on), AdamW, int8
gradient compression, fault injection, the train step and the runner."""
from .checkpoint import CheckpointManager
from .optim import AdamWConfig
from .runner import Runner, RunnerConfig

__all__ = ["AdamWConfig", "CheckpointManager", "Runner", "RunnerConfig"]
