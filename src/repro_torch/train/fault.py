"""Fault tolerance & straggler mitigation (simulated control plane): the
port of ``repro/train/fault.py``, host logic copied.

On a real 1000+ node deployment the failure domain is the host: a node drops,
the process group's barrier times out, and the job restarts from the latest
checkpoint on the surviving (or replacement) slice.  This module provides the
control-plane logic in a hardware-independent, testable form:

* ``FailureInjector`` — deterministic fault schedule for tests/examples
  (fail step N, straggle step M by T seconds).
* ``StepGuard`` — per-step deadline; a step exceeding ``deadline_s`` is
  declared a straggler.  Mitigation policy: after ``patience`` consecutive
  straggler steps, the verdict is "remesh" (elastic restore onto the
  reduced healthy device set: ``CheckpointManager.restore(shardings=...)``
  onto a smaller mesh) — on real hardware this maps to excluding the slow
  host and re-sharding over the survivors.  The runner logs the verdict
  and goes on, as the reference's does.
* ``ElasticPlan`` — maps a device count to the largest (data, model) mesh it
  supports, so the runner can restore a checkpoint onto whatever survives.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Tuple


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    fail_at_steps: Tuple[int, ...] = ()
    straggle_at_steps: Tuple[int, ...] = ()
    straggle_seconds: float = 0.0
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")
        if step in self.straggle_at_steps:
            time.sleep(self.straggle_seconds)


@dataclasses.dataclass
class StepGuard:
    deadline_s: float = 60.0
    patience: int = 3
    consecutive: int = 0
    total_stragglers: int = 0

    def observe(self, step_seconds: float) -> str:
        """Returns 'ok' | 'straggler' | 'remesh'."""
        if step_seconds <= self.deadline_s:
            self.consecutive = 0
            return "ok"
        self.consecutive += 1
        self.total_stragglers += 1
        if self.consecutive >= self.patience:
            self.consecutive = 0
            return "remesh"
        return "straggler"


def elastic_plan(n_devices: int, prefer_model: int = 1) -> Tuple[int, int]:
    """Largest (data, model) mesh for a device count; model extent capped by
    preference (tiny models don't want TP on hosts)."""
    model = 1
    for m in range(min(prefer_model, n_devices), 0, -1):
        if n_devices % m == 0:
            model = m
            break
    return n_devices // model, model
