"""Training runner: the fault-tolerant loop tying together the data
pipeline, the train step, checkpointing and failure injection (the port of
``repro/train/runner.py``).

This is the loop ``launch/train.py`` and the end-to-end example use.  It
is structured as  restore -> loop(step -> guard -> checkpoint)  with the
*entire* mutable state in (step, state, pipeline-cursor), so a crash at any
point resumes bit-exact from the last checkpoint (tested on the CPU and on
the card).  On a mesh (a ``HostMesh``) every rank runs the loop alike:
the state is each rank's blocks under ``rcfg.rules`` and the step is
:func:`~repro_torch.train.train_step.jit_train_step`'s.  A "remesh" verdict
of the ``StepGuard`` is logged and not acted on, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import DeviceLike, pick_device
from repro_torch.launch.mesh import HostMesh
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import local_block

from .checkpoint import CheckpointManager
from .fault import FailureInjector, SimulatedFailure, StepGuard
from .optim import AdamWConfig
from .train_step import (abstract_state, init_mesh_state, init_state,
                         jit_train_step, make_train_step, state_from_tree,
                         state_tree)


@dataclasses.dataclass
class RunnerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = "checkpoints"
    keep: int = 3
    log_every: int = 10
    microbatches: int = 1
    compress_grads: bool = False
    rules: str = "fsdp_tp"
    seed: int = 0
    step_deadline_s: float = 1e9


class Runner:
    """``Runner(cfg, ocfg, rcfg, mesh, pipeline)``, the reference's
    arguments.  ``mesh``: a ``HostMesh`` (every rank builds its runner and
    calls :meth:`run` alike), or one device: a device, or ``None`` with
    ``device=`` (the card unless ``"cpu"`` is asked for).  A fresh state
    draws its parameters from a ``torch.Generator`` on the device seeded
    with ``rcfg.seed``; on a mesh every rank draws the whole state so and
    keeps its blocks."""

    def __init__(self, cfg: ModelConfig, ocfg: AdamWConfig,
                 rcfg: RunnerConfig, mesh, pipeline: TokenPipeline,
                 injector: Optional[FailureInjector] = None,
                 log: Callable[[str], None] = print,
                 device: DeviceLike = None):
        self.cfg, self.ocfg, self.rcfg = cfg, ocfg, rcfg
        self.mesh = mesh if isinstance(mesh, HostMesh) else None
        self.device = self.mesh.device if self.mesh is not None \
            else pick_device(device if mesh is None else mesh)
        self.pipeline = pipeline
        self.injector = injector or FailureInjector()
        self.guard = StepGuard(deadline_s=rcfg.step_deadline_s)
        self.ckpt = CheckpointManager(rcfg.checkpoint_dir, keep=rcfg.keep,
                                      mesh=self.mesh)
        self.log = log if self.mesh is None or self.mesh.rank == 0 \
            else (lambda msg: None)
        self.metrics_history: list = []
        self.s_shard = self.b_shard = None
        if self.mesh is None:
            self.step_fn = make_train_step(cfg, ocfg, rcfg.microbatches,
                                           rcfg.compress_grads)
        else:
            specs = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                                    device="meta")
                     for k, v in pipeline.batch_at(0).items()}
            self.step_fn, self.s_shard, self.b_shard = jit_train_step(
                cfg, ocfg, self.mesh,
                abstract_state(cfg, rcfg.compress_grads), specs, rcfg.rules,
                rcfg.microbatches, rcfg.compress_grads)

    def _fresh_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.rcfg.seed)
        if self.mesh is not None:
            return init_mesh_state(self.cfg, gen, self.s_shard,
                                   self.rcfg.compress_grads, self.device)
        return init_state(self.cfg, gen, self.rcfg.compress_grads,
                          self.device)

    def _restore(self):
        if self.mesh is not None:
            step, state, _ = self.ckpt.restore(shardings=self.s_shard)
            return step, state
        step, tree, _ = self.ckpt.restore(device=self.device)
        return step, state_from_tree(self.cfg, tree)

    def _batch(self, step: int):
        batch = self.pipeline.batch_at(step)    # exact skip-ahead cursor
        if self.mesh is None:
            return batch
        return {k: local_block(torch.from_numpy(v), self.b_shard[k])
                for k, v in batch.items()}

    def run(self) -> Dict[str, Any]:
        # restore-or-init
        self.ckpt.wait()        # on a mesh: every rank sees the same steps
        if self.ckpt.latest_step() is None:
            state = self._fresh_state()
            step = 0
        else:
            step, state = self._restore()
            self.log(f"[runner] restored step {step} from {self.ckpt.dir}")

        while step < self.rcfg.total_steps:
            t0 = time.time()
            batch = self._batch(step)
            try:
                self.injector.check(step)
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])
            except SimulatedFailure as e:
                self.log(f"[runner] {e}; restarting from latest checkpoint")
                step, state = self._restore()
                continue
            dt = time.time() - t0
            verdict = self.guard.observe(dt)
            if verdict == "remesh":
                self.log(f"[runner] straggler threshold hit at step {step} — "
                         "on hardware: exclude host + elastic restore "
                         "(CheckpointManager.restore(shardings=...))")
            step += 1
            self.metrics_history.append({"step": step, "loss": loss, "s": dt})
            if step % self.rcfg.log_every == 0:
                self.log(f"[runner] step {step} loss {loss:.4f} ({dt:.2f}s)")
            if step % self.rcfg.checkpoint_every == 0 \
                    or step == self.rcfg.total_steps:
                self.ckpt.save(step, state_tree(state),
                               extra={"pipeline_step": step},
                               background=True, shardings=self.s_shard)
        self.ckpt.wait()
        return {"final_step": step, "history": self.metrics_history,
                "state": state}
