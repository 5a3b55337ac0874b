"""Train step of the port: forward, backward and AdamW, with optional
microbatch gradient accumulation and int8 error-feedback gradient
compression (the port of ``repro/train/train_step.py``).

The state is ``{"params": Model, "opt": {"m", "v", "step"}, ["err"]}`` on
one device.  The step runs eagerly there and updates the state in place
(the reference's ``jit_train_step`` donates its state; its mesh and
sharding rules are ROADMAP A8).  Each attention forward, in the forward
pass and again in each layer's recompute under ``remat="block"``, is the
hand-written flash kernel on the card.

Gradients keep the reference's dtype flow: with one microbatch they stay
in the parameters' dtype, as ``jax.value_and_grad`` leaves them; with
several, each microbatch's gradient is added into an f32 sum (its own
``torch.autograd.grad``, never ``.grad`` accumulating in bf16) and the sum
is scaled by ``1 / microbatches``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import DeviceLike
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

from .compress import compress_tree, decompress_tree, init_error_buffers
from .optim import (AdamWConfig, adamw_update, init_opt_state, tree_leaves,
                    tree_unflatten)

State = Dict[str, Any]


def _on(batch: Dict[str, Any], device: torch.device
        ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, ocfg: AdamWConfig,
                    microbatches: int = 1, compress_grads: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the state
    updated in place, and ``loss``, ``grad_norm`` and ``lr`` as 0-d
    tensors on the state's device.  ``batch`` holds ``tokens`` and
    ``targets`` (B, S), numpy or tensors."""

    def grads_of(model: M.Model, batch):
        paths, leaves = zip(*model.named_leaves())
        if microbatches == 1:
            loss = M.loss_fn(model, batch)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), tree_unflatten(paths, grads)
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch of {B} rows does not split into "
                             f"{microbatches} microbatches")
        mb = {k: v.reshape((microbatches, B // microbatches) + v.shape[1:])
              for k, v in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        for i in range(microbatches):
            loss = M.loss_fn(model, {k: v[i] for k, v in mb.items()})
            for acc, g in zip(gsum, torch.autograd.grad(loss, leaves)):
                acc.add_(g.to(torch.float32))
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / microbatches
        return loss_sum * inv, tree_unflatten(paths, [g * inv for g in gsum])

    def train_step(state: State, batch: Dict[str, Any]):
        model, opt = state["params"], state["opt"]
        loss, grads = grads_of(model, _on(batch, model.device))
        metrics = {"loss": loss}
        if compress_grads:
            q, scales, state["err"] = compress_tree(grads, state["err"])
            grads = decompress_tree(q, scales)
        _, _, om = adamw_update(grads, model, opt, ocfg)
        metrics.update(om)
        return state, metrics

    return train_step


def init_state(cfg: ModelConfig, generator: torch.Generator,
               compress_grads: bool = False,
               device: DeviceLike = None) -> State:
    """A fresh train state: :func:`~repro_torch.models.model.init_params`
    from ``generator`` on ``device`` (the card unless the caller says
    otherwise) with gradients on, zero moments, and zero error buffers
    when gradients are compressed."""
    model = M.init_params(cfg, generator, device)
    model.requires_grad_(True)
    state: State = {"params": model, "opt": init_opt_state(model)}
    if compress_grads:
        state["err"] = init_error_buffers(model)
    return state


def state_axes(cfg: ModelConfig, compress_grads: bool = False
               ) -> Dict[str, Any]:
    axes = M.param_axes(cfg)
    out = {"params": axes, "opt": {"m": axes, "v": axes, "step": ()}}
    if compress_grads:
        out["err"] = axes
    return out


def state_tree(state: State) -> Dict[str, Any]:
    """The state as a nested dict of tensors (the model as its parameter
    dict), as ``CheckpointManager.save`` takes it."""
    return {k: (v.params if k == "params" else v) for k, v in state.items()}


def state_from_tree(cfg: ModelConfig, tree: Dict[str, Any]) -> State:
    """The inverse of :func:`state_tree` (a restored checkpoint): the
    parameters become a trainable :class:`~repro_torch.models.model.Model`
    on the tensors' device."""
    flat = tree_leaves(tree["params"])
    model = M.Model(cfg, dict(flat))
    model.requires_grad_(True)
    return {**tree, "params": model}
