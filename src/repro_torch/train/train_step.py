"""Train step of the port: forward, backward and AdamW, with optional
microbatch gradient accumulation and int8 error-feedback gradient
compression (the port of ``repro/train/train_step.py``).

On one device (:func:`make_train_step`) the state is ``{"params": Model,
"opt": {"m", "v", "step"}, ["err"]}``.  The step runs eagerly there and
updates the state in place (the reference's ``jit_train_step`` donates its
state).  On a mesh (:func:`jit_train_step`) the state is the same tree with
each rank's blocks under the reference's rule sets.  Each attention
forward, in the forward pass and again in each layer's recompute under
``remat="block"``, is the hand-written flash kernel on the card, in every
rank.

Gradients keep the reference's dtype flow: with one microbatch they stay
in the parameters' dtype, as ``jax.value_and_grad`` leaves them; with
several, each microbatch's gradient is added into an f32 sum (its own
``torch.autograd.grad``, never ``.grad`` accumulating in bf16) and the sum
is scaled by ``1 / microbatches``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import (batch_sharding, block_slices, gather_full,
                                  local_block, sharding_axes, sharding_tree)

from .compress import compress_tree, decompress_tree, init_error_buffers
from .optim import (AdamWConfig, abstract_opt_state, adamw_update,
                    init_opt_state, tree_leaves, tree_map, tree_unflatten)

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
    dict), as ``CheckpointManager.save`` takes it; a mesh state already
    is one."""
    return {k: (v.params if isinstance(v, M.Model) else v)
            for k, v in state.items()}


def state_from_tree(cfg: ModelConfig, tree: Dict[str, Any]) -> State:
    """The inverse of :func:`state_tree` (a restored checkpoint): the
    parameters become a trainable :class:`~repro_torch.models.model.Model`
    on the tensors' device."""
    flat = tree_leaves(tree["params"])
    model = M.Model(cfg, dict(flat))
    model.requires_grad_(True)
    return {**tree, "params": model}


# ---------------------------------------------------------------------------
# The step on a (data, model) mesh
# ---------------------------------------------------------------------------
def abstract_state(cfg: ModelConfig, compress_grads: bool = False
                   ) -> Dict[str, Any]:
    """The state's shapes and dtypes as ``meta`` tensors (the reference's
    ``jax.eval_shape`` of ``init_state``)."""
    params = M.abstract_params(cfg)
    out = {"params": params, "opt": abstract_opt_state(params)}
    if compress_grads:
        out["err"] = tree_map(lambda p: torch.empty(
            p.shape, dtype=torch.float32, device="meta"), params)
    return out


def shard_state(tree: Dict[str, Any], shardings: Dict[str, Any]
                ) -> Dict[str, Any]:
    """Each leaf of a full state tree cut to the rank's block."""
    flat = tree_leaves(tree)
    shs = [sh for _, sh in tree_leaves(shardings)]
    return tree_unflatten([p for p, _ in flat],
                          [local_block(x, sh) for (_, x), sh
                           in zip(flat, shs)])


def gather_state(tree: Dict[str, Any], shardings: Dict[str, Any]
                 ) -> Dict[str, Any]:
    """Each leaf of a mesh state whole, on every rank (collective)."""
    flat = tree_leaves(tree)
    shs = [sh for _, sh in tree_leaves(shardings)]
    with torch.no_grad():
        return tree_unflatten([p for p, _ in flat],
                              [gather_full(x, sh) for (_, x), sh
                               in zip(flat, shs)])


def init_mesh_state(cfg: ModelConfig, generator: torch.Generator,
                    shardings: Dict[str, Any], compress_grads: bool = False,
                    device: DeviceLike = None) -> State:
    """:func:`init_state`'s draw (the same numbers from the same
    generator), cut to the rank's blocks under ``shardings``."""
    full = state_tree(init_state(cfg, generator, compress_grads, device))
    with torch.no_grad():
        return shard_state(full, shardings)


def rank_rows(cfg: ModelConfig, mesh, sharding, B: int) -> Tuple[int, int]:
    """(first row, rows) of the global batch of ``B`` rows that the rank
    computes.  A config with experts computes all of them, whatever its
    ``moe_impl``: the reference's expert layer routes the whole batch's
    tokens at once (its capacity, its drops and its aux loss are the
    global batch's), and the all-to-all layer splits the tokens over the
    mesh itself.  Any other config computes a part of its batch block
    under ``sharding``: the block split again over each mesh axis (in the
    mesh's order) that the batch sharding leaves out and that divides what
    is left.  The ranks along an axis that does not divide compute
    alike."""
    if cfg.is_moe:
        return 0, B
    block = block_slices(sharding, (B,))[0]
    rows, index = block.stop - block.start, 0
    used = set(sharding_axes(sharding))
    for a in mesh.mesh_dim_names:
        n = mesh.extent(a)
        if a not in used and rows % n == 0:
            rows, index = rows // n, index * n + mesh.index(a)
    return block.start + index * rows, rows


def jit_train_step(cfg: ModelConfig, ocfg: AdamWConfig, mesh, state_shapes,
                   batch_specs, rules: str = "fsdp_tp", microbatches: int = 1,
                   compress_grads: bool = False):
    """The reference's ``jit_train_step`` on the port's mesh: returns
    ``(step, state shardings, batch shardings)``, the shardings those of
    ``sharding_tree(mesh, state_axes(cfg, compress_grads), state_shapes,
    rules)`` and ``batch_sharding(mesh, batch_specs, rules)``.  Nothing is
    compiled: ``step(state, batch) -> (state, metrics)`` runs eagerly in
    each rank (every rank calls it, with the same collectives in the same
    order), on the rank's blocks of the state, which it updates in place,
    and the rank's block of the batch under the batch shardings.  ``loss``,
    ``grad_norm`` and ``lr`` come back replicated.

    How the rank computes: it gathers every parameter whole
    (:func:`~repro_torch.sharding.gather_full`, one all-gather an axis that
    shards the leaf) and runs the whole model on the rows of
    :func:`rank_rows`, in ``microbatches`` equal pieces, each row in its
    microbatch of the reference's split (rows ``[i B / microbatches,
    (i + 1) B / microbatches)`` of the global batch).  Its loss weighs
    each of its rows' masked NLL sum by 1 / (microbatches x the unmasked
    positions of that row's microbatch), every rank's counts summed by one
    all-reduce before the backward; plus 0.01 x its expert layers' aux
    over the mesh size and the microbatches.  So the ranks' losses and
    gradients sum to the reference's; each gradient is summed over the
    mesh (an all-reduce) and cut to the rank's block, where AdamW runs.

    A dense, SSM or hybrid config computes a part of its batch block
    (split again over ``model`` where the rows divide).  A config with
    experts gathers the whole batch in every rank and computes all of it
    (its counts are then the mesh size times the true ones, and its aux is
    the global batch's in every rank): the reference's expert layer
    routes a microbatch's tokens at once, so an expert's capacity, the
    tokens it drops and the aux loss depend on every row of the
    microbatch, and rows split over the ranks would change all three.
    Under ``moe_impl="a2a"`` the expert layers split those tokens over the
    mesh themselves (``models/moe_a2a.py``, under the current mesh), and
    their collectives read every rank's tokens as the same.  Every rank
    of such a config does the whole batch's work.  Gradients keep
    :func:`make_train_step`'s dtypes: the parameters' with one microbatch
    (the all-reduce too), f32 sums with several.

    ``mesh``: a ``HostMesh`` of ranks, or an ``AbstractMesh`` with
    ``meta`` state and batch (one rank's collectives counted, none run).
    """
    s_shard = sharding_tree(mesh, state_axes(cfg, compress_grads),
                            state_shapes, rules)
    b_shard = batch_sharding(mesh, batch_specs, rules)
    p_flat = tree_leaves(s_shard["params"])
    paths = [p for p, _ in p_flat]
    p_shard = [sh for _, sh in p_flat]
    world = mesh.size
    whole = cfg.is_moe
    B = tuple(batch_specs["tokens"].shape)[0]
    if B % microbatches:
        raise ValueError(f"batch of {B} rows does not split into "
                         f"{microbatches} microbatches")
    first, rows = rank_rows(cfg, mesh, b_shard["tokens"], B)
    # the part of the rank's batch block that it computes
    index = 0 if whole else \
        (first - block_slices(b_shard["tokens"], (B,))[0].start) // rows
    if rows % microbatches:
        raise ValueError(f"a rank's {rows} rows do not split into "
                         f"{microbatches} microbatches")
    # the reference's microbatch of each row the rank computes
    group = (torch.arange(first, first + rows) // (B // microbatches))
    from repro_torch.launch.mesh import all_reduce

    def step(state: State, batch: Dict[str, Any]):
        blocks = [x for _, x in tree_leaves(state["params"])]
        dev = blocks[0].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if whole:
            batch = {k: gather_full(v, b_shard[k]) for k, v in batch.items()}
        else:
            batch = {k: v[index * rows:(index + 1) * rows]
                     for k, v in batch.items()}
        where = group.to(dev)
        with torch.no_grad():
            full = [gather_full(x, sh) for x, sh in zip(blocks, p_shard)]
        model = M.Model(cfg, dict(zip(paths, full)))
        model.requires_grad_(True)
        leaves = [p for _, p in model.named_leaves()]
        size = rows // microbatches
        mb = [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
              for i in range(microbatches)]
        per_row = (batch["targets"] >= 0).to(torch.float32).sum(-1)
        counts = all_reduce(torch.zeros(
            microbatches, dtype=torch.float32, device=dev).index_add_(
                0, where, per_row), mesh)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        gsum = None
        for i, b in enumerate(mb):
            nll, _, aux = M.loss_parts(model, b)
            if microbatches == 1:
                loss = nll.sum() / torch.clamp(counts[0], min=1.0)
            else:
                w = 1.0 / (microbatches * torch.clamp(
                    counts[where[i * size:(i + 1) * size]], min=1.0))
                loss = (nll.sum(-1) * w).sum()
            if aux is not None:
                loss = loss + 0.01 * aux / (world * microbatches)
            grads = torch.autograd.grad(loss, leaves)
            loss_sum = loss_sum + loss.detach()
            if microbatches == 1:
                gsum = grads
            elif gsum is None:
                gsum = [g.to(torch.float32) for g in grads]
            else:
                for acc, g in zip(gsum, grads):
                    acc.add_(g.to(torch.float32))
        del model, leaves, full
        summed = [all_reduce(g, mesh) for g in gsum]
        loss = all_reduce(loss_sum, mesh)
        grads = tree_unflatten(paths, [local_block(g, sh) for g, sh
                                       in zip(summed, p_shard)])
        del summed, gsum
        metrics = {"loss": loss}
        if compress_grads:
            q, scales, state["err"] = compress_tree(grads, state["err"],
                                                    mesh)
            grads = decompress_tree(q, scales)
        _, _, om = adamw_update(grads, state["params"], state["opt"], ocfg,
                                s_shard["params"])
        metrics.update(om)
        return state, metrics

    return step, s_shard, b_shard
