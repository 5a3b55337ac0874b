"""AdamW optimizer + LR schedules + global-norm clipping (the port of
``repro/train/optim.py``).  Optimizer state keeps f32 first/second moments
for bf16 params (mixed-precision training: master precision lives in the
moments' update path; see DESIGN.md §6).

Trees are nested dicts of tensors (or a :class:`~repro_torch.models.model.
Model`, read as its ``params``), walked in sorted key order at every level:
the reference's ``jax.tree`` order, so the global norm sums its leaves in
the same order.  ``adamw_update`` updates the parameters and the moments in
place, under ``torch.no_grad()``: views of the parameters (the model's
per-layer dicts that serving reads) stay bound to them.

On a mesh the trees hold each rank's blocks, and ``shardings`` (the
leaves' ``NamedSharding`` s, as ``jit_train_step`` gives them) says how
each leaf is cut.  The update is elementwise on the blocks; only the
global norm needs the other ranks: each leaf's sum of squares is summed
over the ranks that hold its distinct blocks, once per block (a leaf that
a fallback left replicated counts once, not once a rank).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

Tree = Any


def tree_leaves(tree: Tree) -> List[Tuple[str, torch.Tensor]]:
    """``(path, leaf)`` of a nested dict (or a Model's parameters) in the
    reference's tree order."""
    out: List[Tuple[str, torch.Tensor]] = []
    _walk(getattr(tree, "params", tree), "", out)
    return out


def _walk(node: Dict[str, Any], prefix: str,
          out: List[Tuple[str, torch.Tensor]]) -> None:
    # a module-level function: a nested one calling itself is a reference
    # cycle through its closure, which would hold ``out`` (every leaf)
    # until the garbage collector runs
    for k in sorted(node):
        if isinstance(node[k], dict):
            _walk(node[k], f"{prefix}{k}/", out)
        else:
            out.append((f"{prefix}{k}", node[k]))


def tree_unflatten(paths: List[str], leaves: List[Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def tree_map(fn: Callable, tree: Tree) -> Dict[str, Any]:
    flat = tree_leaves(tree)
    return tree_unflatten([p for p, _ in flat], [fn(x) for _, x in flat])


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def init_opt_state(params: Tree) -> Dict[str, Any]:
    """Zero f32 moments shaped like the parameters, on their device, and a
    0-d int32 step."""
    flat = tree_leaves(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=flat[0][1].device)}


def abstract_opt_state(params: Tree) -> Dict[str, Any]:
    """The optimizer state as meta tensors (no storage)."""
    meta = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    return {"m": tree_map(meta, params), "v": tree_map(meta, params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def opt_state_axes(axes: Any) -> Dict[str, Any]:
    """Moments shard exactly like their params."""
    return {"m": axes, "v": axes, "step": ()}


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac (f32, on step's
    device)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    t = (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def _first_copy(mesh, sharding) -> bool:
    """Whether this rank holds the first copy of its block of a leaf: index
    0 along every mesh axis that does not shard it."""
    from repro_torch.sharding import sharding_axes

    cut = set(sharding_axes(sharding))
    return all(mesh.index(a) == 0 for a in mesh.mesh_dim_names
               if a not in cut)


def global_norm(tree: Tree, shardings: Any = None) -> torch.Tensor:
    """The f32 norm of every leaf together, leaves summed in tree order.
    With ``shardings`` (a matching tree of ``NamedSharding`` s) the leaves
    are blocks: one all-reduce of each leaf's block sum of squares over
    the mesh, counted on the first copy of each block only."""
    leaves = [leaf for _, leaf in tree_leaves(tree)]
    squares = [torch.sum(torch.square(x.to(torch.float32)))
               for x in leaves]
    if shardings is not None:
        from repro_torch.launch.mesh import all_reduce

        shs = [sh for _, sh in tree_leaves(shardings)]
        mesh = shs[0].mesh
        own = torch.stack([q if _first_copy(mesh, sh) else torch.zeros_like(q)
                           for q, sh in zip(squares, shs)])
        squares = list(all_reduce(own, mesh).unbind(0))
    total = 0
    for q in squares:
        total = total + q
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Tree, params: Tree, opt_state: Dict[str, Any],
                 cfg: AdamWConfig, shardings: Any = None
                 ) -> Tuple[Tree, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (params, opt_state, metrics) as the
    reference does, but ``params`` and ``opt_state`` are the objects passed
    in, updated in place: each parameter gets its new value in its own
    dtype, the moments theirs in f32, and ``opt_state["step"]`` is one
    more.  ``shardings``: the parameters' (blocks on a mesh)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, shardings)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.to(torch.float32)
    bc1 = 1 - b1 ** sf
    bc2 = 1 - b2 ** sf
    for (_, g), (_, p), (_, m), (_, v) in zip(
            tree_leaves(grads), tree_leaves(params),
            tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])):
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_((1 - b2) * g * g)
        mhat = m / bc1
        vhat = v / bc2
        pf = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
