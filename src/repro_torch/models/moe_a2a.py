"""Expert-parallel MoE over the mesh with explicit all-to-all exchanges, a
port of the JAX package's ``models/moe_a2a.py``.

Every rank routes its own tokens, packs one capacity buffer a destination
shard, and one all-to-all over the ``model`` axis moves exactly the token
payload each way.  Layout (the reference's ``shard_map`` specs):

  x       : (T, d)     rank r takes tokens [r * T_my, (r + 1) * T_my), the
                       batch spec over ("data", "model") (rank order)
  router  : (d, E)     replicated
  wi / wo : (E, ·, ·)  sharded over "model": e_loc = E / n_model experts a
                       rank

SPMD: every rank is handed the global ``x`` and the global parameters
(``convert.model_params_from_numpy``'s leaves), takes its block, and gathers
``y`` back over the mesh, so every rank returns the global ``(B, S, d)``.
The collectives are :mod:`repro_torch.launch.mesh`'s, differentiable: the
input gradient comes back whole on every rank, the router's is summed over
the mesh and the experts' over the data axes.

The received buffers are regrouped by local expert before the expert
products ((n_model, e_loc, cap, d) -> (e_loc, n_model * cap, d) through a
transpose), so each token meets the expert it was routed to at every
``e_loc``.  The reference reshapes without the transpose, which is the
same only at ``e_loc = 1`` (ROADMAP R8).  The expert products stay
``torch.bmm``, as the reference leaves its einsums to XLA outside any
Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import (all_gather, all_reduce, all_to_all,
                                     replicate, shard)

from .config import ModelConfig
from .moe import route


def a2a_capacity(cfg: ModelConfig, t_my: int) -> int:
    """Slots a source rank gives each destination expert: the reference's
    ``max(8, ceil(T_my * k / E * capacity_factor / 8) * 8)``."""
    return max(8, int(math.ceil(t_my * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor / 8)) * 8)


def moe_block_a2a(x: torch.Tensor, p: Dict, cfg: ModelConfig,
                  mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d), the same on every rank -> ((B, S, d) on every rank,
    the aux loss averaged over the mesh).  ``mesh`` is the
    :class:`~repro_torch.launch.mesh.HostMesh` of
    :func:`repro_torch.sharding.set_current_mesh`; ``ValueError`` without
    one, and when the tokens or the experts do not split over it."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    if mesh is None:
        raise ValueError(
            f"{cfg.name}: moe_impl='a2a' runs on a mesh and none is set: "
            "call repro_torch.sharding.set_current_mesh in every rank "
            "(repro_torch.launch.mesh.spawn starts them)")
    n_model = mesh.extent("model")
    if T % mesh.size or E % n_model:
        raise ValueError(
            f"{cfg.name}: moe_impl='a2a' on mesh {mesh.shape} needs the "
            f"tokens (B * S = {T}) to split over its {mesh.size} ranks and "
            f"the {E} experts over its model axis of {n_model}")
    e_loc, t_my = E // n_model, T // mesh.size
    cap = a2a_capacity(cfg, t_my)
    data_axes = [a for a in mesh.mesh_dim_names if a != "model"]

    xt = shard(x.reshape(T, d), mesh)                          # (T_my, d)
    router = replicate(p["router"], mesh)
    w = {}
    for name in ("wi_gate", "wi_up", "wo"):
        leaf = p[name]
        for a in data_axes:
            leaf = replicate(leaf, mesh, a)
        w[name] = shard(leaf, mesh, "model")                   # (e_loc, ., .)

    r = route(xt, router, cfg)
    keep = r.pos < cap
    slot = torch.where(keep, r.pos, cap)
    flat_e = r.expert.reshape(t_my * k)
    rows = xt[:, None, :].expand(t_my, k, d).reshape(t_my * k, d)
    send = torch.zeros((E, cap + 1, d), dtype=x.dtype, device=x.device)
    send = send.index_put((flat_e, slot), rows)[:, :cap]
    # block j for the model rank j that holds experts [j*e_loc, (j+1)*e_loc)
    recv = all_to_all(send.reshape(n_model, e_loc, cap, d), mesh, "model")
    buf = recv.transpose(0, 1).reshape(e_loc, n_model * cap, d)
    g = F.silu(torch.bmm(buf, w["wi_gate"]).to(torch.float32))
    u = torch.bmm(buf, w["wi_up"])
    out = torch.bmm(g.to(x.dtype) * u, w["wo"])        # (e_loc, n*cap, d)
    back = out.reshape(e_loc, n_model, cap, d).transpose(0, 1)
    recv_back = all_to_all(back, mesh, "model").reshape(E, cap, d)

    picked = recv_back[flat_e, torch.clamp(slot, max=cap - 1)]
    picked = torch.where(keep[:, None], picked,
                         torch.zeros((), dtype=picked.dtype,
                                     device=x.device)).to(x.dtype)
    flat_g = r.gates.reshape(t_my * k).to(x.dtype)
    y = (picked * flat_g[:, None]).reshape(t_my, k, d).sum(dim=1)
    y = all_gather(y, mesh).reshape(B, S, d)
    # the local load-balance estimate, averaged over model, then the data
    # axes (equal-sized groups: the mean of means is the mesh mean)
    aux = all_reduce(r.aux, mesh, "model") / n_model
    for a in data_axes:
        aux = all_reduce(aux, mesh, a) / mesh.extent(a)
    return y, aux
