"""Mixture-of-Experts layer of the port, on one device: top-k softmax gating
with capacity-based dispatch, a port of the JAX package's ``models/moe.py``.

Dispatch is scatter-based and drop-based: each expert takes at most
C = ``capacity(cfg, T)`` of the T * k assignments, in token order; an
overflowing assignment falls through the residual connection (Switch /
GShard semantics).  The three expert products are batched matrix products
over (E, C, ·) (``torch.bmm``; the reference leaves its einsums to XLA,
outside any Pallas kernel).  The all-to-all expert-parallel layer over
the mesh (``moe_impl="a2a"``) is :mod:`.moe_a2a`, which routes with
:func:`route`.

The rounding follows the reference's: router logits, softmax and gates in
f32; the gates cast to the activations' dtype before the gate multiply,
and the sum over the k picks in that dtype.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import ParamSpec, Specs


def moe_specs(cfg: ModelConfig) -> Specs:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, E), ("embed", None), fan_in=d),
        "wi_gate": ParamSpec((E, d, f), ("expert", "embed", "mlp"), fan_in=d),
        "wi_up": ParamSpec((E, d, f), ("expert", "embed", "mlp"), fan_in=d),
        "wo": ParamSpec((E, f, d), ("expert", "mlp", "embed"), fan_in=f),
    }


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Assignments an expert takes: ``ceil(T * k / E * capacity_factor)``
    rounded up to a multiple of 8, at least 8."""
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


class Routing(NamedTuple):
    """Where each of the T * k assignments (token-major) goes."""
    expert: torch.Tensor   # (T, k) int64, the experts in descending gate order
    gates: torch.Tensor    # (T, k) f32, renormalised over the k picks
    pos: torch.Tensor      # (T * k,) int64, the position within the expert
    keep: torch.Tensor     # (T * k,) bool, pos < C
    aux: torch.Tensor      # () f32, the Switch load-balancing loss
    C: int                 # the capacity


def route(xt: torch.Tensor, router: torch.Tensor,
          cfg: ModelConfig) -> Routing:
    """The router for tokens xt (T, d).  Top-k of the softmax, ties to the
    lower expert index as ``jax.lax.top_k`` breaks them (a stable
    descending sort); the gates renormalised by ``clip(sum, 1e-9)``; the
    aux loss ``E * sum_e f_e p_e``; each assignment's position within its
    expert from a stable sort of the expert ids (so in token order) and
    ``searchsorted`` of the segment starts."""
    T = xt.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    logits = (xt @ router).to(torch.float32)                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert = top.values[:, :k], top.indices[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(dim=0)                                    # (E,)
    ce = torch.zeros(E, dtype=torch.float32, device=xt.device).index_add_(
        0, expert.reshape(-1),
        torch.ones(T * k, dtype=torch.float32, device=xt.device)) / (T * k)
    aux = E * torch.sum(me * ce)

    flat_e = expert.reshape(T * k)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(E, dtype=flat_e.dtype, device=xt.device))
    seg_pos = torch.arange(T * k, device=xt.device) - starts[sorted_e]
    pos = torch.empty_like(seg_pos).index_copy_(0, order, seg_pos)
    C = capacity(cfg, T)
    return Routing(expert, gates, pos, pos < C, aux, C)


def moe_block(x: torch.Tensor, p: Dict,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> ((B, S, d), aux loss).  The kept assignments scatter
    into (E, C, d) buffers, dropped ones into a sacrificial slot C that is
    cut off (the only place two rows share a slot, so which one lands
    there does not matter); the SwiGLU experts run as batched products;
    each token gathers its k outputs back, weighted by its gates."""
    B, S, d = x.shape
    k = cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    r = route(xt, p["router"], cfg)
    C = r.C
    flat_e = r.expert.reshape(T * k)
    flat_g = r.gates.reshape(T * k).to(x.dtype)
    slot = torch.where(r.keep, r.pos, C)
    rows = xt[:, None, :].expand(T, k, d).reshape(T * k, d)
    buf = torch.zeros((cfg.n_experts, C + 1, d), dtype=x.dtype,
                      device=x.device)
    buf[flat_e, slot] = rows
    buf = buf[:, :C]

    g = F.silu(torch.bmm(buf, p["wi_gate"]).to(torch.float32))
    u = torch.bmm(buf, p["wi_up"])
    out_buf = torch.bmm(g.to(x.dtype) * u, p["wo"])            # (E, C, d)

    picked = out_buf[flat_e, torch.clamp(slot, max=C - 1)]    # (T * k, d)
    picked = torch.where(r.keep[:, None], picked,
                         torch.zeros((), dtype=picked.dtype,
                                     device=x.device)).to(x.dtype)
    y = (picked * flat_g[:, None]).reshape(T, k, d).sum(dim=1)
    return y.reshape(B, S, d), r.aux
