"""Model assembly of the port: the attention families without experts.

A port of the JAX package's ``models/model.py`` for ``family="dense"``
(``paper-scorer``, ``granite-3-2b``, ``deepseek-67b`` and the other dense
configs).  MoE, the SSM and hybrid families, the VLM and audio front ends,
RWKV, M-RoPE and the int8 KV cache raise ``NotImplementedError`` naming
ROADMAP A12.

The parameters live in a :class:`Model` (an ``nn.Module``), stacked per
layer with a leading ``layers`` axis as in the reference, so the JAX
package's parameter pytree carries across leaf for leaf
(:func:`repro_torch.convert.model_params_from_numpy`).  The reference's
entry points keep their names as functions of this module that read the
model:

  init_params(cfg, generator)          — a Model from a torch.Generator
  param_axes / abstract_params         — logical axes; meta-tensor stand-ins
  n_params / n_active_params           — parameter counts
  loss_fn(model, batch)                — next-token CE train loss
  backbone(model, x, positions)        — hidden states after every layer
                                         (each under activation checkpoint
                                         when training with remat="block")
  prefill(model, batch, max_len)       — (cache, last-position logits)
  decode_step(model, cache, batch)     — (logits, cache) for one new token
  make_cache / decode_layer_step

Training: ``model.requires_grad_()`` (``nn.Module``'s) turns the
parameters' gradients on; while one is on and grad mode is on, each
forward takes its per-layer views afresh (:meth:`Model.layers`).  The
optimizer updates the parameters in place, so the views that serving
reads stay bound to them.  ``prefill`` and ``decode_step`` are inference
entry points and run without autograd.

The KV cache is a dict of tensors updated in place (the reference returns
a fresh one; the serving engine never reuses an old cache, so what callers
see is the same).  ``cache["length"]`` is a 0-d int32 tensor on the card
that the decode kernel reads, so a host loop of ``decode_step`` never
waits on the device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, pick_device

from .config import ModelConfig
from .layers import (ParamSpec, Specs, _unported, attention_block,
                     attention_decode_block, attention_specs, mlp_block,
                     mlp_specs, rmsnorm, rmsnorm_specs)

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port's model does not run."""
    if cfg.is_moe:
        raise _unported(f"{cfg.name}: mixture-of-experts layers")
    if cfg.family != "dense":
        raise _unported(f"{cfg.name}: the {cfg.family!r} family")
    if cfg.rwkv:
        raise _unported(f"{cfg.name}: RWKV layers")
    if cfg.mrope:
        raise _unported(f"{cfg.name}: M-RoPE")
    if cfg.kv_quant:
        raise _unported(f"{cfg.name}: the int8 KV cache (kv_quant=True)")


# ---------------------------------------------------------------------------
# Spec tables
# ---------------------------------------------------------------------------
def _prefix(prefix: str, specs: Specs) -> Specs:
    return {f"{prefix}/{k}": v for k, v in specs.items()}


def layer_specs(cfg: ModelConfig) -> Specs:
    """Specs for ONE layer (no leading layers axis)."""
    check_supported(cfg)
    s: Specs = {}
    s.update(_prefix("ln1", rmsnorm_specs(cfg.d_model)))
    s.update(_prefix("ln2", rmsnorm_specs(cfg.d_model)))
    s.update(_prefix("attn", attention_specs(cfg)))
    s.update(_prefix("mlp", mlp_specs(cfg)))
    return s


def model_specs(cfg: ModelConfig) -> Specs:
    s: Specs = {
        "embed/table": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                                 fan_in=cfg.d_model),
        "final_norm/scale": ParamSpec((cfg.d_model,), (None,), fan_in=0),
    }
    if not cfg.tie_embeddings:
        s["lm_head/w"] = ParamSpec((cfg.d_model, cfg.vocab),
                                   ("embed", "vocab"), fan_in=cfg.d_model)
    for k, v in layer_specs(cfg).items():
        s[f"layers/{k}"] = ParamSpec((cfg.n_layers,) + v.shape,
                                     ("layers",) + v.axes, v.fan_in, v.dtype)
    return s


def n_params(cfg: ModelConfig) -> int:
    return sum(math.prod(s.shape) for s in model_specs(cfg).values())


def n_active_params(cfg: ModelConfig) -> int:
    """Per-token active parameters: all of them for the dense family (the
    reference scales its MoE experts by top_k / n_experts)."""
    return n_params(cfg)


def param_axes(cfg: ModelConfig) -> Params:
    """The specs' logical axis names, nested like the parameters (metadata
    for the mesh's sharding rules, ROADMAP A8)."""
    return _nest({p: s.axes for p, s in model_specs(cfg).items()})


def abstract_params(cfg: ModelConfig) -> Params:
    """Meta tensors of the parameters' shapes and dtypes (no storage)."""
    return _nest({p: torch.empty(s.shape, dtype=s.dtype, device="meta")
                  for p, s in model_specs(cfg).items()})


def _nest(flat: Dict[str, Any]) -> Params:
    out: Params = {}
    for path, v in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _attr(path: str) -> str:
    return path.replace("/", "_")


class Model(nn.Module):
    """The parameters of one config, as ``nn.Parameter``s named by their
    reference path (``layers/attn/wq`` -> ``layers_attn_wq``), with
    ``params`` (the reference's nested dict) and ``layer_params`` (one
    nested dict of views per layer) bound to them.  No parameter requires
    a gradient until ``requires_grad_()`` turns them on for training."""

    def __init__(self, cfg: ModelConfig, flat: Dict[str, torch.Tensor]):
        super().__init__()
        specs = model_specs(cfg)
        missing, extra = set(specs) - set(flat), set(flat) - set(specs)
        if missing or extra:
            raise ValueError(f"{cfg.name} parameters: missing "
                             f"{sorted(missing)}, unexpected {sorted(extra)}")
        for path, spec in sorted(specs.items()):
            t = flat[path]
            if tuple(t.shape) != spec.shape:
                raise ValueError(f"{cfg.name} parameter {path}: shape "
                                 f"{tuple(t.shape)}, expected {spec.shape}")
            self.register_parameter(_attr(path),
                                    nn.Parameter(t, requires_grad=False))
        self.cfg = cfg
        self._paths = sorted(specs)
        self._bind()

    def _bind(self) -> None:
        self.params: Params = _nest(
            {p: getattr(self, _attr(p)) for p in self._paths})
        self.layer_params: List[Params] = self._layer_views()

    def _layer_views(self) -> List[Params]:
        per_layer = {p[len("layers/"):]: getattr(self, _attr(p))
                     for p in self._paths if p.startswith("layers/")}
        return [_nest({p: t[i] for p, t in per_layer.items()})
                for i in range(self.cfg.n_layers)]

    @property
    def trainable(self) -> bool:
        return self.params["embed"]["table"].requires_grad

    def layers(self) -> List[Params]:
        """Each layer's parameters: the views bound at construction, or,
        while the parameters require a gradient and grad mode is on, views
        taken now (a view made before its base required a gradient
        carries none)."""
        if self.trainable and torch.is_grad_enabled():
            return self._layer_views()
        return self.layer_params

    def named_leaves(self) -> List[Tuple[str, torch.Tensor]]:
        """``(path, parameter)`` in sorted path order: the reference's tree
        order for the parameter dict."""
        return [(p, getattr(self, _attr(p))) for p in self._paths]

    def _apply(self, fn, *args, **kwargs):
        # .to() / .float() may give the parameters new storage: rebind the
        # nested views to it
        out = super()._apply(fn, *args, **kwargs)
        self._bind()
        return out

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["table"].device

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        return backbone(self, x, positions)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Model:
    """A :class:`Model` with the reference's init scales: zeros for norm
    scales, ``N(0, 1) / sqrt(fan_in)`` otherwise, drawn in f32 from
    ``generator`` (on its own device, one draw per spec in sorted path
    order) and cast to each spec's dtype on ``device`` (the card unless
    the caller says otherwise).  torch's numbers are not JAX's: to compare
    with the reference, carry its parameters across instead."""
    dev = pick_device(device)
    flat = {}
    for path, spec in sorted(model_specs(cfg).items()):
        if spec.fan_in == 0:
            flat[path] = torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
            continue
        w = torch.randn(spec.shape, generator=generator,
                        dtype=torch.float32, device=generator.device)
        w *= 1.0 / math.sqrt(max(spec.fan_in, 1))
        flat[path] = w.to(device=dev, dtype=spec.dtype)
    return Model(cfg, flat)


# ---------------------------------------------------------------------------
# Layer application (backbone / prefill)
# ---------------------------------------------------------------------------
def layer_step(lp: Params, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One backbone layer.  Returns (x, k, v): the layer's keys (after
    RoPE) and values are what prefill stashes in the cache.  The dense
    family has no aux loss."""
    a, k, v = attention_block(rmsnorm(x, lp["ln1"]["scale"], cfg.norm_eps),
                              lp["attn"], cfg, positions)
    x = x + a
    h = rmsnorm(x, lp["ln2"]["scale"], cfg.norm_eps)
    return x + mlp_block(h, lp["mlp"], cfg), k, v


def _embed_inputs(model: Model, batch: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B, S, d), positions (B, S) int32) for
    ``batch["tokens"]`` (B, S) on the model's device."""
    if batch.get("prefix_embeds") is not None \
            or batch.get("positions3") is not None:
        raise _unported("prefix embeddings and M-RoPE positions")
    # F.embedding's backward is deterministic on the card (indexing's
    # index_put_ accumulates with atomics)
    x = F.embedding(batch["tokens"].to(torch.int64),
                    model.params["embed"]["table"])
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return x, positions


def backbone(model: Model, x: torch.Tensor, positions: torch.Tensor
             ) -> torch.Tensor:
    """Every layer in order.  Returns the hidden states (B, S, d) before
    the final norm; the reference's aux loss is zero for this family.
    Under autograd with ``cfg.remat == "block"`` each layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): its
    activations are recomputed in the backward, attention's kernel
    included."""
    cfg = model.cfg
    remat = cfg.remat == "block" and torch.is_grad_enabled() \
        and model.trainable
    for lp in model.layers():
        def fn(h, lp=lp):
            return layer_step(lp, h, positions, cfg)[0]
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    return x


def _logits(model: Model, x: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    x = rmsnorm(x, model.params["final_norm"]["scale"], cfg.norm_eps)
    head = (model.params["embed"]["table"].T if cfg.tie_embeddings
            else model.params["lm_head"]["w"])
    logits = x @ head
    return logits.to(torch.float32) if cfg.logits_f32 else logits


def loss_fn(model: Model, batch: Dict[str, Any]) -> torch.Tensor:
    """Next-token cross-entropy; positions with target < 0 are masked.
    ``batch``: ``tokens`` and ``targets`` (B, S) on the model's device.
    The dense family's aux loss is 0, so the reference's ``+ 0.01 * aux``
    adds nothing."""
    x, positions = _embed_inputs(model, batch)
    x = backbone(model, x, positions)
    logits = _logits(model, x)
    targets = batch["targets"].to(torch.int64)    # (B, S) aligned with x
    mask = (targets >= 0).to(torch.float32)
    t = targets.clamp(min=0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Serving: caches, prefill, decode
# ---------------------------------------------------------------------------
def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Params:
    """A zeroed KV cache: ``length`` (0-d int32) and bf16 ``k``, ``v`` of
    (L, batch, max_len, K, hd), as the reference's."""
    check_supported(cfg)
    dev = pick_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"length": torch.zeros((), dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}


def decode_layer_step(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                      layer_cache: Dict[str, torch.Tensor],
                      length: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """One layer of single-token decode; writes the token's keys and
    values into the layer's caches in place.  Returns x.  (The reference's
    ``decode_layer_step`` drops the caches its attention block wrote, so
    its later decode steps attend over zeros there: ROADMAP queue C.)"""
    h = rmsnorm(x, lp["ln1"]["scale"], cfg.norm_eps)
    x = x + attention_decode_block(h, lp["attn"], cfg, positions,
                                   layer_cache["k"], layer_cache["v"],
                                   length)
    h = rmsnorm(x, lp["ln2"]["scale"], cfg.norm_eps)
    return x + mlp_block(h, lp["mlp"], cfg)


@torch.no_grad()
def decode_step(model: Model, cache: Params, batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Params]:
    """One new token for every sequence in the batch.
    batch: {"tokens": (B, 1) int}.  Returns (logits (B, 1, V), cache), the
    cache updated in place (``length`` one more)."""
    cfg = model.cfg
    tokens = batch["tokens"]
    x = model.params["embed"]["table"][tokens.to(torch.int64)]   # (B,1,d)
    B = x.shape[0]
    length = cache["length"]
    positions = length.expand(B, 1)
    for i, lp in enumerate(model.layer_params):
        x = decode_layer_step(lp, x, cfg,
                              {"k": cache["k"][i], "v": cache["v"][i]},
                              length, positions)
    length.add_(1)
    return _logits(model, x), cache


@torch.no_grad()
def prefill(model: Model, batch: Dict[str, Any], max_len: int
            ) -> Tuple[Params, torch.Tensor]:
    """Inference prefill: the full forward, stashing each layer's K/V (bf16)
    in a fresh cache.  Returns (cache, last-position logits (B, 1, V))."""
    cfg = model.cfg
    x, positions = _embed_inputs(model, batch)
    B, S = x.shape[:2]
    if S > max_len:
        raise ValueError(f"prefill of {S} tokens exceeds max_len {max_len}")
    cache = make_cache(cfg, B, max_len, x.device)
    cache["length"].fill_(S)
    for i, lp in enumerate(model.layer_params):
        x, k, v = layer_step(lp, x, positions, cfg)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    return cache, _logits(model, x[:, -1:])
