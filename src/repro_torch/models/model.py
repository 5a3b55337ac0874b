"""Model assembly of the port: the attention families.

A port of the JAX package's ``models/model.py`` for the ``dense``, ``moe``
(one device), ``vlm`` and ``audio`` families: the dense configs, the
expert layers of ``olmoe-1b-7b`` and ``moonshot-v1-16b-a3b``
(:mod:`.moe`), M-RoPE and the patch embeddings of ``qwen2-vl-2b``, the
conditioning frames of ``musicgen-medium``, and the int8 KV cache
(``kv_quant``) of any of them.  The SSM and hybrid families and RWKV
raise ``NotImplementedError`` naming ROADMAP A12, the all-to-all expert
layer (``moe_impl="a2a"``) naming A8, and the dry-run's
``attn_impl="kernel_stub"`` naming A12.

The parameters live in a :class:`Model` (an ``nn.Module``), stacked per
layer with a leading ``layers`` axis as in the reference, so the JAX
package's parameter pytree carries across leaf for leaf
(:func:`repro_torch.convert.model_params_from_numpy`).  The reference's
entry points keep their names as functions of this module that read the
model:

  init_params(cfg, generator)          — a Model from a torch.Generator
  param_axes / abstract_params         — logical axes; meta-tensor stand-ins
  n_params / n_active_params           — parameter counts
  loss_fn(model, batch)                — next-token CE train loss, plus
                                         0.01 x the experts' aux loss
  backbone(model, x, positions)        — hidden states after every layer
                                         (each under activation checkpoint
                                         when training with remat="block")
  prefill(model, batch, max_len)       — (cache, last-position logits)
  decode_step(model, cache, batch)     — (logits, cache) for one new token
  make_cache / cache_axes / decode_layer_step

A batch is ``tokens`` (B, S), and for the front ends ``prefix_embeds``
(B, P, d) (the vision stub's patches or the audio stub's frames), put
before the token embeddings, and under M-RoPE ``positions3`` (B, P + S, 3).

Training: ``model.requires_grad_()`` (``nn.Module``'s) turns the
parameters' gradients on; while one is on and grad mode is on, each
forward takes its per-layer views afresh (:meth:`Model.layers`).  The
optimizer updates the parameters in place, so the views that serving
reads stay bound to them.  ``prefill`` and ``decode_step`` are inference
entry points and run without autograd.

The KV cache is a dict of tensors updated in place (the reference returns
a fresh one; the serving engine never reuses an old cache, so what callers
see is the same).  Under ``kv_quant`` it holds int8 keys and values with
bf16 scales a (lane, position, kv head), which the decode kernel reads as
they are.  ``cache["length"]`` is a 0-d int32 tensor on the card
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
                     mlp_specs, quantize_kv, rmsnorm, rmsnorm_specs)
from .moe import moe_block, moe_specs

Params = Dict[str, Any]


FAMILIES = ("dense", "moe", "vlm", "audio")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port's model does not run."""
    if cfg.rwkv:
        raise _unported(f"{cfg.name}: RWKV layers")
    if cfg.family not in FAMILIES:
        raise _unported(f"{cfg.name}: the {cfg.family!r} family")
    if cfg.is_moe and cfg.moe_impl == "a2a":
        raise _unported(f"{cfg.name}: the all-to-all expert layer "
                        "(moe_impl='a2a'), which needs the mesh", "A8")
    if cfg.attn_impl == "kernel_stub":
        raise _unported(f"{cfg.name}: attn_impl='kernel_stub' (the "
                        "dry-run's stand-in)")


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
    if cfg.is_moe:
        s.update(_prefix("moe", moe_specs(cfg)))
    else:
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
    """Per-token active parameters: the experts' weights (``/moe/w``
    leaves; not the router) count top_k / n_experts of their size."""
    total = 0
    for p, s in model_specs(cfg).items():
        sz = math.prod(s.shape)
        if "/moe/w" in p:
            sz = sz * cfg.top_k // cfg.n_experts
        total += sz
    return total


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
               cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor, Any]:
    """One backbone layer.  Returns (x, k, v, aux): the layer's keys (after
    RoPE) and values are what prefill stashes in the cache; aux is the
    expert layer's load-balancing loss, None without experts (where the
    reference's is 0)."""
    a, k, v = attention_block(rmsnorm(x, lp["ln1"]["scale"], cfg.norm_eps),
                              lp["attn"], cfg, positions)
    x = x + a
    h = rmsnorm(x, lp["ln2"]["scale"], cfg.norm_eps)
    if cfg.is_moe:
        m, aux = moe_block(h, lp["moe"], cfg)
    else:
        m, aux = mlp_block(h, lp["mlp"], cfg), None
    return x + m, k, v, aux


def _embed_inputs(model: Model, batch: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B, S, d), positions) for ``batch["tokens"]`` (B, S) on
    the model's device, after ``batch["prefix_embeds"]`` (B, P, d) where
    it is given (cast to the embeddings' dtype; S counts it then).  The
    positions are ``batch["positions3"]`` (B, S, 3) under M-RoPE, else
    (B, S) int32 ``arange(S)``."""
    # F.embedding's backward is deterministic on the card (indexing's
    # index_put_ accumulates with atomics)
    x = F.embedding(batch["tokens"].to(torch.int64),
                    model.params["embed"]["table"])
    prefix = batch.get("prefix_embeds")     # vlm patches / audio frames
    if prefix is not None:
        x = torch.cat([prefix.to(device=x.device, dtype=x.dtype), x], dim=1)
    B, S = x.shape[:2]
    if model.cfg.mrope:
        if batch.get("positions3") is None:
            raise ValueError(f"{model.cfg.name} uses M-RoPE: the batch needs "
                             "positions3 (B, S, 3)")
        return x, batch["positions3"].to(x.device)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return x, positions


def _backbone(model: Model, x: torch.Tensor, positions: torch.Tensor
              ) -> Tuple[torch.Tensor, Any]:
    """Every layer in order.  Returns (hidden states (B, S, d) before the
    final norm, the expert layers' aux losses summed in f32, or None
    without experts)."""
    cfg = model.cfg
    remat = cfg.remat == "block" and torch.is_grad_enabled() \
        and model.trainable
    aux = None
    for lp in model.layers():
        def fn(h, lp=lp):
            out = layer_step(lp, h, positions, cfg)
            return out[0], out[3]
        x, a = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def backbone(model: Model, x: torch.Tensor, positions: torch.Tensor
             ) -> torch.Tensor:
    """Every layer in order.  Returns the hidden states (B, S, d) before
    the final norm (the reference also returns the summed aux loss:
    :func:`loss_fn` adds it).  Under autograd with ``cfg.remat == "block"``
    each layer runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``): its activations are recomputed in the backward,
    attention's kernel included."""
    return _backbone(model, x, positions)[0]


def _logits(model: Model, x: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    x = rmsnorm(x, model.params["final_norm"]["scale"], cfg.norm_eps)
    head = (model.params["embed"]["table"].T if cfg.tie_embeddings
            else model.params["lm_head"]["w"])
    logits = x @ head
    return logits.to(torch.float32) if cfg.logits_f32 else logits


def loss_fn(model: Model, batch: Dict[str, Any]) -> torch.Tensor:
    """Next-token cross-entropy; positions with target < 0 are masked.
    ``batch``: ``tokens`` and ``targets`` (B, S_total, the prefix
    included), with the front ends' ``prefix_embeds`` and ``positions3``
    where the config has them, on the model's device.  Plus 0.01 x the
    summed aux loss of the expert layers (0 without experts), as the
    reference's."""
    x, positions = _embed_inputs(model, batch)
    x, aux = _backbone(model, x, positions)
    logits = _logits(model, x)
    targets = batch["targets"].to(torch.int64)    # (B, S) aligned with x
    mask = (targets >= 0).to(torch.float32)
    t = targets.clamp(min=0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t[..., None])[..., 0]
    nll = (logz - gold) * mask
    loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss if aux is None else loss + 0.01 * aux


# ---------------------------------------------------------------------------
# Serving: caches, prefill, decode
# ---------------------------------------------------------------------------
def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Params:
    """A zeroed KV cache, as the reference's: ``length`` (0-d int32) and
    ``k``, ``v`` of (L, batch, max_len, K, hd), bf16, or int8 under
    ``kv_quant`` with bf16 ``k_scale`` and ``v_scale`` (L, batch, max_len,
    K)."""
    check_supported(cfg)
    dev = pick_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    kv_dt = torch.int8 if cfg.kv_quant else torch.bfloat16
    c = {"length": torch.zeros((), dtype=torch.int32, device=dev),
         "k": torch.zeros(shape, dtype=kv_dt, device=dev),
         "v": torch.zeros(shape, dtype=kv_dt, device=dev)}
    if cfg.kv_quant:
        for name in ("k_scale", "v_scale"):
            c[name] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                  device=dev)
    return c


def cache_axes(cfg: ModelConfig) -> Params:
    """Logical axes of the cache's entries (batch over data, heads over
    model): metadata for the mesh's sharding rules (ROADMAP A8)."""
    check_supported(cfg)
    kv = (None, "batch", "kv_seq", "kv_cache_heads", None)
    ax: Params = {"length": (), "k": kv, "v": kv}
    if cfg.kv_quant:
        ax["k_scale"] = ax["v_scale"] = kv[:-1]
    return ax


_LAYER_ENTRIES = ("k", "v", "k_scale", "v_scale")


def decode_layer_step(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                      layer_cache: Dict[str, torch.Tensor],
                      length: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """One layer of single-token decode; writes the token's keys and
    values (under ``kv_quant`` their int8 values and scales) into the
    layer's caches in place.  Returns x.  (The reference's
    ``decode_layer_step`` drops the caches its attention block wrote, and
    under ``kv_quant`` keeps the scales but drops the int8 values, so its
    later decode steps attend over zeros there: ROADMAP queue C, R5.)"""
    h = rmsnorm(x, lp["ln1"]["scale"], cfg.norm_eps)
    x = x + attention_decode_block(h, lp["attn"], cfg, positions,
                                   layer_cache["k"], layer_cache["v"],
                                   length, layer_cache.get("k_scale"),
                                   layer_cache.get("v_scale"))
    h = rmsnorm(x, lp["ln2"]["scale"], cfg.norm_eps)
    if cfg.is_moe:
        return x + moe_block(h, lp["moe"], cfg)[0]
    return x + mlp_block(h, lp["mlp"], cfg)


@torch.no_grad()
def decode_step(model: Model, cache: Params, batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Params]:
    """One new token for every sequence in the batch.
    batch: {"tokens": (B, 1) int}, and under M-RoPE optionally
    ``positions3`` (B, 1, 3) (else ``length`` in all three streams).
    Returns (logits (B, 1, V), cache), the cache updated in place
    (``length`` one more)."""
    cfg = model.cfg
    tokens = batch["tokens"]
    x = model.params["embed"]["table"][tokens.to(torch.int64)]   # (B,1,d)
    B = x.shape[0]
    length = cache["length"]
    if cfg.mrope:
        # the serving layer tracks the M-RoPE position streams
        positions = batch.get("positions3")
        positions = length.expand(B, 1, 3) if positions is None \
            else positions.to(x.device)
    else:
        positions = length.expand(B, 1)
    entries = [n for n in _LAYER_ENTRIES if n in cache]
    for i, lp in enumerate(model.layer_params):
        x = decode_layer_step(lp, x, cfg, {n: cache[n][i] for n in entries},
                              length, positions)
    length.add_(1)
    return _logits(model, x), cache


@torch.no_grad()
def prefill(model: Model, batch: Dict[str, Any], max_len: int
            ) -> Tuple[Params, torch.Tensor]:
    """Inference prefill: the full forward, stashing each layer's K/V in a
    fresh cache: bf16, or under ``kv_quant`` quantized from their bf16
    copies, as the reference's.  Returns (cache, last-position logits
    (B, 1, V))."""
    cfg = model.cfg
    x, positions = _embed_inputs(model, batch)
    B, S = x.shape[:2]
    if S > max_len:
        raise ValueError(f"prefill of {S} tokens exceeds max_len {max_len}")
    cache = make_cache(cfg, B, max_len, x.device)
    cache["length"].fill_(S)
    for i, lp in enumerate(model.layer_params):
        x, k, v, _ = layer_step(lp, x, positions, cfg)
        if cfg.kv_quant:
            for name, t in (("k", k), ("v", v)):
                cache[name][i, :, :S], cache[f"{name}_scale"][i, :, :S] = \
                    quantize_kv(t.to(torch.bfloat16))
        else:
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
    return cache, _logits(model, x[:, -1:])
