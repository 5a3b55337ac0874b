"""Model assembly of the port, every family of the reference.

A port of the JAX package's ``models/model.py`` for the ``dense``, ``moe``
(one device), ``vlm``, ``audio``, ``ssm`` and ``hybrid`` families: the
dense configs, the expert layers of ``olmoe-1b-7b`` and
``moonshot-v1-16b-a3b`` (:mod:`.moe`), M-RoPE and the patch embeddings of
``qwen2-vl-2b``, the conditioning frames of ``musicgen-medium``, the int8
KV cache (``kv_quant``) of the attention families, RWKV6 (``rwkv6-3b``)
and zamba2's Mamba2 layers with their shared attention block
(``zamba2-1.2b``; :mod:`.ssm`).  Under ``moe_impl="a2a"`` the backbone's
expert layers run :func:`.moe_a2a.moe_block_a2a` on the mesh of
:func:`repro_torch.sharding.set_current_mesh` (``ValueError`` without one),
and prefill and decode the one-device :func:`.moe.moe_block`, as in the
reference.  The hybrid under ``kv_quant`` is a ``ValueError`` naming R7
(the reference cannot decode it).  The dry-run's ``attn_impl="kernel_stub"`` builds: its stand-in
runs no attention (:func:`.layers.kernel_stub_attention`).

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
  make_cache / cache_specs / cache_axes / decode_layer_step / layer_step

A batch is ``tokens`` (B, S), and for the front ends ``prefix_embeds``
(B, P, d) (the vision stub's patches or the audio stub's frames), put
before the token embeddings, and under M-RoPE ``positions3`` (B, P + S, 3).

Training: ``model.requires_grad_()`` (``nn.Module``'s) turns the
parameters' gradients on; while one is on and grad mode is on, each
forward takes its per-layer views afresh (:meth:`Model.layers`).  The
optimizer updates the parameters in place, so the views that serving
reads stay bound to them.  ``prefill`` and ``decode_step`` are inference
entry points and run without autograd.

The cache is a dict of tensors updated in place (the reference returns
a fresh one; the serving engine never reuses an old cache, so what callers
see is the same), each state written in its entry's dtype.  Under
``kv_quant`` it holds int8 keys and values with bf16 scales a (lane,
position, kv head), which the decode kernel reads as they are.  RWKV's
holds the WKV state and the two token shifts a layer, whatever
``max_len``; the hybrid's the Mamba2 SSM and conv states a layer and the
shared block's K/V an invocation.  ``cache["length"]`` is a 0-d int32
tensor on the card that the decode kernel reads, so a host loop of
``decode_step`` never waits on the device.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, pick_device
from repro_torch.sharding import current_mesh

from .config import ModelConfig
from .layers import (ParamSpec, Specs, attention_block,
                     attention_decode_block, attention_specs, mlp_block,
                     mlp_specs, quantize_kv, rmsnorm, rmsnorm_specs)
from .moe import moe_block, moe_specs
from .moe_a2a import moe_block_a2a
from .ssm import (mamba2_block, mamba2_decode_step, mamba2_specs,
                  rwkv6_channel_mix, rwkv6_specs, rwkv6_time_mix)

Params = Dict[str, Any]


FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for an unknown family and for the hybrid under
    ``kv_quant``, which the reference builds but cannot decode (ROADMAP R7:
    its hybrid cache stays bf16 and its hybrid decode passes no scales to
    the int8 attention)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; "
                         f"known: {FAMILIES}")
    if cfg.family == "hybrid" and cfg.kv_quant:
        raise ValueError(f"{cfg.name}: the hybrid family under kv_quant, "
                         "which the reference cannot decode (ROADMAP R7)")


# ---------------------------------------------------------------------------
# Spec tables
# ---------------------------------------------------------------------------
def _prefix(prefix: str, specs: Specs) -> Specs:
    return {f"{prefix}/{k}": v for k, v in specs.items()}


def layer_specs(cfg: ModelConfig) -> Specs:
    """Specs for ONE layer (no leading layers axis)."""
    check_supported(cfg)
    s: Specs = {}
    if cfg.rwkv:
        s.update(_prefix("ln1", rmsnorm_specs(cfg.d_model)))
        s.update(_prefix("ln2", rmsnorm_specs(cfg.d_model)))
        s.update(rwkv6_specs(cfg))
        return s
    if cfg.family == "hybrid":
        s.update(_prefix("ln1", rmsnorm_specs(cfg.d_model)))
        s.update(_prefix("mamba", mamba2_specs(cfg)))
        return s
    # attention families
    s.update(_prefix("ln1", rmsnorm_specs(cfg.d_model)))
    s.update(_prefix("ln2", rmsnorm_specs(cfg.d_model)))
    s.update(_prefix("attn", attention_specs(cfg)))
    if cfg.is_moe:
        s.update(_prefix("moe", moe_specs(cfg)))
    else:
        s.update(_prefix("mlp", mlp_specs(cfg)))
    return s


def shared_attn_specs(cfg: ModelConfig) -> Specs:
    """zamba2's shared attention (+ MLP) block over concat(hidden,
    embedding)."""
    s: Specs = {}
    s.update(_prefix("ln_in", rmsnorm_specs(2 * cfg.d_model)))
    s.update(_prefix("attn", attention_specs(cfg, d_in=2 * cfg.d_model)))
    s.update(_prefix("ln_mlp", rmsnorm_specs(cfg.d_model)))
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
    if cfg.attn_every:
        for k, v in shared_attn_specs(cfg).items():
            s[f"shared/{k}"] = v
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
    """The specs' logical axis names, nested like the parameters (what
    :func:`repro_torch.sharding.sharding_tree` maps to specs)."""
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
    ``params`` (the reference's nested dict), ``layer_params`` (one
    nested dict of views per layer) and ``shared`` (zamba2's shared block,
    ``params["shared"]``; None elsewhere) bound to them.  No parameter requires
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
        self.shared: Optional[Params] = self.params.get("shared")

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


def _special_init(path: str, spec: ParamSpec,
                  generator: torch.Generator) -> Optional[torch.Tensor]:
    """The reference's ``_special_init``: the SSM leaves' rules, in f32 on
    the generator's device; None for any other leaf."""
    leaf = path.split("/")[-1]
    gdev = generator.device

    def uniform(lo, hi):
        u = torch.rand(spec.shape, generator=generator, dtype=torch.float32,
                       device=gdev)
        return lo + (hi - lo) * u

    if leaf == "A_log":
        return torch.log(uniform(1.0, 16.0))
    if leaf == "dt_bias":         # the inverse softplus of U[1e-3, 1e-1]
        return torch.log(torch.expm1(uniform(1e-3, 1e-1)))
    if leaf == "D":
        return torch.ones(spec.shape, dtype=torch.float32, device=gdev)
    if leaf == "w0":
        return torch.full(spec.shape, -5.0, dtype=torch.float32, device=gdev)
    if leaf.startswith("mu_"):
        return torch.full(spec.shape, 0.5, dtype=torch.float32, device=gdev)
    if leaf == "bonus_u":
        return torch.randn(spec.shape, generator=generator,
                           dtype=torch.float32, device=gdev) * 0.1
    return None


def _device_bytes(device: torch.device) -> int:
    """The memory of the device a draw lands on: a card's total memory, or
    the host's physical memory."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _drawn_in_slices(spec: ParamSpec, beside: int, capacity: int) -> bool:
    """Whether a leaf's whole f32 draw would not fit in ``capacity`` bytes
    beside ``beside`` bytes of parameters (and it has a leading axis to
    slice along)."""
    return len(spec.shape) >= 2 \
        and 4 * math.prod(spec.shape) + beside > capacity


def _normal_leaf(spec: ParamSpec, generator: torch.Generator,
                 dev: torch.device, param_bytes: int) -> torch.Tensor:
    """``N(0, 1) / sqrt(fan_in)`` drawn in f32 on the generator's device and
    cast to the spec's dtype on ``dev``.  One draw of the whole leaf, unless
    that f32 draw would not fit beside the parameters on the generator's
    device: then one draw a slice along the leading axis (a layer's
    stacked weights), in the same generator order, each cast into the
    destination, so the draw never holds more than one slice in f32.  On a
    CPU generator slices of a multiple of 16 elements give the whole draw
    bit for bit; on a card's they need not, which is why only a leaf that
    cannot be drawn whole is sliced."""
    gdev = generator.device
    scale = 1.0 / math.sqrt(max(spec.fan_in, 1))
    beside = param_bytes if gdev.type == dev.type else 0
    if not _drawn_in_slices(spec, beside, _device_bytes(gdev)):
        w = torch.randn(spec.shape, generator=generator,
                        dtype=torch.float32, device=gdev)
        w *= scale
        return w.to(device=dev, dtype=spec.dtype)
    out = torch.empty(spec.shape, dtype=spec.dtype, device=dev)
    for i in range(spec.shape[0]):
        w = torch.randn(spec.shape[1:], generator=generator,
                        dtype=torch.float32, device=gdev)
        w *= scale
        out[i] = w
        del w
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Model:
    """A :class:`Model` with the reference's init: the SSM leaves by
    :func:`_special_init`'s rules (``A_log`` = log U[1, 16], ``dt_bias``
    the inverse softplus of U[1e-3, 1e-1], ``D`` = 1, ``w0`` = -5,
    ``mu_*`` = 0.5, ``bonus_u`` = 0.1 N(0, 1)), zeros for the other leaves
    of fan-in 0 (norm scales, biases), ``N(0, 1) / sqrt(fan_in)``
    otherwise, drawn in f32 from ``generator`` (on its own device, in
    sorted path order) and cast to each spec's dtype on ``device`` (the
    card unless the caller says otherwise).  A leaf whose f32 draw would
    not fit beside the parameters (``moonshot-v1-16b-a3b``'s experts on an
    80 GB card) is drawn a slice at a time (:func:`_normal_leaf`).  torch's
    numbers are not JAX's: to compare with the reference, carry its
    parameters across instead."""
    dev = pick_device(device)
    specs = model_specs(cfg)
    param_bytes = sum(math.prod(s.shape) * s.dtype.itemsize
                      for s in specs.values())
    flat = {}
    for path, spec in sorted(specs.items()):
        special = _special_init(path, spec, generator)
        if special is not None:
            flat[path] = special.to(device=dev, dtype=spec.dtype)
            continue
        if spec.fan_in == 0:
            flat[path] = torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
            continue
        flat[path] = _normal_leaf(spec, generator, dev, param_bytes)
    return Model(cfg, flat)


# ---------------------------------------------------------------------------
# Layer application (backbone / prefill)
# ---------------------------------------------------------------------------
def _shared_block(shared: Params, x: torch.Tensor, x_embed: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig):
    """zamba2's shared attention (+ MLP) block over concat(x, x_embed),
    its attention through the flash kernel.  Returns (x, k, v)."""
    cat = torch.cat([x, x_embed], dim=-1)
    h = rmsnorm(cat, shared["ln_in"]["scale"], cfg.norm_eps)
    a, k, v = attention_block(h, shared["attn"], cfg, positions)
    x = x + a
    h = rmsnorm(x, shared["ln_mlp"]["scale"], cfg.norm_eps)
    return x + mlp_block(h, shared["mlp"], cfg), k, v


def layer_step(lp: Params, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, layer_idx: int = 0,
               shared: Optional[Params] = None,
               x_embed: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """One backbone layer.  Returns (x, state, aux).  ``state`` is what
    prefill stashes in the cache: an attention layer's keys (after RoPE)
    and values ``k``, ``v``; RWKV's WKV state ``wkv`` and the last inputs of
    its two mixers ``tm_x``, ``cm_x`` (the token shifts start from zeros);
    the hybrid's Mamba2 states ``ssm``, ``conv`` and, on a layer whose
    index is a multiple of ``attn_every``, the ``k``, ``v`` of the shared
    block (``shared``, over ``concat(x, x_embed)``, ``x_embed`` the input
    embeddings, prefix included).  aux is the expert layer's
    load-balancing loss, None without experts (where the reference's is
    0)."""
    eps = cfg.norm_eps
    if cfg.rwkv:
        zero = torch.zeros((x.shape[0], 1, cfg.d_model), dtype=x.dtype,
                           device=x.device)
        h, wkv, tm_x = rwkv6_time_mix(rmsnorm(x, lp["ln1"]["scale"], eps),
                                      zero, lp, cfg)
        x = x + h
        h, cm_x = rwkv6_channel_mix(rmsnorm(x, lp["ln2"]["scale"], eps),
                                    zero, lp, cfg)
        return x + h, {"wkv": wkv, "tm_x": tm_x, "cm_x": cm_x}, None
    if cfg.family == "hybrid":
        h, (ssm, conv) = mamba2_block(rmsnorm(x, lp["ln1"]["scale"], eps),
                                      lp["mamba"], cfg, return_state=True)
        x = x + h
        state = {"ssm": ssm, "conv": conv}
        if cfg.attn_every and shared is not None \
                and layer_idx % cfg.attn_every == 0:
            x, state["k"], state["v"] = _shared_block(shared, x, x_embed,
                                                      positions, cfg)
        return x, state, None
    a, k, v = attention_block(rmsnorm(x, lp["ln1"]["scale"], eps),
                              lp["attn"], cfg, positions)
    x = x + a
    h = rmsnorm(x, lp["ln2"]["scale"], eps)
    if cfg.is_moe and cfg.moe_impl == "a2a":
        m, aux = moe_block_a2a(h, lp["moe"], cfg, current_mesh())
    elif cfg.is_moe:
        m, aux = moe_block(h, lp["moe"], cfg)
    else:
        m, aux = mlp_block(h, lp["mlp"], cfg), None
    return x + m, {"k": k, "v": v}, aux


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
    x_embed = x if cfg.attn_every else None
    aux = None
    for i, lp in enumerate(model.layers()):
        def fn(h, e, lp=lp, i=i):
            out = layer_step(lp, h, positions, cfg, i, model.shared, e)
            return out[0], out[2]
        x, a = checkpoint(fn, x, x_embed, use_reentrant=False) if remat \
            else fn(x, x_embed)
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
def cache_specs(cfg: ModelConfig, batch: int, max_len: int
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{entry: (shape, dtype)}`` of :func:`make_cache`'s cache."""
    check_supported(cfg)
    L = cfg.n_layers
    c = {"length": ((), torch.int32)}
    if cfg.rwkv:
        hd = cfg.ssm_head_dim
        c["wkv"] = ((L, batch, cfg.d_model // hd, hd, hd), torch.float32)
        c["tm_x"] = ((L, batch, 1, cfg.d_model), torch.bfloat16)
        c["cm_x"] = ((L, batch, 1, cfg.d_model), torch.bfloat16)
        return c
    n_kv = L
    if cfg.family == "hybrid":
        c["ssm"] = ((L, batch, cfg.n_ssm_heads, cfg.ssm_state,
                     cfg.ssm_head_dim), torch.float32)
        c["conv"] = ((L, batch, cfg.ssm_conv - 1,
                      cfg.d_inner + 2 * cfg.ssm_state), torch.bfloat16)
        n_kv = cfg.n_shared_attn
    shape = (n_kv, batch, max_len, cfg.n_kv_heads, cfg.hd)
    kv_dt = torch.int8 if cfg.kv_quant else torch.bfloat16
    c["k"] = (shape, kv_dt)
    c["v"] = (shape, kv_dt)
    if cfg.kv_quant:
        for name in ("k_scale", "v_scale"):
            c[name] = (shape[:-1], torch.bfloat16)
    return c


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Params:
    """A zeroed cache with the reference's entries and dtypes: ``length``
    (0-d int32) and
    - attention families: ``k``, ``v`` of (L, batch, max_len, K, hd), bf16,
      or int8 under ``kv_quant`` with bf16 ``k_scale`` and ``v_scale``
      (L, batch, max_len, K);
    - RWKV: ``wkv`` (L, batch, H, hd, hd) f32 and the token shifts
      ``tm_x``, ``cm_x`` (L, batch, 1, d) bf16, none of them depending on
      ``max_len``;
    - hybrid: ``ssm`` (L, batch, H, N, P) f32, ``conv`` (L, batch, k - 1,
      d_inner + 2N) bf16 and the shared block's ``k``, ``v``
      (n_shared_attn, batch, max_len, K, hd) bf16."""
    specs = cache_specs(cfg, batch, max_len)
    dev = pick_device(device)
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, (shape, dtype) in specs.items()}


def cache_axes(cfg: ModelConfig) -> Params:
    """Logical axes of the cache's entries (batch over data, heads over
    model): what :func:`repro_torch.sharding.sharding_tree` maps to
    specs."""
    check_supported(cfg)
    kv = (None, "batch", "kv_seq", "kv_cache_heads", None)
    ax: Params = {"length": ()}
    if cfg.rwkv:
        ax["wkv"] = (None, "batch", "ssm_heads", None, None)
        ax["tm_x"] = ax["cm_x"] = (None, "batch", None, None)
        return ax
    if cfg.family == "hybrid":
        ax["ssm"] = (None, "batch", "ssm_heads", None, None)
        ax["conv"] = (None, "batch", None, None)
    ax["k"] = ax["v"] = kv
    if cfg.kv_quant:
        ax["k_scale"] = ax["v_scale"] = kv[:-1]
    return ax


# the entries a layer of each family reads and writes at decode (the
# hybrid's k and v belong to the shared block's invocations, not to layers)
_LAYER_ENTRIES = ("k", "v", "k_scale", "v_scale", "wkv", "tm_x", "cm_x")
_HYBRID_ENTRIES = ("ssm", "conv")


def decode_layer_step(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                      layer_cache: Dict[str, torch.Tensor],
                      length: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """One layer of single-token decode; writes the layer's states in
    place, each cast to its entry's dtype: an attention layer's token keys
    and values (under ``kv_quant`` their int8 values and scales), RWKV's
    ``wkv``, ``tm_x`` and ``cm_x``, the hybrid's Mamba2 ``ssm`` and
    ``conv`` (its shared block is :func:`decode_step`'s).  Returns x.
    (The reference's ``decode_layer_step`` drops the caches its attention
    block wrote, and under ``kv_quant`` keeps the scales but drops the
    int8 values, so its later decode steps attend over zeros there:
    ROADMAP queue C, R5.  Its RWKV and hybrid decode keep every state.)"""
    eps = cfg.norm_eps
    if cfg.rwkv:
        h = rmsnorm(x, lp["ln1"]["scale"], eps)
        h, wkv, tm_x = rwkv6_time_mix(h, layer_cache["tm_x"], lp, cfg,
                                      state0=layer_cache["wkv"])
        x = x + h
        h = rmsnorm(x, lp["ln2"]["scale"], eps)
        h, cm_x = rwkv6_channel_mix(h, layer_cache["cm_x"], lp, cfg)
        for name, t in (("wkv", wkv), ("tm_x", tm_x), ("cm_x", cm_x)):
            layer_cache[name].copy_(t)
        return x + h
    if cfg.family == "hybrid":
        h = rmsnorm(x, lp["ln1"]["scale"], eps)
        h, ssm, conv = mamba2_decode_step(h, lp["mamba"], cfg,
                                          layer_cache["ssm"],
                                          layer_cache["conv"])
        layer_cache["ssm"].copy_(ssm)
        layer_cache["conv"].copy_(conv)
        return x + h
    h = rmsnorm(x, lp["ln1"]["scale"], eps)
    x = x + attention_decode_block(h, lp["attn"], cfg, positions,
                                   layer_cache["k"], layer_cache["v"],
                                   length, layer_cache.get("k_scale"),
                                   layer_cache.get("v_scale"))
    h = rmsnorm(x, lp["ln2"]["scale"], eps)
    if cfg.is_moe:
        return x + moe_block(h, lp["moe"], cfg)[0]
    return x + mlp_block(h, lp["mlp"], cfg)


def _shared_decode(shared: Params, x: torch.Tensor, x_embed: torch.Tensor,
                   positions: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, length: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """One token through zamba2's shared block: its attention through the
    decode kernel over the invocation's caches, written in place."""
    cat = torch.cat([x, x_embed], dim=-1)
    h = rmsnorm(cat, shared["ln_in"]["scale"], cfg.norm_eps)
    x = x + attention_decode_block(h, shared["attn"], cfg, positions,
                                   k_cache, v_cache, length)
    h = rmsnorm(x, shared["ln_mlp"]["scale"], cfg.norm_eps)
    return x + mlp_block(h, shared["mlp"], cfg)


@torch.no_grad()
def decode_step(model: Model, cache: Params, batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Params]:
    """One new token for every sequence in the batch.
    batch: {"tokens": (B, 1) int}, and under M-RoPE optionally
    ``positions3`` (B, 1, 3) (else ``length`` in all three streams).
    Returns (logits (B, 1, V), cache), the cache updated in place
    (``length`` one more).  The hybrid runs its shared block after the
    Mamba2 mixer of every ``attn_every``-th layer, on the caches of
    invocation ``layer // attn_every``, over the token's embedding."""
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
    hybrid = cfg.family == "hybrid"
    x_embed = x
    entries = _HYBRID_ENTRIES if hybrid \
        else [n for n in _LAYER_ENTRIES if n in cache]
    for i, lp in enumerate(model.layer_params):
        x = decode_layer_step(lp, x, cfg, {n: cache[n][i] for n in entries},
                              length, positions)
        if hybrid and cfg.attn_every and i % cfg.attn_every == 0:
            j = i // cfg.attn_every
            x = _shared_decode(model.shared, x, x_embed, positions,
                               cache["k"][j], cache["v"][j], length, cfg)
    length.add_(1)
    return _logits(model, x), cache


@torch.no_grad()
def prefill(model: Model, batch: Dict[str, Any], max_len: int
            ) -> Tuple[Params, torch.Tensor]:
    """Inference prefill: the full forward, stashing each layer's state in
    a fresh cache (:func:`make_cache`): the attention layers' K/V, bf16 or
    under ``kv_quant`` quantized from their bf16 copies; RWKV's WKV state
    and last mixer inputs; the hybrid's Mamba2 states and its shared
    block's K/V, as the reference's.  Returns (cache, last-position logits
    (B, 1, V)).  Raises ValueError for a sequence longer than ``max_len``
    (but under RWKV, whose cache has no positions) and for a hybrid prompt
    shorter than ``ssm_conv - 1``, whose conv state the reference gets
    the wrong shape for (ROADMAP R7)."""
    cfg = model.cfg
    x, positions = _embed_inputs(model, batch)
    B, S = x.shape[:2]
    if S > max_len and not cfg.rwkv:
        raise ValueError(f"prefill of {S} tokens exceeds max_len {max_len}")
    hybrid = cfg.family == "hybrid"
    if hybrid and S < cfg.ssm_conv - 1:
        raise ValueError(
            f"{cfg.name}: a prefill of {S} tokens is shorter than the conv "
            f"state's {cfg.ssm_conv - 1} rows, which the reference cannot "
            "decode from (ROADMAP R7)")
    cache = make_cache(cfg, B, max_len, x.device)
    cache["length"].fill_(S)
    x_embed = x if cfg.attn_every else None
    # the reference's prefill runs its attention whatever attn_impl says
    # (the dry-run's stand-in is the backbone's alone), and its experts on
    # one device whatever moe_impl says
    run_cfg = cfg.replace(
        attn_impl=("chunked" if cfg.attn_impl == "kernel_stub"
                   else cfg.attn_impl), moe_impl="gspmd")
    for i, lp in enumerate(model.layer_params):
        x, state, _ = layer_step(lp, x, positions, run_cfg, i, model.shared,
                                 x_embed)
        if "k" in state:
            j = i // cfg.attn_every if hybrid else i
            if cfg.kv_quant:
                for name in ("k", "v"):
                    cache[name][j, :, :S], cache[f"{name}_scale"][j, :, :S] \
                        = quantize_kv(state[name].to(torch.bfloat16))
            else:
                cache["k"][j, :, :S] = state["k"]
                cache["v"][j, :, :S] = state["v"]
        for name in ("wkv", "tm_x", "cm_x", "ssm", "conv"):
            if name in state:
                cache[name][i] = state[name]
    return cache, _logits(model, x[:, -1:])
