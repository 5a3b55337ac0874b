"""Core transformer layers of the port: RMSNorm, RoPE, GQA attention through
the hand-written flash and decode kernels, SwiGLU MLP.  A port of the JAX
package's ``models/layers.py`` for the attention families; M-RoPE, the int8
KV cache and the custom VJP are not ported (ROADMAP A12).

Parameter convention, as in the reference: every builder contributes to a
flat ``{path: ParamSpec(shape, axes, fan_in)}`` dict, and per-layer params
are stacked with a leading ``layers`` axis.  The arithmetic follows the
reference's: norms and RoPE in f32 inside, matrix products in the
parameters' dtype (``torch.matmul``, as the reference leaves them to XLA).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.ops import \
    decode_attention as _decode_kernel_op
from repro_torch.kernels.flash_attention.ops import flash_attention

from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    fan_in: int = 0          # 0 => init to zeros (norm scales)
    dtype: torch.dtype = torch.bfloat16


Specs = Dict[str, ParamSpec]


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP A12)")


# ---------------------------------------------------------------------------
# Norm
# ---------------------------------------------------------------------------
def rmsnorm_specs(d: int) -> Specs:
    return {"scale": ParamSpec((d,), (None,), fan_in=0)}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Forward only: f32 inside, scaled by ``1 + scale``, x's dtype out."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, N, hd); positions: (B, S) int.  Half-split rotation (the
    first and second halves of hd pair up), f32 inside."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs      # (B,S,hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def attention_specs(cfg: ModelConfig, d_in: Optional[int] = None) -> Specs:
    d = d_in or cfg.d_model
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamSpec((d, H * hd), ("embed", "qheads"), fan_in=d),
        "wk": ParamSpec((d, K * hd), ("embed", "kvheads"), fan_in=d),
        "wv": ParamSpec((d, K * hd), ("embed", "kvheads"), fan_in=d),
        "wo": ParamSpec((H * hd, cfg.d_model), ("qheads", "embed"),
                        fan_in=H * hd),
    }


def _qkv(x: torch.Tensor, p: Dict, cfg: ModelConfig):
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    v = (x @ p["wv"]).reshape(B, S, K, hd)
    return q, k, v


def _position_encode(q, k, positions, cfg: ModelConfig):
    if cfg.mrope:
        raise _unported("M-RoPE (mrope=True)")
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def causal_attention(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """The attention of a prefill or backbone layer by ``cfg.attn_impl``:
    ``"chunked"`` (the reference's jnp stand-in for the flash kernel) and
    ``"pallas"`` run the ``flash_attention`` op, hand-written CUDA on the
    card.  ``"naive"`` raises: it would run plain PyTorch on the card in
    place of the kernel (the plain version is the op's CPU path)."""
    if cfg.attn_impl in ("chunked", "pallas"):
        return flash_attention(q, k, v)
    if cfg.attn_impl == "kernel_stub":
        raise _unported("attn_impl='kernel_stub' (the dry-run's stand-in)")
    if cfg.attn_impl == "naive":
        raise ValueError("attn_impl='naive' is not offered: attention runs "
                         "through the flash_attention op")
    raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


def decode_attention(q, k_cache, v_cache, length,
                     cfg: ModelConfig) -> torch.Tensor:
    """Single-position attention over a KV cache through the
    ``decode_attention`` op (hand-written CUDA on the card).
    q: (B, 1, H, hd); caches: (B, S_max, K, hd); length: valid prefix."""
    B, _, H, hd = q.shape
    o = _decode_kernel_op(q.reshape(B, H, hd), k_cache, v_cache, length)
    return o.reshape(B, 1, H, hd)


def attention_block(x, p, cfg: ModelConfig, positions):
    """Train/prefill attention (causal, full sequence).  Returns (out, k, v):
    the block's output and its keys (after RoPE) and values, which prefill
    stashes in the cache (the reference returns the output alone and
    recomputes k and v in its prefill)."""
    q, k, v = _qkv(x, p, cfg)
    q, k = _position_encode(q, k, positions, cfg)
    o = causal_attention(q, k, v, cfg)
    B, S, _, _ = q.shape
    return o.reshape(B, S, -1) @ p["wo"], k, v


def attention_decode_block(x, p, cfg: ModelConfig, positions, k_cache,
                           v_cache, length) -> torch.Tensor:
    """One-token decode.  x: (B, 1, d); caches (B, S_max, K, hd), updated in
    place at position ``length`` (a 0-d int32 tensor on x's device, never
    read on the host) before attending over ``length + 1`` positions.  The
    reference returns fresh caches instead; the values are the same."""
    if cfg.kv_quant:
        raise _unported("the int8 KV cache (kv_quant=True)")
    q, k, v = _qkv(x, p, cfg)
    q, k = _position_encode(q, k, positions, cfg)
    slot = length.reshape(1).to(torch.int64)
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    o = decode_attention(q, k_cache, v_cache, length + 1, cfg)
    B = x.shape[0]
    return o.reshape(B, 1, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp_specs(cfg: ModelConfig) -> Specs:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": ParamSpec((d, f), ("embed", "mlp"), fan_in=d),
        "wi_up": ParamSpec((d, f), ("embed", "mlp"), fan_in=d),
        "wo": ParamSpec((f, d), ("mlp", "embed"), fan_in=f),
    }


def mlp_block(x: torch.Tensor, p: Dict, cfg: ModelConfig) -> torch.Tensor:
    g = F.silu((x @ p["wi_gate"]).to(torch.float32)).to(x.dtype)
    u = x @ p["wi_up"]
    return (g * u) @ p["wo"]
