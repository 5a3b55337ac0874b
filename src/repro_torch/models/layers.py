"""Core transformer layers of the port: RMSNorm, RoPE, GQA attention through
the hand-written flash and decode kernels, SwiGLU MLP.  A port of the JAX
package's ``models/layers.py`` for the attention families; M-RoPE and the
int8 KV cache are not ported (ROADMAP A12).

Training: ``rmsnorm`` is an autograd Function whose backward is the
reference's custom VJP term for term, and attention under autograd goes
through :class:`FlashAttentionFn`: the flash kernel's forward, and a
backward that recomputes the attention in plain f32 one query chunk at a
time (the reference, too, differentiates its jnp stand-in and not the
Pallas kernel, which has no VJP).

Parameter convention, as in the reference: every builder contributes to a
flat ``{path: ParamSpec(shape, axes, fan_in)}`` dict, and per-layer params
are stacked with a leading ``layers`` axis.  The arithmetic follows the
reference's: norms and RoPE in f32 inside, matrix products in the
parameters' dtype (``torch.matmul``, as the reference leaves them to XLA).
"""
from __future__ import annotations

import dataclasses
import math
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


def _rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


class _RMSNorm(torch.autograd.Function):
    """The reference's ``jax.custom_vjp`` of ``rmsnorm``: the input's
    cotangent comes back in x's dtype (bf16 on the residual stream), not
    the f32 that differentiating the f32 arithmetic would give."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        xf = x.to(torch.float32)
        gf = g.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        rstd = torch.rsqrt(var + ctx.eps)
        xhat = xf * rstd
        gy = gf * (1.0 + scale.to(torch.float32))
        # d/dx of xhat: rstd * (gy - xhat * mean(gy * xhat))
        dx = rstd * (gy - xhat * torch.mean(gy * xhat, dim=-1, keepdim=True))
        dscale = torch.sum(gf * xhat, dim=tuple(range(x.dim() - 1)))
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """f32 inside, scaled by ``1 + scale``, x's dtype out; differentiable
    by the reference's custom VJP (:class:`_RMSNorm`)."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return _rmsnorm_fwd(x, scale, eps)


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


def _attention_chunk(q, k, v, q0: int) -> torch.Tensor:
    """Plain f32 causal attention of the queries at positions ``q0 ...
    q0 + cq - 1`` against the keys and values at ``0 ... q0 + cq - 1``.
    q: (B, cq, H, d); k, v: (B, q0 + cq, K, d), all f32."""
    B, cq, H, d = q.shape
    S, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, cq, K, H // K, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(d)
    mask = (torch.arange(q0, q0 + cq, device=q.device)[:, None]
            >= torch.arange(S, device=q.device)[None, :])
    w = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", w, v).reshape(B, cq, H, d)


class FlashAttentionFn(torch.autograd.Function):
    """Causal GQA attention with a gradient.  The forward is the
    ``flash_attention`` op (the hand-written CUDA kernel on the card, its
    plain version on the CPU).  The backward recomputes the attention with
    grad enabled in plain f32, one chunk of ``chunk`` query rows at a time
    against the causal triangle of keys before it: the reference's
    recompute-per-block schedule (``jax.checkpoint`` on each block of
    ``chunked_causal_attention``), so memory stays O(chunk x S).  dq, dk
    and dv come back in the inputs' dtypes, dk and dv summed over each
    kv head's group of query heads."""

    @staticmethod
    def forward(ctx, q, k, v, chunk):
        ctx.save_for_backward(q, k, v)
        ctx.chunk = chunk
        return flash_attention(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        S = q.shape[1]
        dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for q0 in range(0, S, ctx.chunk):
            q1 = min(q0 + ctx.chunk, S)
            with torch.enable_grad():
                qc = q[:, q0:q1].to(torch.float32).requires_grad_()
                kc = k[:, :q1].to(torch.float32).requires_grad_()
                vc = v[:, :q1].to(torch.float32).requires_grad_()
                o = _attention_chunk(qc, kc, vc, q0)
                gq, gk, gv = torch.autograd.grad(
                    o, (qc, kc, vc), g[:, q0:q1].to(torch.float32))
            dq[:, q0:q1] = gq
            dk[:, :q1] += gk
            dv[:, :q1] += gv
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def causal_attention(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """The attention of a prefill or backbone layer by ``cfg.attn_impl``:
    ``"chunked"`` (the reference's jnp stand-in for the flash kernel) and
    ``"pallas"`` run the ``flash_attention`` op, hand-written CUDA on the
    card; under autograd (grad mode on and an input requiring a gradient)
    through :class:`FlashAttentionFn`, whose backward takes query chunks of
    ``cfg.attn_chunk_q`` rows.  ``"naive"`` raises: it would run plain
    PyTorch on the card in place of the kernel (the plain version is the
    op's CPU path)."""
    if cfg.attn_impl in ("chunked", "pallas"):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return FlashAttentionFn.apply(q, k, v, cfg.attn_chunk_q)
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
