"""Core transformer layers of the port: RMSNorm, RoPE and M-RoPE, GQA
attention through the hand-written flash and decode kernels (the decode
kernel also over the int8 KV cache, which it dequantizes itself), SwiGLU
MLP.  A port of the JAX package's ``models/layers.py`` for the attention
families, the dry-run's ``attn_impl="kernel_stub"`` stand-in included
(:func:`kernel_stub_attention`).

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
from repro_torch.kernels.decode_attention.ref import \
    dequantize as dequantize_kv
from repro_torch.kernels.flash_attention.ops import flash_attention

from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    fan_in: int = 0          # 0 => init to zeros (norm scales)
    dtype: torch.dtype = torch.bfloat16


Specs = Dict[str, ParamSpec]


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


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
# RoPE / M-RoPE
# ---------------------------------------------------------------------------
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, S, N, hd) rotated by the angles ``ang`` (B, S, hd/2): the first
    and second halves of hd pair up, f32 inside, x's dtype out."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, N, hd); positions: (B, S) int.  Half-split rotation (the
    first and second halves of hd pair up), f32 inside."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (hd/2,)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL M-RoPE: x (B, S, N, hd); positions3 (B, S, 3), the temporal,
    height and width position of each token.  The hd/2 rotary channels
    split into ``sections``, each rotated by its own position stream."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope_sections {tuple(sections)} must sum to "
                         f"head_dim / 2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    # the section of each rotary channel picks its position stream
    sec = torch.cat([torch.full((s,), i, dtype=torch.int64, device=x.device)
                     for i, s in enumerate(sections)])
    pos = positions3.to(torch.float32)[..., sec]              # (B,S,hd/2)
    return _rotate(x, pos * freqs)


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
    """RoPE over (B, S) positions, or M-RoPE over (B, S, 3) ones."""
    if cfg.mrope:
        return (apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
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


def kernel_stub_attention(q, k, v) -> torch.Tensor:
    """The dry-run's stand-in for the flash kernel, the reference's
    ``attn_impl="kernel_stub"`` as it stands: ``(repeat(k, G) + q) * 0.5 +
    repeat(v, G)``, G the query heads a kv head.  It is an accounting
    device and runs no attention: the block keeps its projections (real
    matrix products outside the kernel) and :mod:`repro_torch.launch.dryrun`
    adds the kernel's analytic costs.  The serving engine, the trainer and
    ``chip_smoke.py``'s kernel paths never select it."""
    G = q.shape[2] // k.shape[2]
    return (torch.repeat_interleave(k, G, dim=2) + q) * 0.5 \
        + torch.repeat_interleave(v, G, dim=2)


def causal_attention(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """The attention of a prefill or backbone layer by ``cfg.attn_impl``:
    ``"chunked"`` (the reference's jnp stand-in for the flash kernel) and
    ``"pallas"`` run the ``flash_attention`` op, hand-written CUDA on the
    card; under autograd (grad mode on and an input requiring a gradient)
    through :class:`FlashAttentionFn`, whose backward takes query chunks of
    ``cfg.attn_chunk_q`` rows.  ``"kernel_stub"`` is the dry-run's stand-in
    (:func:`kernel_stub_attention`), which runs no attention.  ``"naive"``
    raises: it would run plain PyTorch on the card in place of the kernel
    (the plain version is the op's CPU path)."""
    if cfg.attn_impl in ("chunked", "pallas"):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return FlashAttentionFn.apply(q, k, v, cfg.attn_chunk_q)
        return flash_attention(q, k, v)
    if cfg.attn_impl == "kernel_stub":
        return kernel_stub_attention(q, k, v)
    if cfg.attn_impl == "naive":
        raise ValueError("attn_impl='naive' is not offered: attention runs "
                         "through the flash_attention op")
    raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


def decode_attention(q, k_cache, v_cache, length, cfg: ModelConfig,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """Single-position attention over a KV cache through the
    ``decode_attention`` op (hand-written CUDA on the card).
    q: (B, 1, H, hd); caches: (B, S_max, K, hd); length: valid prefix.  An
    int8 cache comes with its bf16 scales (B, S_max, K), which the op
    applies as :func:`dequantize_kv` (the reference's dequantization) does.

    The op has no meta path: on meta tensors (no storage; the dry-run's
    trace, :mod:`repro_torch.launch.dryrun`, which adds the kernel's
    analytic costs) this returns an empty output of the shape."""
    B, _, H, hd = q.shape
    if q.device.type == "meta":
        return torch.empty_like(q)
    o = _decode_kernel_op(q.reshape(B, H, hd), k_cache, v_cache, length,
                          k_scale, v_scale)
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


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric int8 quantization of keys or values
    x (..., hd): the scale is ``max |x| / 127 + 1e-8`` in f32, the values
    ``round(x / scale)`` (half to even) clipped to +-127.  Returns (int8
    values, bf16 scales (...,)), as the reference's ``quantize_kv``."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def attention_decode_block(x, p, cfg: ModelConfig, positions, k_cache,
                           v_cache, length, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """One-token decode.  x: (B, 1, d); caches (B, S_max, K, hd), updated in
    place at position ``length`` (a 0-d int32 tensor on x's device, never
    read on the host) before attending over ``length + 1`` positions.  The
    reference returns fresh caches instead; the values are the same.

    With ``cfg.kv_quant`` the caches are int8 with bf16 scales
    (B, S_max, K): the token's keys and values are quantized
    (:func:`quantize_kv`) and written with their scales, and the decode
    kernel reads the int8 cache and dequantizes it itself, where the
    reference dequantizes the whole cache before its attention."""
    q, k, v = _qkv(x, p, cfg)
    q, k = _position_encode(q, k, positions, cfg)
    slot = length.reshape(1).to(torch.int64)
    if cfg.kv_quant:
        for cache, scales, t in ((k_cache, k_scale, k), (v_cache, v_scale, v)):
            tq, ts = quantize_kv(t)
            cache.index_copy_(1, slot, tq)
            scales.index_copy_(1, slot, ts)
    else:
        k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
        v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    o = decode_attention(q, k_cache, v_cache, length + 1, cfg,
                         k_scale if cfg.kv_quant else None,
                         v_scale if cfg.kv_quant else None)
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
