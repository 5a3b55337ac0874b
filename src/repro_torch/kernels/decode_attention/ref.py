"""Plain PyTorch version of one-token attention over a KV cache (a copy of
the JAX package's ``kernels/decode_attention/ref.py::decode_attention_ref``,
with the int8 cache dequantized first as the reference's
``models/layers.py::attention_decode_block`` does): the CPU path of
:mod:`.ops` and the yardstick the CUDA kernel is held against on the
card."""
from __future__ import annotations

import math

import torch


def dequantize(values: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """An int8 cache (B, S, K, d) with its bf16 scales (B, S, K) as bf16:
    each value cast to bf16 times its scale, the exact product rounded
    once to bf16."""
    return values.to(torch.bfloat16) * scale[..., None]


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, length, k_scale=None,
                         v_scale=None) -> torch.Tensor:
    """q: (B, H, d); caches: (B, S, K, d); ``length`` (int or 0-d tensor) is
    the valid prefix.  An int8 cache comes with bf16 scales (B, S, K) and
    is dequantized to bf16 (:func:`dequantize`) before the attention.  f32
    inside; returns (B, H, d) in q's dtype."""
    if k_scale is not None:
        k_cache, v_cache = dequantize(k_cache, k_scale), \
            dequantize(v_cache, v_scale)
    B, H, d = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, d).to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(torch.float32))
    s = s / math.sqrt(d)
    valid = torch.arange(k_cache.shape[1], device=q.device) < length
    s = s.masked_fill(~valid, -math.inf)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", w, v_cache.to(torch.float32))
    return o.reshape(B, H, d).to(q.dtype)
