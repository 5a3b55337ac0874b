"""Plain PyTorch version of one-token attention over a KV cache (a copy of
the JAX package's ``kernels/decode_attention/ref.py::decode_attention_ref``):
the CPU path of :mod:`.ops` and the yardstick the CUDA kernel is held
against on the card."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, length) -> torch.Tensor:
    """q: (B, H, d); caches: (B, S, K, d); ``length`` (int or 0-d tensor) is
    the valid prefix.  f32 inside; returns (B, H, d) in q's dtype."""
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
