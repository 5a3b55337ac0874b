"""Plain PyTorch version of causal GQA attention (a copy of the JAX package's
``kernels/flash_attention/ref.py::mha_causal_ref``): the CPU path of
:mod:`.ops` and the yardstick the CUDA kernel is held against on the card."""
from __future__ import annotations

import math

import torch


def mha_causal_ref(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """q: (B, S, H, d); k, v: (B, S, K, d) with H % K == 0.  f32 inside;
    returns (B, S, H, d) in q's dtype."""
    B, S, H, d = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, d).to(torch.float32)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32))
    s = s / math.sqrt(d)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, -math.inf)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(torch.float32))
    return o.reshape(B, S, H, d).to(q.dtype)
