"""Launch of the hand-written CUDA flash-attention kernel,
``repro_torch/csrc/flash_attention.cu`` (it replaces the Pallas kernel
``repro/kernels/flash_attention/kernel.py::flash_attention``).  The kernel
reads q, k and v in place by their strides and takes any S."""
from __future__ import annotations

import math

import torch

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID_Y = 65535   # batch * heads: the grid's second axis


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q: (B, S, H, d), k and v: (B, S, K, d) CUDA tensors of one dtype (f32
    or bf16) on one device, head dim contiguous, H a multiple of K, d in
    ``HEAD_DIMS``.  Causal.  Returns a new contiguous (B, S, H, d) tensor in
    q's dtype."""
    from repro_torch.kernels._build import extension

    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.dtype not in DTYPES or x.dim() != 4 \
                or x.stride(-1) != 1 or x.device != q.device \
                or x.dtype != q.dtype:
            raise ValueError(
                f"flash_attention kernel needs {name} as a 4-D f32 or bf16 "
                f"CUDA tensor with a contiguous last dim, one dtype and one "
                f"device for q, k, v; got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")
    B, S, H, d = q.shape
    K = k.shape[2]
    if k.shape != v.shape or k.shape != (B, S, K, d) or K < 1 or H % K \
            or d not in HEAD_DIMS or B * H > MAX_GRID_Y or S < 1:
        raise ValueError(
            f"flash_attention kernel shapes q {tuple(q.shape)} k "
            f"{tuple(k.shape)} v {tuple(v.shape)}: H a multiple of K, head "
            f"dim in {HEAD_DIMS}, B * H <= {MAX_GRID_Y}")
    o = torch.empty((B, S, H, d), dtype=q.dtype, device=q.device)
    extension().flash_attention(q, k, v, o, 1.0 / math.sqrt(d))
    return o
