"""Launch of the hand-written CUDA flash-attention kernels (they replace the
Pallas kernel ``repro/kernels/flash_attention/kernel.py::flash_attention``):
``repro_torch/csrc/flash_attention_wgmma.cu`` on the tensor cores for bf16
and ``repro_torch/csrc/flash_attention.cu`` (SIMT) for f32.  Both read q, k
and v in place by their strides and take any S."""
from __future__ import annotations

import math

import torch

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID_Y = 65535   # batch * heads: the grid's second axis
TMA_ALIGN = 16       # bytes: TMA's rule for a base address and a stride


def tma_misalignment(x: torch.Tensor) -> str | None:
    """Why TMA cannot describe ``x`` (its base address or a batch, sequence
    or head stride is not a multiple of 16 bytes), or None if it can."""
    if x.data_ptr() % TMA_ALIGN:
        return f"base address {x.data_ptr():#x}"
    bad = [s for s in x.stride()[:-1] if s * x.element_size() % TMA_ALIGN]
    return f"stride of {bad[0] * x.element_size()} bytes" if bad else None


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q: (B, S, H, d), k and v: (B, S, K, d) CUDA tensors of one dtype (f32
    or bf16) on one device, head dim contiguous, H a multiple of K, d in
    ``HEAD_DIMS``.  Causal.  Returns a new contiguous (B, S, H, d) tensor in
    q's dtype.

    The route is chosen by dtype, here and nowhere else: bf16 goes to the
    tensor-core kernel (TMA loads, wgmma products, P split into bf16 hi and
    lo), f32 to the SIMT kernel.  Neither falls back to the other.  bf16
    inputs must also suit TMA: a base address or stride that is not a
    multiple of 16 bytes raises ``ValueError``."""
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
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            why = tma_misalignment(x)
            if why is not None:
                raise ValueError(
                    f"flash_attention's bf16 kernel loads {name} by TMA, "
                    f"which needs its base address and its batch, sequence "
                    f"and head strides to be multiples of {TMA_ALIGN} bytes;"
                    f" {name} has a {why}")
        launch = extension().flash_attention_bf16
    else:
        launch = extension().flash_attention_f32
    launch(q, k, v, o, 1.0 / math.sqrt(d))
    return o
