"""Public wrapper of causal GQA attention: the CUDA kernel for CUDA tensors,
the plain version for CPU tensors, and an error for anything else."""
from __future__ import annotations

import torch

from . import kernel
from .ref import mha_causal_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal attention.  q: (B, S, H, d); k, v: (B, S, K, d) with H % K ==
    0; returns (B, S, H, d) in q's dtype, f32 inside.  No ``impl=``: CPU
    tensors take :func:`.ref.mha_causal_ref`, CUDA tensors the kernels of
    :func:`.kernel.flash_attention` (any S, B * H and head dim; bf16 on
    the tensor cores, f32 SIMT), which raise on what they do not take.
    ``flash_attention.launches`` counts kernel launches of either route,
    ``flash_attention.f32_launches`` those of the f32 kernel alone,
    ``flash_attention.wide_launches`` the f32 calls that ran its cluster
    kernel (a head dim past 256, :func:`.kernel.f32_slabs`),
    ``flash_attention.bf16_wide_launches`` the bf16 calls past 256, and
    ``flash_attention.staged`` the bf16 calls whose inputs were copied to
    suit TMA first (:func:`.kernel.bf16_staging`)."""
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return mha_causal_ref(q, k, v)
    staged = q.dtype == torch.bfloat16 and \
        kernel.bf16_staging(q, k, v) is not None
    o = kernel.flash_attention(q, k, v)
    f32, wide = q.dtype == torch.float32, q.shape[-1] > kernel.CHUNK
    flash_attention.launches += 1
    flash_attention.f32_launches += f32
    flash_attention.wide_launches += f32 and wide and kernel.f32_slabs(
        q.shape[-1])[1] <= kernel.MAX_CLUSTER
    flash_attention.bf16_wide_launches += not f32 and wide
    flash_attention.staged += staged
    return o


flash_attention.launches = 0
flash_attention.f32_launches = 0
flash_attention.wide_launches = 0
flash_attention.bf16_wide_launches = 0
flash_attention.staged = 0
