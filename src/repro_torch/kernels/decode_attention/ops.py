"""Public wrapper of one-token attention over a KV cache: the CUDA kernel
for CUDA tensors, the plain version for CPU tensors, and an error for
anything else."""
from __future__ import annotations

import torch

from . import kernel
from .ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length, k_scale=None,
                     v_scale=None) -> torch.Tensor:
    """q: (B, H, d); caches (B, S, K, d); ``length`` (int or int32 tensor)
    the valid prefix of the caches.  An int8 cache comes with its bf16
    scales ``k_scale`` and ``v_scale`` (B, S, K), both or neither.
    Returns (B, H, d) in q's dtype, f32 inside.  No ``impl=``: CPU tensors
    take :func:`.ref.decode_attention_ref`, CUDA tensors the kernel, which
    reads ``length`` from an int32 tensor on the card and dequantizes an
    int8 cache itself.

    ``length`` must be at least 1: with no valid position the Pallas kernel
    (0/0) and its ref (softmax over -inf) give NaN.  This wrapper raises
    ValueError where it can see the value without waiting on the card (an
    int, a CPU tensor); a device-resident ``length`` below 1 stops the
    kernel with a trap, raised as a RuntimeError at the next
    synchronization.  ``decode_attention.launches`` counts kernel launches
    over a bf16 or f32 cache, ``decode_attention.int8_launches`` over an
    int8 one, and ``decode_attention.wide_launches`` those of either that
    ran the wide kernel (a head dim past 256 whose row a lane holds in
    vectors, :func:`.kernel.wide`)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention takes both scales or neither")
    tensors = (q, k_cache, v_cache) + (() if k_scale is None
                                       else (k_scale, v_scale))
    if not isinstance(length, torch.Tensor) or length.device.type == "cpu":
        n = int(length)
        if n < 1:
            raise ValueError(f"decode_attention needs length >= 1, got {n}:"
                             " no cache position is valid")
        if all(x.device.type == "cpu" for x in tensors):
            return decode_attention_ref(q, k_cache, v_cache, n, k_scale,
                                        v_scale)
    o = kernel.decode_attention(q, k_cache, v_cache, length, k_scale,
                                v_scale)
    if k_scale is None:
        decode_attention.launches += 1
    else:
        decode_attention.int8_launches += 1
    decode_attention.wide_launches += kernel.wide(q.shape[-1])
    return o


decode_attention.launches = 0
decode_attention.int8_launches = 0
decode_attention.wide_launches = 0
