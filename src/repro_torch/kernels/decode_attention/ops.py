"""Public wrapper of one-token attention over a KV cache: the CUDA kernel
for CUDA tensors, the plain version for CPU tensors, and an error for
anything else."""
from __future__ import annotations

import torch

from . import kernel
from .ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length) -> torch.Tensor:
    """q: (B, H, d); caches (B, S, K, d); ``length`` (int or int32 tensor)
    the valid prefix of the caches.  Returns (B, H, d) in q's dtype, f32
    inside.  No ``impl=``: CPU tensors take
    :func:`.ref.decode_attention_ref`, CUDA tensors the kernel, which reads
    ``length`` from an int32 tensor on the card.

    ``length`` must be at least 1: with no valid position the Pallas kernel
    (0/0) and its ref (softmax over -inf) give NaN.  This wrapper raises
    ValueError where it can see the value without waiting on the card (an
    int, a CPU tensor); a device-resident ``length`` below 1 stops the
    kernel with a trap, raised as a RuntimeError at the next
    synchronization.  ``decode_attention.launches`` counts kernel
    launches."""
    if not isinstance(length, torch.Tensor) or length.device.type == "cpu":
        n = int(length)
        if n < 1:
            raise ValueError(f"decode_attention needs length >= 1, got {n}:"
                             " no cache position is valid")
        if all(x.device.type == "cpu" for x in (q, k_cache, v_cache)):
            return decode_attention_ref(q, k_cache, v_cache, n)
    o = kernel.decode_attention(q, k_cache, v_cache, length)
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
