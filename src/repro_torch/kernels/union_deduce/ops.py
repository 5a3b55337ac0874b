"""Public wrapper of the fused union–deduce kernel: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors, and an error for anything
else."""
from __future__ import annotations

import torch

from . import kernel
from .ref import union_deduce_ref


def union_deduce(parent0: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 pos_mask: torch.Tensor, neg_keys: torch.Tensor,
                 n_objects: int):
    """Fused union + self-key conflict screen + transitive deduce over B
    stacked lanes (see :mod:`.ref` for the semantics).

    Returns ``(roots (B, n) int32, deduced (B, P) int32, conflict (B,)
    bool)``.  ``union_deduce.launches`` counts CUDA kernel launches, and
    ``union_deduce.wide_launches`` those of them that went to the wide
    kernel (past ``kernel.MAX_OBJECTS`` objects, int64 keys)."""
    if parent0.device.type == "cpu":
        return union_deduce_ref(parent0, u, v, pos_mask, neg_keys, n_objects)
    out = kernel.union_deduce(parent0, u, v, pos_mask, neg_keys, n_objects)
    union_deduce.launches += 1
    if n_objects > kernel.MAX_OBJECTS:
        union_deduce.wide_launches += 1
    return out


union_deduce.launches = 0
union_deduce.wide_launches = 0
