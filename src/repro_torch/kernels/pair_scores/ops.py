"""Public wrappers of the pair-score kernels: normalization, padding to tile
multiples, and device dispatch — the CUDA kernel for CUDA tensors, the plain
version for CPU tensors, and an error for anything else."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernel
from .ref import pair_scores_compact_ref, pair_scores_ref


def l2_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    n = torch.linalg.vector_norm(x.to(torch.float32), dim=-1, keepdim=True)
    return (x / torch.clamp(n, min=eps)).to(x.dtype)


def pair_scores(a: torch.Tensor, b: torch.Tensor, threshold: float,
                normalize: bool = True):
    """Similarity of all (a_i, b_j) pairs with fused thresholding.

    Returns (scores (N, M) f32 zeroed below ``threshold``, counts (N, 1)
    int32).  ``pair_scores.launches`` counts CUDA kernel launches."""
    if normalize:
        a = l2_normalize(a)
        b = l2_normalize(b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        s, c = pair_scores_ref(a, b, threshold)
        return s, c[:, None]
    N, M = a.shape[0], b.shape[0]
    pn = (-N) % kernel.TILE_ROWS
    pm = (-M) % kernel.TILE_ROWS
    pd = (-a.shape[1]) % kernel.TILE_DEPTH
    a = F.pad(a.to(torch.float32), (0, pd, 0, pn)).contiguous()
    b = F.pad(b.to(torch.float32), (0, pd, 0, pm)).contiguous()
    s, c = kernel.pair_scores(a, b, threshold, M)
    pair_scores.launches += 1
    return s[:N, :M], c[:N, None]


pair_scores.launches = 0


def pair_scores_compact(a_g: torch.Tensor, b_g: torch.Tensor,
                        ida: torch.Tensor, idb: torch.Tensor,
                        threshold: float, capacity: int, bn: int, bm: int):
    """Fused similarity + threshold + candidate compaction over T gathered
    tile pairs (see :func:`.ref.pair_scores_compact_ref` for the contract).
    bf16 inputs are scored in f32.  ``pair_scores_compact.launches`` counts
    calls that reach the CUDA kernel (one launch each)."""
    if all(x.device.type == "cpu" for x in (a_g, b_g, ida, idb)):
        return pair_scores_compact_ref(a_g, b_g, ida, idb, threshold,
                                       capacity, bn, bm)
    # zero columns leave every fmaf sum unchanged
    pd = (-a_g.shape[1]) % kernel.TILE_DEPTH
    a_g, b_g = (F.pad(x.to(torch.float32), (0, pd)).contiguous() if pd
                else x.to(torch.float32).contiguous() for x in (a_g, b_g))
    out = kernel.pair_scores_compact(a_g, b_g, ida.contiguous(),
                                     idb.contiguous(), threshold, capacity,
                                     bn, bm)
    pair_scores_compact.launches += 1
    return out


pair_scores_compact.launches = 0
