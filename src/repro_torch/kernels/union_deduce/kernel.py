"""Launch of the hand-written CUDA union–deduce kernel
(``repro_torch/csrc/union_deduce.cu``; it replaces the Pallas kernel
``repro/kernels/union_deduce/kernel.py::union_deduce``): one thread block per
lane, the forest in shared memory, a per-lane hash set in global scratch."""
from __future__ import annotations

import torch

# n * n < 2^31 (int32 keys) bounds the forest at 46340 objects, 185 KB of
# shared memory — within a block's 227 KB on Hopper
MAX_OBJECTS = 46340


def launch(parent0: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
           pos_mask: torch.Tensor, neg_keys: torch.Tensor, n_objects: int):
    """Check the inputs and launch the kernel on the current stream without
    waiting for it.  Stacked lanes on one CUDA device: parent0 (B, n) int32
    compressed forests, u/v (B, P) int32, pos_mask (B, P) bool, neg_keys
    (B, P) int32 sorted and INT32_MAX-padded.  Returns ``(roots (B, n)
    int32, deduced (B, P) int32, conflict (B,) int32, error (B,) int32)``;
    ``error`` flags lanes whose union hit the trip cap."""
    from repro_torch.kernels._build import extension

    for name, x, dt in (("parent0", parent0, torch.int32),
                        ("u", u, torch.int32), ("v", v, torch.int32),
                        ("pos_mask", pos_mask, torch.bool),
                        ("neg_keys", neg_keys, torch.int32)):
        if not x.is_cuda or x.dtype != dt or x.dim() != 2 \
                or x.device != parent0.device:
            raise ValueError(
                f"union_deduce kernel needs {name} as a 2-D {dt} tensor on "
                f"one CUDA device, got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")
    B, n = parent0.shape
    P = u.shape[1]
    if n != n_objects or not 1 <= n <= MAX_OBJECTS or P < 1 \
            or any(t.shape != (B, P) for t in (v, pos_mask, neg_keys)):
        raise ValueError(
            f"union_deduce kernel shapes: parent0 {tuple(parent0.shape)}, "
            f"pairs {tuple(u.shape)}, n_objects={n_objects} (at most "
            f"{MAX_OBJECTS})")
    table_size = 64
    while table_size < 2 * P:   # load factor <= 1/2
        table_size *= 2
    dev = parent0.device
    roots = torch.empty((B, n), dtype=torch.int32, device=dev)
    deduced = torch.empty((B, P), dtype=torch.int32, device=dev)
    conflict = torch.zeros(B, dtype=torch.int32, device=dev)
    error = torch.zeros(B, dtype=torch.int32, device=dev)
    table = torch.empty((B, table_size), dtype=torch.int32, device=dev)
    extension().union_deduce(
        parent0.contiguous(), u.contiguous(), v.contiguous(),
        pos_mask.contiguous().view(torch.uint8), neg_keys.contiguous(),
        roots, deduced, conflict, error, table, max_trips(n))
    return roots, deduced, conflict, error


def max_trips(n: int) -> int:
    """Cap on union trips: every two trips at least halve the roots a
    component still has, so a correct run needs about 2 * log2(n); the cap
    leaves a margin."""
    return 4 * n.bit_length() + 16


def union_deduce(parent0: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 pos_mask: torch.Tensor, neg_keys: torch.Tensor,
                 n_objects: int):
    """:func:`launch`, then raise if a lane hit the trip cap.  Returns
    ``(roots (B, n) int32, deduced (B, P) int32, conflict (B,) bool)``."""
    roots, deduced, conflict, error = launch(parent0, u, v, pos_mask,
                                             neg_keys, n_objects)
    if bool(error.any()):
        raise RuntimeError(
            f"union_deduce kernel hit its cap of {max_trips(n_objects)} union"
            f" trips on lanes {torch.nonzero(error).flatten().tolist()}")
    return roots, deduced, conflict.bool()
