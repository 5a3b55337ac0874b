"""Launch of the hand-written CUDA pair-score kernel
(``repro_torch/csrc/pair_scores.cu``; it replaces the Pallas kernel
``repro/kernels/pair_scores/kernel.py::pair_scores``).  The wrapper in
:mod:`.ops` pads to the tile multiples below."""
from __future__ import annotations

import torch

TILE_ROWS = 128   # rows of a (and of b) per block; N and M pad to this
TILE_DEPTH = 16   # k slice staged in shared memory; D pads to this


def pair_scores(a: torch.Tensor, b: torch.Tensor, threshold: float,
                m_valid: int):
    """a: (N, D), b: (M, D) contiguous f32 CUDA tensors with N, M multiples
    of ``TILE_ROWS`` and D of ``TILE_DEPTH``.  Returns (scores (N, M) f32
    zeroed below threshold, counts (N,) int32 over the first ``m_valid``
    columns)."""
    from repro_torch.kernels._build import extension

    for name, x in (("a", a), ("b", b)):
        if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2 \
                or not x.is_contiguous():
            raise ValueError(
                f"pair_scores kernel needs {name} as a contiguous 2-D f32 "
                f"CUDA tensor, got {x.dtype} {tuple(x.shape)} on {x.device}")
    (N, D), (M, D2) = a.shape, b.shape
    if a.device != b.device or D != D2 or N % TILE_ROWS or M % TILE_ROWS \
            or D % TILE_DEPTH or not 0 <= m_valid <= M:
        raise ValueError(
            f"pair_scores kernel shapes a {tuple(a.shape)} b {tuple(b.shape)}"
            f" m_valid={m_valid}: rows must pad to {TILE_ROWS}, depth to "
            f"{TILE_DEPTH}, on one device")
    scores = torch.empty((N, M), dtype=torch.float32, device=a.device)
    counts = torch.zeros(N, dtype=torch.int32, device=a.device)
    extension().pair_scores(a, b, scores, counts, int(m_valid),
                            float(threshold))
    return scores, counts
