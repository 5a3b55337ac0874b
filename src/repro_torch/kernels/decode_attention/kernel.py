"""Launch of the hand-written CUDA flash-decode kernel,
``repro_torch/csrc/decode_attention.cu`` (it replaces the Pallas kernel
``repro/kernels/decode_attention/kernel.py::decode_attention``).  The kernel
reads ``length`` from device memory, so the host never waits on it.  It
splits the cache across blocks and merges the splits in the same launch;
the last block of each (lane, kv head) finds itself through a counter in
:data:`_COUNTERS` and sets it back to 0."""
from __future__ import annotations

import math

import torch

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16   # query heads per kv head
# (q dtype, cache dtype) pairs the kernel is built for
DTYPE_PAIRS = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16))
# per CUDA device: int32 counters, zeroed once when allocated; every call
# leaves them 0, so no call clears them
_COUNTERS: dict = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zero counters on ``device``, reallocated (zeroed) only
    when a call needs more than the buffer holds."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[device] = torch.zeros(n, dtype=torch.int32,
                                              device=device)
    return buf


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """q: (B, H, d), caches: (B, S, K, d) CUDA tensors (head dim contiguous;
    dtypes in ``DTYPE_PAIRS``), ``length`` a 0-d or one-element int32 tensor
    on the same device.  Returns a new (B, H, d) tensor in q's dtype.  A
    ``length`` below 1 stops the kernel with a trap, which surfaces as a
    RuntimeError at the next synchronization; above S it counts as S.

    One launch.  The partials of the sequence's splits go to a workspace
    from ``torch.empty``; the merge's counters are shared by every call on
    the device, so calls must be ordered on one stream, as the port issues
    them (PyTorch's current stream)."""
    from repro_torch.kernels._build import extension

    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("length", length)):
        if not isinstance(x, torch.Tensor) or not x.is_cuda \
                or x.device != q.device:
            raise ValueError(
                f"decode_attention kernel needs {name} as a CUDA tensor on "
                f"q's device, got {type(x).__name__} "
                f"{getattr(x, 'device', '')}")
    if (q.dtype, k_cache.dtype) not in DTYPE_PAIRS \
            or v_cache.dtype != k_cache.dtype or length.dtype != torch.int32 \
            or length.numel() != 1 or not length.is_contiguous():
        raise ValueError(
            f"decode_attention kernel dtypes q {q.dtype} caches "
            f"{k_cache.dtype}/{v_cache.dtype} length {length.dtype} "
            f"{tuple(length.shape)}: (q, cache) in {DTYPE_PAIRS}, one int32 "
            "length")
    B, H, d = q.shape if q.dim() == 3 else (0, 0, 0)
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != B or k_cache.shape[3] != d or B < 1 \
            or k_cache.shape[1] < 1 or H % k_cache.shape[2] \
            or H // k_cache.shape[2] > MAX_GROUP or d not in HEAD_DIMS \
            or any(x.stride(-1) != 1 for x in (q, k_cache, v_cache)):
        raise ValueError(
            f"decode_attention kernel shapes q {tuple(q.shape)} caches "
            f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}: H a multiple "
            f"of K with at most {MAX_GROUP} query heads per kv head, head "
            f"dim in {HEAD_DIMS} and contiguous")
    o = torch.empty((B, H, d), dtype=q.dtype, device=q.device)
    extension().decode_attention(q, k_cache, v_cache, length, o,
                                 _counters(q.device, B * H),
                                 1.0 / math.sqrt(d))
    return o


def split_plan(q: torch.Tensor, k_cache: torch.Tensor):
    """(splits, chunk): how many blocks share one (lane, kv head) and how
    many cache positions each reads, as the launch for these shapes on this
    card plans it (from the cache's capacity S and the SM count)."""
    from repro_torch.kernels._build import extension

    splits, chunk = extension().decode_attention_split(q, k_cache)
    return int(splits), int(chunk)
