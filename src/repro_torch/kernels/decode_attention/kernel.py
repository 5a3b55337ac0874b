"""Launch of the hand-written CUDA flash-decode kernel,
``repro_torch/csrc/decode_attention.cu`` (it replaces the Pallas kernel
``repro/kernels/decode_attention/kernel.py::decode_attention``), over an
f32, bf16 or int8 cache (the last with its scales, dequantized inside the
kernel).  The kernel reads ``length`` from device memory, so the host never
waits on it.  It
splits the cache across blocks and merges the splits in the same launch;
the last block of each (lane, kv head) finds itself through a counter in
:data:`_COUNTERS` and sets it back to 0."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.kernel import (CHUNK, chunks,
                                                        head_dim_refusal,
                                                        width)

INT32_LIMIT = 2 ** 31
# decode_attention.cu's wide kernel: up to this many vectors of CHUNK
# columns a lane (d up to 1024), then the chunked kernel
MAX_VECTORS = 4
# its registers a thread for q and the accumulators (Wide<TKV, NV>::kBudget),
# the narrow kernel's query heads a block when G > 1 (Rows<TKV, D>::kGC) by
# cache element size, and its ring of row stages in shared memory
REG_BUDGET = 128
NARROW_HEADS = {4: 4, 2: 4, 1: 2}
STAGES, STAGE_BYTES = 2, 16384
# (q dtype, cache dtype) pairs the kernel is built for; an int8 cache comes
# with bf16 scales
DTYPE_PAIRS = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16),
               (torch.float32, torch.int8),
               (torch.bfloat16, torch.int8))
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
                     v_cache: torch.Tensor, length: torch.Tensor,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """q: (B, H, d), caches: (B, S, K, d) CUDA tensors (head dim contiguous,
    any d from 1; any H a multiple of K; dtypes in ``DTYPE_PAIRS``; any
    batch, position and head strides: 16-byte loads where they allow,
    element by element elsewhere, never a byte past a row's d elements),
    ``length`` a 0-d or one-element int32 tensor
    on the same device.  An int8 cache needs its scales ``k_scale`` and
    ``v_scale``: bf16 (B, S, K) on the same device, any strides; the
    kernel dequantizes each value as ``ref.dequantize`` does (the int8
    value times its bf16 scale is exact in f32 and is rounded once to
    bf16).  Returns a new (B, H, d) tensor in q's dtype.  A ``length``
    below 1 stops the kernel with a trap, which surfaces as a RuntimeError
    at the next synchronization; above S it counts as S.

    One launch.  Up to d = 256 a row is read at the compiled width
    :func:`~repro_torch.kernels.flash_attention.kernel.width` at or above
    d; past it, up to ``MAX_VECTORS`` vectors of 256, a lane holds each
    row's vectors (:func:`lane_layout`), so each cache byte is read once;
    past those the output columns go in :func:`chunks` of 256, a grid
    index a chunk, each block summing the scores over all of d.  The
    partials of the sequence's splits go to a workspace from
    ``torch.empty``; the merge's counters are shared by every call on
    the device, so calls must be ordered on one stream, as the port issues
    them (PyTorch's current stream)."""
    from repro_torch.kernels._build import extension

    scales = () if k_scale is None else (("k_scale", k_scale),
                                         ("v_scale", v_scale))
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("length", length)) + scales:
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
            or k_cache.shape[1] < 1 or k_cache.shape[2] < 1 \
            or H % k_cache.shape[2] \
            or any(x.stride(-1) != 1 for x in (q, k_cache, v_cache)):
        raise ValueError(
            f"decode_attention kernel shapes q {tuple(q.shape)} caches "
            f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}: H a multiple "
            f"of K and the head dim contiguous")
    why = head_dim_refusal(d)
    n_cc = column_chunks(d) if why is None else 1
    if why is None and B * H * n_cc >= INT32_LIMIT:
        why = (f"B * H * column chunks = {B * H * n_cc}: the kernel "
               f"indexes its (lane, head, chunk) partials and counters with "
               f"int32")
    if why is not None:
        raise ValueError(f"decode_attention kernel: {why}")
    if (k_cache.dtype == torch.int8) != bool(scales) or any(
            s.dtype != torch.bfloat16 or s.shape != k_cache.shape[:3]
            for _, s in scales):
        raise ValueError(
            f"decode_attention kernel: an int8 cache, and only an int8 "
            f"cache, takes bf16 scales of shape {tuple(k_cache.shape[:3])}; "
            f"got cache {k_cache.dtype} and scales "
            f"{[(s.dtype, tuple(s.shape)) for _, s in scales]}")
    o = torch.empty((B, H, d), dtype=q.dtype, device=q.device)
    counters = _counters(q.device, B * H * n_cc)
    if scales:
        extension().decode_attention_int8(q, k_cache, v_cache, k_scale,
                                          v_scale, length, o, counters,
                                          1.0 / math.sqrt(d))
    else:
        extension().decode_attention(q, k_cache, v_cache, length, o,
                                     counters, 1.0 / math.sqrt(d))
    return o


def column_chunks(d: int) -> int:
    """The column chunks of 256 on the kernel's grid for head dim ``d``:
    past ``MAX_VECTORS`` vectors (the chunked kernel), else 1."""
    n = chunks(d)
    return n if n > MAX_VECTORS else 1


def wide(d: int) -> bool:
    """Whether head dim ``d`` runs the wide kernel: past 256, up to
    ``MAX_VECTORS`` vectors of 256 a lane."""
    return 1 < chunks(d) <= MAX_VECTORS


def lane_layout(kv_dtype: torch.dtype, d: int) -> dict:
    """How the kernel reads a cache row of head dim ``d`` (its
    ``Rows<TKV, D>``, ``Wide<TKV, NV>`` and ``load_lane``): the compiled
    ``width`` D at or above d (256 past it), the ``vectors`` NV of D
    columns a lane holds (1 up to 256, ceil(d / 256) up to
    ``MAX_VECTORS``, past them 1), the column ``chunks`` of D on the grid
    (past ``MAX_VECTORS`` vectors, else 1), the ``elements`` a lane loads
    a vector (16 bytes, or 32 for f32 at width 256), the ``lanes`` of a
    row group (a power of two of at most 32, for the xor butterfly), the
    ``active`` lanes that hold a column below d in the last vector (or
    chunk), how many elements of the last active lane lie below d
    (``last``: the lane's share or any part of it, loaded element by
    element, an int8 half as one 8-byte load), and for the wide kernel its
    query ``heads`` a block when G > 1 (the narrow kernel's, halved while
    q and the accumulators pass ``REG_BUDGET`` registers a thread), the
    ``stages`` of its ring in shared memory and the rows a row group copies
    a stage (``unroll``: about ``STAGE_BYTES`` a stage, twice that over
    an int8 cache)."""
    D = width(d)
    size = kv_dtype.itemsize
    per_vec = 16 // size
    vecs = 2 if D // per_vec > 32 else 1
    elements = per_vec * vecs
    n, n_cc = chunks(d), column_chunks(d)
    nv = n if n_cc == 1 else 1
    rest = d - (n - 1) * CHUNK
    active = -(-rest // elements)
    out = {"width": D, "vectors": nv, "chunks": n_cc, "elements": elements,
           "lanes": D // elements, "active": active,
           "last": rest - (active - 1) * elements}
    if nv > 1:
        gc = NARROW_HEADS[size]
        while gc > 1 and gc * 2 * nv * elements > REG_BUDGET:
            gc //= 2
        pieces = 2 * nv * vecs * (D // elements)   # 16 bytes, a row
        groups = 128 // (D // elements)            # row groups a block
        stage = STAGE_BYTES * (2 if size == 1 else 1)   # int8: twice
        out.update(heads=gc, stages=STAGES,
                   unroll=max(1, stage // (16 * groups * pieces)))
    return out


def split_plan(q: torch.Tensor, k_cache: torch.Tensor):
    """(splits, chunk): how many blocks share one (lane, kv head) and how
    many cache positions each reads, as the launch for these shapes on this
    card plans it (from the cache's capacity S and the SM count)."""
    from repro_torch.kernels._build import extension

    splits, chunk = extension().decode_attention_split(q, k_cache)
    return int(splits), int(chunk)
