"""Launch of the hand-written CUDA flash-attention kernels (they replace the
Pallas kernel ``repro/kernels/flash_attention/kernel.py::flash_attention``):
``repro_torch/csrc/flash_attention_wgmma.cu`` on the tensor cores for bf16
and ``repro_torch/csrc/flash_attention.cu`` (SIMT f32 FMAs, register tiles,
cp.async) for f32.  Both take any S, any B * H and, as the Pallas kernel
does, any head dim from 1: up to 256 it runs at the compiled width at or
above it (:func:`width`).  Past 256 the bf16 kernel runs :func:`chunks`
column chunks of 256, one grid index a chunk, each summing Q.K^T over all
of d in slabs of 256; the f32 kernel runs a thread-block cluster of
:func:`f32_slabs` blocks, one a slab of columns, which sum S once between
them (past ``MAX_CLUSTER`` slabs of 256, the bf16 kernel's chunked
layout).  The f32 kernel reads q, k and v in place at any strides; the
bf16 kernel reads them in place by TMA where their head dim is a multiple
of 8 and their bases and strides are multiples of 16 bytes, and from a
staged copy otherwise (:func:`bf16_staging`).  :func:`f32_plan` lays out
the f32 kernel's launch; it runs on the CPU."""
from __future__ import annotations

import dataclasses
import math

import torch

WIDTHS = (32, 64, 128, 256)   # head dims the kernels are compiled for
CHUNK = WIDTHS[-1]   # past it: output chunks and Q.K^T slabs of this width
DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID_X = 2 ** 31 - 1   # either kernel's blocks: q tiles x B * H x chunks
BF16_Q_ROWS = 64     # the bf16 kernel's q rows a block
TMA_ALIGN = 16       # bytes: TMA's rule for a base address and a stride
BF16_STEP = TMA_ALIGN // 2   # a staged bf16 head dim is a multiple of this
SMEM_LIMIT = 232448  # shared memory a Hopper block can use (227 KB)
SM_SMEM = 233472     # shared memory of an H100 SM (228 KB)
SMEM_RESERVED = 1024  # of it kept by CUDA for each resident block
# the f32 kernel's plan by compiled width, flash_attention.cu's Plan<D>:
# threads a block and kv rows a tile.  A thread holds 8 q rows by 8 output
# columns, so D / 8 column groups and 8 * threads / (D / 8) q rows a block.
# A head dim past 256 runs its slabs at width 128 or 256, on their plans
F32_PLANS = {32: (64, 32), 64: (128, 64), 128: (256, 64), 256: (256, 32)}
MAX_CLUSTER = 8      # blocks of a portable cluster: f32 d up to 8 * 256


def width(d: int) -> int:
    """The compiled width head dim ``d`` runs at: the least of ``WIDTHS``
    at or above it, or the widest (each chunk's) past it.  Raises
    ``ValueError`` for a ``d`` below 1."""
    why = head_dim_refusal(d)
    if why is not None:
        raise ValueError(why)
    return next((w for w in WIDTHS if w >= d), CHUNK)


def chunks(d: int) -> int:
    """Output column chunks (and Q.K^T slabs) of ``CHUNK`` that head dim
    ``d`` takes: 1 up to 256.  The kernels' Q.K^T work grows by this
    factor: every chunk recomputes the scores over all of d."""
    return -(-d // CHUNK)


def head_dim_refusal(d: int) -> str | None:
    """Why the attention kernels do not take head dim ``d``, or None: only
    a ``d`` below 1, as for the Pallas kernel."""
    if d < 1:
        return f"head dim {d}: the kernels take any head dim from 1"
    return None


def f32_slabs(d: int) -> tuple:
    """(width, slabs) of the f32 kernel past 256: the slab width, 128 or
    256, and the ``ceil(d / width)`` blocks of a cluster: 128 where it pads
    d less than 256 does within ``MAX_CLUSTER`` slabs (Q.K^T and P.V sum
    fewer zero columns), else 256; past ``MAX_CLUSTER`` slabs of 256 the
    slab loop's ceil(d / 256) chunks, one block a cluster."""
    n128, n256 = -(-d // 128), -(-d // 256)
    if n128 <= MAX_CLUSTER and 128 * n128 < 256 * n256:
        return 128, n128
    return 256, n256


@dataclasses.dataclass(frozen=True)
class F32Plan:
    """One launch of the f32 kernel (see the design note in
    ``flash_attention.cu``)."""
    threads: int         # a block
    width: int           # D: the compiled width a block runs at
    col_groups: int      # TX: D / 8, a thread's 8 output columns
    row_groups: int      # TY: threads / TX, a thread's 8 q rows
    q_rows: int          # BQ: 8 * TY, q rows a block
    kv_rows: int         # BK: k and v rows a tile
    keys: int            # NS: BK / TX, a thread's keys in Q.K^T (1, 4, 8)
    smem_bytes: int      # Q^T, K (rows padded by 4), K^T, V, P^T (and a
    #                      cluster block's partial S, BQ x BK), f32
    q_tiles: int         # ceil(S / BQ)
    chunks: int          # blocks a (q tile, head): slabs of D columns
    cluster: int         # blocks a thread-block cluster: chunks past 256
    #                      (up to MAX_CLUSTER), else 1
    slabs: tuple         # each chunk's real columns (the last may be short)
    grid: int            # q_tiles * B * H * chunks, longest q tiles first
    blocks_per_sm: int   # as shared memory allows


def f32_plan(B: int, S: int, H: int, d: int) -> F32Plan:
    """Lay out the f32 kernel's launch for (B, S, H, d) queries: a block a
    (q tile, batch * head, slab) on a one-dimensional grid, at the
    compiled width :func:`width` of ``d`` up to 256, past it at
    :func:`f32_slabs`'s width, a cluster a (q tile, batch * head)."""
    D = width(d)
    n_cc, cluster = 1, 1
    if d > CHUNK:
        D, n_cc = f32_slabs(d)
        cluster = n_cc if n_cc <= MAX_CLUSTER else 1
    threads, bk = F32_PLANS[D]
    tx = D // 8
    ty = threads // tx
    bq = 8 * ty
    smem = 4 * (D * bq + bk * (D + 4) + D * bk + bk * D + bk * bq
                + (bk * bq if cluster > 1 else 0))
    q_tiles = -(-S // bq)
    return F32Plan(width=D, threads=threads, col_groups=tx, row_groups=ty,
                   q_rows=bq, kv_rows=bk, keys=bk // tx, smem_bytes=smem,
                   q_tiles=q_tiles, chunks=n_cc, cluster=cluster,
                   slabs=tuple(min(D, d - D * r) for r in range(n_cc)),
                   grid=q_tiles * B * H * n_cc,
                   blocks_per_sm=SM_SMEM // (smem + SMEM_RESERVED))


def f32_block_tile(plan: F32Plan, block: int, bh: int) -> tuple:
    """(q tile, batch * head) of the f32 kernel's block ``block`` among
    ``bh`` = B * H heads: the kernel's own order, every head's last q tile
    first, a head's slabs (:func:`f32_block_chunk`, a cluster's blocks)
    side by side."""
    per_tile = bh * plan.chunks
    return (plan.q_tiles - 1 - block // per_tile,
            block % per_tile // plan.chunks)


def f32_block_chunk(plan: F32Plan, block: int) -> int:
    """The slab (output column chunk) of the f32 kernel's block ``block``:
    its rank in its cluster."""
    return block % plan.chunks


def refusal(dtype: torch.dtype, B: int, S: int, H: int, K: int,
            d: int) -> str | None:
    """Why the kernels do not take q (B, S, H, d) against k, v (B, S, K,
    d) of ``dtype``, or None if they do."""
    if dtype not in DTYPES:
        return f"dtype {dtype}: the kernels take {DTYPES}"
    if min(B, S, H, K) < 1 or H % K:
        return "B, S, H and K at least 1, H a multiple of K"
    why = head_dim_refusal(d)
    if why is not None:
        return why
    blocks = (f32_plan(B, S, H, d).grid if dtype == torch.float32
              else -(-S // BF16_Q_ROWS) * B * H * chunks(d))
    if blocks > MAX_GRID_X:
        return (f"{blocks} blocks (q tiles x B * H x column chunks): the "
                f"{dtype} kernel's one-dimensional grid takes {MAX_GRID_X}")
    return None


def tma_misalignment(x: torch.Tensor) -> str | None:
    """Why TMA cannot describe ``x`` (its base address or a batch, sequence
    or head stride is not a multiple of 16 bytes), or None if it can."""
    if x.data_ptr() % TMA_ALIGN:
        return f"base address {x.data_ptr():#x}"
    bad = [s for s in x.stride()[:-1] if s * x.element_size() % TMA_ALIGN]
    return f"stride of {bad[0] * x.element_size()} bytes" if bad else None


def bf16_staging(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> str | None:
    """Why the bf16 kernel reads a staged copy of q, k and v (their head
    dim is not a multiple of 8, or :func:`tma_misalignment` names one of
    them), or None if it reads them in place."""
    d = q.shape[-1]
    if d % BF16_STEP:
        return f"head dim {d} is not a multiple of {BF16_STEP}"
    for name, x in (("q", q), ("k", k), ("v", v)):
        why = tma_misalignment(x)
        if why is not None:
            return f"{name} has a {why}"
    return None


def _staged(x: torch.Tensor, d8: int) -> torch.Tensor:
    """A contiguous copy of ``x`` with its head dim zero-padded to ``d8``."""
    buf = x.new_zeros(x.shape[:-1] + (d8,))
    buf[..., :x.shape[-1]] = x
    return buf


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q: (B, S, H, d), k and v: (B, S, K, d) CUDA tensors of one dtype (f32
    or bf16) on one device, head dim contiguous, H a multiple of K, any d
    from 1.  Causal.  Returns a new contiguous (B, S, H, d) tensor in q's
    dtype.

    The route is chosen by dtype, here and nowhere else: bf16 goes to the
    tensor-core kernel (TMA loads, wgmma products, P split into bf16 hi and
    lo), f32 to the SIMT kernel laid out by :func:`f32_plan`.  Neither
    falls back to the other.  What :func:`refusal` names raises
    ``ValueError``: a dtype it is not built for, H not a multiple of K, a
    head dim below 1, or a grid of more than ``MAX_GRID_X`` blocks.  bf16
    inputs that TMA cannot describe in place (:func:`bf16_staging`) are
    copied first into zeroed buffers of head dim ``d8``, the next multiple
    of 8: the zero columns add exact zeros to Q.K^T, the scale stays
    1/sqrt(d), and the output's first d columns are returned.  The f32
    kernel reads any strides in place (4-byte copies where 16-byte ones do
    not fit)."""
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
    why = "k and v must be (B, S, K, d) of q's B, S and d" \
        if k.shape != v.shape or k.shape != (B, S, K, d) \
        else refusal(q.dtype, B, S, H, K, d)
    if why is not None:
        raise ValueError(
            f"flash_attention kernel shapes q {tuple(q.shape)} k "
            f"{tuple(k.shape)} v {tuple(v.shape)}: {why}")
    scale = 1.0 / math.sqrt(d)
    if q.dtype == torch.bfloat16:
        d8 = -(-d // BF16_STEP) * BF16_STEP
        if bf16_staging(q, k, v) is not None:
            q, k, v = (_staged(x, d8) for x in (q, k, v))
        o = torch.empty((B, S, H, d8), dtype=q.dtype, device=q.device)
        extension().flash_attention_bf16(q, k, v, o, scale)
        return o if d8 == d else o[..., :d].contiguous()
    o = torch.empty((B, S, H, d), dtype=q.dtype, device=q.device)
    p = f32_plan(B, S, H, d)
    extension().flash_attention_f32(q, k, v, o, scale, p.q_rows, p.kv_rows,
                                    p.threads, p.smem_bytes, p.width,
                                    p.cluster)
    return o
