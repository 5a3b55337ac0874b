"""The f32 flash-attention kernel's launch plan, which runs on the CPU
(``repro_torch.kernels.flash_attention.kernel.f32_plan``), and the plain
version the CPU runs at the plan's tile boundaries against the JAX
package's oracle.

The plan must fit a Hopper block's shared memory (227 KB), tile the block
exactly (a thread's 8 q rows by 8 output columns, its keys in chunks of
4, or one key at width 256), cover every (q tile, batch * head) pair once
with every head's longest q tile first, past B * H = 65535 too; a head dim
runs at the least compiled width at or above it; the wrapper's refusals
follow the plan.  The plain version against the reference's
oracle (``impl="ref"``) within its f32 bar of 2e-5
(``tests/test_kernels.py``): sums in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention

WIDTHS = (32, 64, 128, 256)


@pytest.mark.parametrize("d", WIDTHS)
def test_plan_fits_a_hopper_block(d):
    p = fa_kernel.f32_plan(8, 1491, 12, d)
    assert p.smem_bytes <= fa_kernel.SMEM_LIMIT
    assert p.blocks_per_sm >= 1
    assert p.blocks_per_sm == fa_kernel.SM_SMEM // (
        p.smem_bytes + fa_kernel.SMEM_RESERVED)
    # d = 64, the served models' head dim: two blocks an SM; 256 (Gemma):
    # one, with 64 q rows and 32-row kv tiles
    if d == 64:
        assert p.blocks_per_sm == 2
    if d == 256:
        assert (p.blocks_per_sm, p.q_rows, p.kv_rows) == (1, 64, 32)


@pytest.mark.parametrize("d", WIDTHS)
def test_plan_tiles_the_block_exactly(d):
    p = fa_kernel.f32_plan(1, 1, 1, d)
    assert p.width == d and p.col_groups * 8 == d
    assert p.row_groups * p.col_groups == p.threads
    assert p.q_rows == 8 * p.row_groups
    # keys in chunks of 4 at BK/2 apart (NS 4 or 8), or one key a thread
    assert p.keys * p.col_groups == p.kv_rows and p.keys in (1, 4, 8)
    # P^T's swizzle runs over groups of 8 chunks of 4 rows
    assert p.q_rows % 32 == 0 and p.kv_rows % 8 == 0
    # the Q, K and V copies divide among the threads, 16 bytes each
    assert (p.q_rows * d // 4) % p.threads == 0
    assert (p.kv_rows * d // 4) % p.threads == 0
    # a row group's lanes share a warp, for the row's shuffles
    assert 32 % p.col_groups == 0 and p.threads % 32 == 0
    assert p.smem_bytes == 4 * (d * p.q_rows + p.kv_rows * (d + 4)
                                + d * p.kv_rows + p.kv_rows * d
                                + p.kv_rows * p.q_rows)


@pytest.mark.parametrize("B,S,H,d", [
    (8, 1491, 12, 64),      # the kernel table's shape
    (1, 2048, 64, 128),     # deepseek-67b's head layout
    (3, 200, 6, 32),
    (1024, 64, 64, 32),     # B * H = 65536, past the bf16 kernel's grid
    (70, 300, 1000, 64),    # B * H = 70000, three q tiles each
])
def test_grid_covers_each_tile_once_longest_first(B, S, H, d):
    p = fa_kernel.f32_plan(B, S, H, d)
    bh = B * H
    assert p.q_tiles == -(-S // p.q_rows) and p.grid == p.q_tiles * bh
    qi, head = fa_kernel.f32_block_tile(p, np.arange(p.grid), bh)
    assert qi.min() == 0 and qi.max() == p.q_tiles - 1
    assert head.min() == 0 and head.max() == bh - 1
    pairs = qi.astype(np.int64) * bh + head
    assert len(np.unique(pairs)) == p.grid
    # blocks start in index order, so the longest tiles (the most kv
    # tiles up to the diagonal) go first
    assert np.all(np.diff(qi) <= 0)


@pytest.mark.parametrize("d", WIDTHS)
def test_refusals_follow_the_plan(d):
    f32, bf16 = torch.float32, torch.bfloat16
    assert fa_kernel.refusal(f32, 1024, 64, 64, 64, d) is None
    # B * H = 65536 and 65600: both routes lie on one grid axis
    assert fa_kernel.refusal(bf16, 1024, 64, 64, 64, d) is None
    assert fa_kernel.refusal(bf16, 1025, 64, 64, 8, d) is None
    assert fa_kernel.refusal(bf16, 1023, 64, 64, 64, d) is None
    assert fa_kernel.refusal(f32, 2, 64, 6, 4, d) is not None   # H % K
    assert fa_kernel.refusal(torch.float16, 2, 64, 4, 4, d) is not None
    # the grid's x axis: q tiles x B * H blocks, in either route
    p = fa_kernel.f32_plan(2 ** 8, 2 ** 20, 2 ** 11, d)
    assert p.grid > fa_kernel.MAX_GRID_X
    for dt in (f32, bf16):
        why = fa_kernel.refusal(dt, 2 ** 8, 2 ** 20, 2 ** 11, 2 ** 11, d)
        assert why is not None and "grid" in why
    assert fa_kernel.refusal(bf16, 2 ** 8, 2 ** 12, 2 ** 11, 2 ** 11,
                             d) is None
    # a plan for each compiled width, and no other
    assert set(fa_kernel.F32_PLANS) == set(fa_kernel.WIDTHS) == set(WIDTHS)
    # every head dim up to 256 runs at the next width, past it in chunks
    # of 256; only a head dim below 1 raises, as in the Pallas kernel
    for good in (8, 16, 80, 96, 136, 248, 256):
        for dt in (f32, bf16):
            assert fa_kernel.refusal(dt, 1, 8, 2, 2, good) is None
        assert fa_kernel.f32_plan(1, 8, 2, good).width == min(
            w for w in WIDTHS if w >= good)
    for once_bad in (4, 12, 100, 257, 264):
        for dt in (f32, bf16):
            assert fa_kernel.refusal(dt, 1, 8, 2, 2, once_bad) is None
        p = fa_kernel.f32_plan(1, 8, 2, once_bad)
        # past 256 the f32 kernel's cluster of 128-column slabs (three
        # pad less than two of 256)
        assert p.width == (min(w for w in WIDTHS if w >= once_bad)
                           if once_bad <= 256 else 128)
        assert p.chunks == p.cluster == (1 if once_bad <= 256 else 3)
    for bad in (0, -3):
        for dt in (f32, bf16):
            why = fa_kernel.refusal(dt, 1, 8, 2, 2, bad)
            assert why is not None and "head dim" in why
        with pytest.raises(ValueError, match="from 1"):
            fa_kernel.f32_plan(1, 8, 2, bad)


def test_every_multiple_of_8_up_to_256_is_taken():
    """The wrapper's domain, by the plan alone: each multiple of 8 from 8
    to 256 has a width, a plan within a Hopper block and no refusal, in
    both routes."""
    for d in range(8, 257, 8):
        p = fa_kernel.f32_plan(2, 100, 4, d)
        assert p.width >= d and p.width // 2 < d or p.width == 32
        assert p.smem_bytes <= fa_kernel.SMEM_LIMIT
        for dt in fa_kernel.DTYPES:
            assert fa_kernel.refusal(dt, 2, 100, 4, 2, d) is None


def test_wrapper_raises_for_cpu_tensors():
    """The kernel's wrapper launches or raises: CPU tensors are the plain
    version's, through ``ops.flash_attention``."""
    x = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_kernel.flash_attention(x, x, x)


def _boundaries(d):
    p = fa_kernel.f32_plan(1, 1, 1, d)
    return [(d, S) for S in (p.kv_rows + 1, p.q_rows + 1)]


@pytest.mark.parametrize("d,S", [x for d in WIDTHS + (80, 96)
                                 for x in _boundaries(d)])
def test_plain_version_at_tile_boundaries_matches_oracle(d, S):
    """One row past a kv tile and past a q tile, GQA 2:1."""
    rng = np.random.default_rng(d * 1000 + S)
    q, k, v = (rng.normal(size=(1, S, n, d)).astype(np.float32)
               for n in (4, 2, 2))
    ref = jax_flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                              impl="ref")
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=0)
