"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device: it carries the ``cuda`` marker and
skips (inside its fixture) where there is none, as on a CPU-only machine.
On the card: ``python -m pytest -m cuda tests/test_torch_cuda.py``.  These
tests import neither jax nor the JAX package, so they run where only the
port is installed.

Tolerances: ``pair_scores`` within 1e-5 of ``a @ b.T`` (cuBLAS) — f32 sums of
up to 384 unit-bounded products in another order — with candidate sets
allowed to differ only within 1e-5 of the threshold; bf16 inputs within
2e-2; at the join cells' width D = 384 (ROADMAP C7) within the derived
gamma_D * sum |a_i b_i| of a float64 oracle.  ``pair_scores_compact`` against its plain version (``torch.bmm``) the
same way, with the candidates' order identical; against the dense kernel bit
for bit (both sum each cell with fmaf in k order from 0); against itself bit
for bit across calls and across chunkings of one tile list (positions come
from counts alone).  ``union_deduce``, the exact answer fold and the
service, under a perfect and under noisy crowds: bit for bit.  The
streaming index's epochs together equal the batch call bit for bit (dense
and blocked: a cell's score depends only on its two rows), and a lane
grown past 46340 objects folds through the wide ``union_deduce``.
A checkpoint written on the card restores on the CPU and the other way
round, and a lane whose keys widened to int64 restores with its dtype and
sentinel and folds through the wide kernel after the restore, every result
field the uninterrupted run's.
``flash_attention`` within 2e-5 and ``decode_attention`` within
1e-5 of their plain versions in f32 (the int8 cache too where its scales
are 1, so that its dequantized values are its integers) (sums in another order, the decode
kernel's split across the cache and merged in split order, so its repeats
agree bit for bit); in bf16 each
element within 2**-7 of the expected value plus 1e-4 (both sides sum in f32
and round once to bf16, one ulp being at most 2**-7 of the value): bf16
runs on the tensor-core kernel, f32 on the SIMT one, which is also held at
its plan's tile boundaries, GQA groups 1-8, views of a fused projection
(16-byte aligned or not) and B * H = 65536, and bit for bit across five
calls; its SASS has FMAs and cp.async copies and no tensor-core product.
Past head dim 256 (``-k head_dim``) f32 flash's cluster kernel (its slab
loop past 8 slabs of 256) and decode's wide kernel (its chunked kernel
past 4 vectors of 256, over bf16, f32 and int8 caches) are held to the
same rules at ragged S and lengths below S, GQA groups 1, 4 and 8 and
views no 16-byte copy reads, bit for bit across two calls, and through
the ops with their plain versions made to raise, their launch counters
moving.  The LM engine on the
card gives the same greedy tokens as on the CPU under f32 weights, RWKV's
and zamba2's too; zamba2's prefill and decode logits and states under f32
caches within 1e-4 of the CPU's, its shared block through each attention
kernel once an invocation.
Training: ``FlashAttentionFn``'s gradients against the plain version's
autograd gradients with the flash tolerances above; a train step bit for
bit across two runs; 3 reduced steps on the card within 2e-3 of the CPU's
losses (the bf16 bound of ``tests/test_torch_train.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.cluster_graph import NEG, POS
from repro_torch.core.crowd import PerfectCrowd
from repro_torch.core.graph import _union_impl, key_dtype, key_sentinel
from repro_torch.core.pairs import PairSet
from repro_torch.kernels.pair_scores import blocking
from repro_torch.kernels.pair_scores import kernel as ps_kernel
from repro_torch.kernels.pair_scores import ops as ps_ops
from repro_torch.kernels.pair_scores.ref import (pair_scores_compact_ref,
                                                 pair_scores_ref)
from repro_torch.kernels.pair_scores.sharded import sharded_candidates
from repro_torch.configs import get
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      dequantize)
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import mha_causal_ref
from repro_torch.models.layers import quantize_kv
from repro_torch.models.model import init_params
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.kernels.union_deduce import kernel as ud_kernel
from repro_torch.kernels.union_deduce import ops as ud_ops
from repro_torch.kernels.union_deduce.ref import union_deduce_ref
from repro_torch.serve.join_service import JoinService

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("N,M,D", [(4096, 4096, 384), (300, 200, 96),
                                   (128, 128, 32), (1, 129, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_scores_kernel_matches_plain(dev, N, M, D, dtype):
    gen = torch.Generator(device="cpu").manual_seed(N + M + D)
    a = torch.randn(N, D, generator=gen).to(dev, dtype)
    b = torch.randn(M, D, generator=gen).to(dev, dtype)
    b[: min(N, M) // 2] = a[: min(N, M) // 2] + 0.3 * b[: min(N, M) // 2]
    launches = ps_ops.pair_scores.launches
    s, c = ps_ops.pair_scores(a, b, 0.5)
    assert ps_ops.pair_scores.launches == launches + 1
    an, bn = ps_ops.l2_normalize(a), ps_ops.l2_normalize(b)
    s_ref, c_ref = pair_scores_ref(an, bn, 0.5)
    torch.cuda.synchronize()
    flips = (s != 0) != (s_ref != 0)
    near = ((an.float() @ bn.float().T) - 0.5).abs() <= 1e-5
    assert not (flips & ~near).any()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(s[~flips], s_ref[~flips], rtol=0, atol=tol)
    if not flips.any():
        torch.testing.assert_close(c[:, 0], c_ref, rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_scores_kernel_at_width_384_within_derived_bound(dev, seed):
    """ROADMAP C7 on the card: clustered f32 embeddings at D = 384 (200 x
    150 rows of 12 entities, as tests/test_torch_pair_scores.py builds
    them), normalized on the card, through the CUDA ``pair_scores`` at tau
    0.8, against a float64 oracle on the same normalized rows.  An f32 dot
    of length D, in any order, is within gamma_D * sum |a_i b_i| of the
    exact value (u = 2**-24, gamma_D = D u / (1 - D u)); the f64 oracle's
    own error is below 1e-13.  The candidate set must equal the oracle's
    but for pairs within that bound of tau, whose number is reported."""
    D, tau, u = 384, 0.8, 2.0 ** -24
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(12, D))
    ia, ib = rng.integers(0, 12, 200), rng.integers(0, 12, 150)
    a = (cents[ia] + 0.15 * rng.normal(size=(200, D))).astype(np.float32)
    b = (cents[ib] + 0.15 * rng.normal(size=(150, D))).astype(np.float32)
    an = ps_ops.l2_normalize(torch.from_numpy(a).to(dev))
    bn = ps_ops.l2_normalize(torch.from_numpy(b).to(dev))
    s, c = ps_ops.pair_scores(an, bn, tau, normalize=False)
    torch.cuda.synchronize()
    a64 = an.cpu().numpy().astype(np.float64)
    b64 = bn.cpu().numpy().astype(np.float64)
    exact = a64 @ b64.T
    bound = D * u / (1 - D * u) * (np.abs(a64) @ np.abs(b64).T)
    s = s.cpu().numpy().astype(np.float64)
    got, want = s != 0, exact >= tau
    near = np.abs(exact - tau) <= bound
    assert not (got != want)[~near].any()
    both = got & want
    err = np.abs(s - exact)[both]
    assert both.sum() > 0 and bool((err <= bound[both]).all())
    print(f"C7 card seed {seed}: {int(both.sum())} candidates, max |d| "
          f"{err.max():.3e} ({err.max() / 2.0 ** -23:.1f} ulp of 1.0; "
          f"worst {float((err / bound[both]).max()):.4f} of the bound), "
          f"{int(near.sum())} pairs within the bound of tau")
    if not near.any():
        np.testing.assert_array_equal(c.cpu().numpy()[:, 0], want.sum(1))


def _unit_rows(dev, N, M, D, seed):
    """(N, D) and (M, D) unit f32 rows on the card, half of b near a."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn(N, D, generator=gen)
    b = torch.randn(M, D, generator=gen)
    k = min(N, M) // 2
    b[:k] = a[:k] + 0.5 * b[:k]
    return ps_ops.l2_normalize(a.to(dev)), ps_ops.l2_normalize(b.to(dev))


# N = M = 384: an odd number of tiles a side; D = 16: one k slice; D = 768:
# twice the join cells' width; m_valid < M: counts over the real columns
@pytest.mark.parametrize("N,M,D,m_valid", [(384, 384, 384, 384),
                                           (512, 256, 16, 256),
                                           (256, 512, 768, 512),
                                           (256, 512, 64, 300)])
def test_pair_scores_kernel_shapes_and_counts(dev, N, M, D, m_valid):
    """The kernel on already padded inputs against its plain version:
    scores within 1e-5 with set flips only within 1e-5 of tau, and the
    counts over the first ``m_valid`` columns exactly."""
    a, b = _unit_rows(dev, N, M, D, seed=N + M + D)
    tau = 0.5
    s, c = ps_kernel.pair_scores(a, b, tau, m_valid)
    s_ref, _ = pair_scores_ref(a, b, tau)
    torch.cuda.synchronize()
    flips = (s != 0) != (s_ref != 0)
    near = ((a @ b.T) - tau).abs() <= 1e-5
    assert not (flips & ~near).any()
    torch.testing.assert_close(s[~flips], s_ref[~flips], rtol=0, atol=1e-5)
    assert (s_ref != 0).any()
    if not near.any():
        want = (s_ref[:, :m_valid] != 0).sum(1, dtype=torch.int32)
        assert torch.equal(c, want)


def test_pair_scores_kernel_repeats_bitwise(dev):
    """Five calls at the main path's (4096, 384)^2 agree bit for bit, the
    counts too (integer atomics, in any order)."""
    a, b = _unit_rows(dev, 4096, 4096, 384, seed=9)
    outs = [ps_kernel.pair_scores(a, b, 0.5, 4096) for _ in range(5)]
    assert int(outs[0][1].sum()) > 0
    for out in outs[1:]:
        for x, y in zip(out, outs[0]):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("D", [16, 384, 768])
def test_pair_scores_kernel_equals_compact_tiles_bitwise(dev, D):
    """The dense kernel and the compact kernel over every tile pair of a
    dense tiling run one mainloop (score_tile.cuh): every candidate cell
    scores bit for bit alike."""
    N, M = 384, 256
    a, b = _unit_rows(dev, N, M, D, seed=D)
    s, _ = ps_kernel.pair_scores(a, b, 0.5, M)
    ti, tj = torch.meshgrid(torch.arange(N // 128), torch.arange(M // 128),
                            indexing="ij")
    ti, tj = ti.flatten().to(dev), tj.flatten().to(dev)
    rows_a = (ti[:, None] * 128 + torch.arange(128, device=dev)).flatten()
    rows_b = (tj[:, None] * 128 + torch.arange(128, device=dev)).flatten()
    rows, cols, scores, n = ps_kernel.pair_scores_compact(
        a[rows_a].contiguous(), b[rows_b].contiguous(),
        rows_a[:, None].to(torch.int32), rows_b[:, None].to(torch.int32),
        0.5, len(ti) * 128 * 128, 128, 128)
    n = int(n)
    assert n == int((s != 0).sum()) > 0
    r, c = rows[:n, 0].long(), cols[:n, 0].long()
    assert torch.equal(scores[:n, 0].view(torch.int32),
                       s[r, c].view(torch.int32))


def _tiles(dev, T, bn, bm, D, dtype, seed):
    """T gathered tile pairs of correlated unit rows, with a quarter of the
    ids (and their rows) padding."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn(T * bn, D, generator=gen)
    b = torch.randn(T * bm, D, generator=gen)
    k = min(bn, bm)
    b.view(T, bm, D)[:, :k] = a.view(T, bn, D)[:, :k] \
        + 0.6 * b.view(T, bm, D)[:, :k]
    a, b = ps_ops.l2_normalize(a), ps_ops.l2_normalize(b)
    ida = torch.arange(T * bn, dtype=torch.int32)
    idb = torch.arange(T * bm, dtype=torch.int32)
    ida[torch.rand(T * bn, generator=gen) < 0.25] = -1
    idb[torch.rand(T * bm, generator=gen) < 0.25] = -1
    a[ida < 0] = 0.0
    b[idb < 0] = 0.0
    return (a.to(dev, dtype), b.to(dev, dtype), ida[:, None].to(dev),
            idb[:, None].to(dev))


# T = 1: tile 0 alone, no look-back; T = 265: past the 264 blocks two a SM
# hold on 132 SMs, so the last tiles start only when earlier ones finished.
# Past 128 rows a side the band kernel: bands of 128 rows on clusters of 2,
# 2 or 1 blocks, a ragged last band and column block, one column; a last
# band and column block of at most 64 (half a thread tile's FMAs left out);
# past 8 column blocks (a block takes every eighth, two and three rounds)
@pytest.mark.parametrize("T,bn,bm,D", [(256, 128, 128, 384), (7, 128, 128, 96),
                                       (33, 16, 16, 16), (5, 24, 100, 40),
                                       (1, 1, 128, 3), (1, 128, 128, 384),
                                       (2 * 132 + 1, 128, 128, 384),
                                       (64, 256, 256, 384), (9, 200, 136, 96),
                                       (32, 512, 64, 384), (3, 64, 512, 16),
                                       (2, 129, 1, 16), (300, 256, 256, 16),
                                       (5, 190, 190, 64), (2, 130, 1029, 16),
                                       (1, 1, 2049, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_scores_compact_kernel_matches_plain(dev, T, bn, bm, D, dtype):
    """Ids here are the flat gather positions, so each candidate names its
    cell: the kernel's list and the plain one may differ only in cells
    within 1e-5 of the threshold, and both are in (tile, row, col) order."""
    a_g, b_g, ida, idb = _tiles(dev, T, bn, bm, D, dtype, seed=T + bn + D)
    tau, cap = 0.5, T * bn * bm
    launches = ps_ops.pair_scores_compact.launches
    rows, cols, scores, n = ps_ops.pair_scores_compact(a_g, b_g, ida, idb,
                                                       tau, cap, bn, bm)
    assert ps_ops.pair_scores_compact.launches == launches + 1
    r_rows, r_cols, r_scores, r_n = pair_scores_compact_ref(
        a_g, b_g, ida, idb, tau, cap, bn, bm)
    torch.cuda.synchronize()
    n, r_n = int(n), int(r_n)
    assert n > 0
    s = torch.bmm(a_g.float().view(T, bn, -1),
                  b_g.float().view(T, bm, -1).transpose(1, 2))
    keys = rows[:n, 0].long() * (T * bm) + cols[:n, 0].long()
    r_keys = r_rows[:r_n, 0].long() * (T * bm) + r_cols[:r_n, 0].long()
    assert bool((keys[1:] > keys[:-1]).all())
    assert bool((r_keys[1:] > r_keys[:-1]).all())
    in_ref = torch.isin(keys, r_keys)
    flips = torch.cat([keys[~in_ref], r_keys[~torch.isin(r_keys, keys)]])
    fr, fc = flips // (T * bm), flips % (T * bm)
    near = (s[fr // bn, fr % bn, fc % bm] - tau).abs() <= 1e-5
    assert bool(near.all())
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    common = scores[:n, 0][in_ref]
    r_common = r_scores[:r_n, 0][torch.isin(r_keys, keys)]
    torch.testing.assert_close(common, r_common, rtol=0, atol=tol)
    assert (rows[n:cap] == -1).all() and (scores[n:cap] == 0).all()


def test_pair_scores_compact_kernel_is_the_dense_kernel_bitwise(dev):
    gen = torch.Generator(device="cpu").manual_seed(5)
    a = torch.randn(700, 384, generator=gen)
    b = torch.randn(600, 384, generator=gen)
    b[:300] = a[:300] + 0.5 * b[:300]
    a = ps_ops.l2_normalize(a.to(dev))
    b = ps_ops.l2_normalize(b.to(dev))
    cfg = blocking.BlockingConfig(bn=128, bm=128, tiles_per_call=8)
    ta, tb = blocking.dense_block_pairs(700, 600, 128, 128)
    got = blocking.score_block_pairs(a, b, ta, tb, 0.5, cfg)
    ref = sharded_candidates(a, b, 0.5, normalize=False)
    assert len(ref.rows) > 0 and got.n_dropped == ref.n_dropped == 0
    np.testing.assert_array_equal(got.rows, ref.rows)
    np.testing.assert_array_equal(got.cols, ref.cols)
    np.testing.assert_array_equal(got.scores.view(np.int32),
                                  ref.scores.view(np.int32))


def test_pair_scores_compact_kernel_overflow_keeps_the_prefix(dev):
    a_g, b_g, ida, idb = _tiles(dev, 40, 128, 64, 64, torch.float32, seed=1)
    full = ps_ops.pair_scores_compact(a_g, b_g, ida, idb, 0.5,
                                      40 * 128 * 64, 128, 64)
    n = int(full[3])
    cap = n // 2
    part = ps_ops.pair_scores_compact(a_g, b_g, ida, idb, 0.5, cap, 128, 64)
    assert int(part[3]) == n > 0
    for x, y in zip(part[:3], full[:3]):
        assert torch.equal(x[:cap], y[:cap])
        assert bool((x[cap:] == (0 if x.is_floating_point() else -1)).all())


@pytest.mark.parametrize("bn,bm", [(256, 256), (200, 136), (512, 64)])
def test_pair_scores_compact_kernel_takes_wide_tiles(dev, bn, bm):
    """Tiles past 128 rows a side run the band kernel: a dense tiling gives
    the dense kernel's candidates bit for bit (both score a cell with the
    same fmaf chain), five calls agree bit for bit, an overflowing
    capacity keeps the prefix and the true count, and the kernel keeps no
    stack frame and spills nothing."""
    from repro_torch.kernels._build import resources

    gen = torch.Generator(device="cpu").manual_seed(bn + bm)
    a = torch.randn(700, 384, generator=gen)
    b = torch.randn(600, 384, generator=gen)
    b[:300] = a[:300] + 0.5 * b[:300]
    a = ps_ops.l2_normalize(a.to(dev))
    b = ps_ops.l2_normalize(b.to(dev))
    cfg = blocking.BlockingConfig(bn=bn, bm=bm, tiles_per_call=3)
    ta, tb = blocking.dense_block_pairs(700, 600, bn, bm)
    got = blocking.score_block_pairs(a, b, ta, tb, 0.5, cfg)
    ref = sharded_candidates(a, b, 0.5, normalize=False)
    assert len(ref.rows) > 0 and got.n_dropped == ref.n_dropped == 0
    np.testing.assert_array_equal(got.rows, ref.rows)
    np.testing.assert_array_equal(got.cols, ref.cols)
    np.testing.assert_array_equal(got.scores.view(np.int32),
                                  ref.scores.view(np.int32))
    a_g, b_g, ida, idb = _tiles(dev, 40, bn, bm, 96, torch.float32, seed=bm)
    outs = [ps_kernel.pair_scores_compact(a_g, b_g, ida, idb, 0.5,
                                          40 * bn * bm, bn, bm)
            for _ in range(5)]
    n = int(outs[0][3])
    assert n > 0
    for out in outs[1:]:
        for x, y in zip(out, outs[0]):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    part = ps_kernel.pair_scores_compact(a_g, b_g, ida, idb, 0.5, n // 2,
                                         bn, bm)
    assert int(part[3]) == n
    for x, y in zip(part[:3], outs[0][:3]):
        assert torch.equal(x[:n // 2], y[:n // 2])
    res = resources("pair_scores_compact_band_kernel")
    assert res["STACK"] == 0 and res["LOCAL"] == 0, res


def test_pair_scores_compact_band_kernel_raises_where_no_cluster_fits(
        dev, monkeypatch):
    """A card that cannot place the band kernel's cluster gets a
    RuntimeError naming the shape, not another kernel or the plain
    version."""
    a_g, b_g, ida, idb = _tiles(dev, 2, 256, 256, 16, torch.float32, seed=2)
    monkeypatch.setattr(ps_kernel, "_band_clusters_placeable",
                        lambda device, cluster: 0)
    launches = ps_ops.pair_scores_compact.launches
    with pytest.raises(RuntimeError, match="cluster of 2 blocks for tiles "
                       "of 256 x 256"):
        ps_ops.pair_scores_compact(a_g, b_g, ida, idb, 0.5, 2 * 256 * 256,
                                   256, 256)
    assert ps_ops.pair_scores_compact.launches == launches


def test_pair_scores_compact_kernel_repeats_bitwise(dev):
    """Positions come only from counts: five calls on one chunk agree bit
    for bit, whichever blocks finish first."""
    a_g, b_g, ida, idb = _tiles(dev, 256, 128, 128, 384, torch.float32,
                                seed=3)
    outs = [ps_kernel.pair_scores_compact(a_g, b_g, ida, idb, 0.5,
                                          256 * 128 * 128, 128, 128)
            for _ in range(5)]
    assert int(outs[0][3]) > 0
    for out in outs[1:]:
        for x, y in zip(out, outs[0]):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_pair_scores_compact_kernel_whole_session_equals_chunks(dev):
    """One call over every tile of a blocked session (16384 rows a side,
    the reference's 6-bit, 8-table, 128 x 128 config: thousands of tiles,
    several waves) equals the concatenation of its 256-tile chunk calls,
    bit for bit, with the true count."""
    gen = torch.Generator(device="cpu").manual_seed(11)
    n, D = 16384, 384
    cents = torch.randn(2048, D, generator=gen)
    a = cents[torch.randint(0, 2048, (n,), generator=gen)] \
        + 0.4 * torch.randn(n, D, generator=gen)
    b = cents[torch.randint(0, 2048, (n,), generator=gen)] \
        + 0.4 * torch.randn(n, D, generator=gen)
    a = ps_ops.l2_normalize(a.to(dev))
    b = ps_ops.l2_normalize(b.to(dev))
    cfg = blocking.BlockingConfig(n_bits=6, n_tables=8, bn=128, bm=128,
                                  tiles_per_call=256)
    every = np.arange(n)
    tiles_a, tiles_b = blocking.block_pairs(
        blocking.signatures(a, cfg), every, blocking.signatures(b, cfg),
        every, 128, 128)
    T = len(tiles_a)
    assert T > 4 * 256

    def gather(ta, tb):
        a_ext = torch.cat([a, a.new_zeros((1, D))])
        b_ext = torch.cat([b, b.new_zeros((1, D))])
        ga = torch.from_numpy(np.where(ta < 0, n, ta).reshape(-1)).to(dev)
        gb = torch.from_numpy(np.where(tb < 0, n, tb).reshape(-1)).to(dev)
        return (a_ext[ga], b_ext[gb],
                torch.from_numpy(ta.reshape(-1, 1).astype(np.int32)).to(dev),
                torch.from_numpy(tb.reshape(-1, 1).astype(np.int32)).to(dev))

    parts, total = [], 0
    for t0 in range(0, T, 256):
        ta, tb = tiles_a[t0:t0 + 256], tiles_b[t0:t0 + 256]
        out = ps_kernel.pair_scores_compact(*gather(ta, tb), 0.7,
                                            len(ta) * 128 * 128, 128, 128)
        k = int(out[3])
        parts.append([x[:k] for x in out[:3]])
        total += k
    whole = ps_kernel.pair_scores_compact(*gather(tiles_a, tiles_b), 0.7,
                                          T * 128 * 128, 128, 128)
    assert int(whole[3]) == total > 0
    for i, x in enumerate(whole[:3]):
        cat = torch.cat([p[i] for p in parts])
        assert torch.equal(x[:total].view(torch.int32),
                           cat.view(torch.int32))
        assert bool((x[total:] == (0 if x.is_floating_point() else -1)).all())


def test_pair_scores_compact_kernel_chunk_without_candidates(dev):
    """Every id -1: no tile keeps a cell, n_total is 0 and the outputs keep
    their fill."""
    a_g, b_g, ida, idb = _tiles(dev, 256, 128, 128, 64, torch.float32,
                                seed=4)
    rows, cols, scores, n = ps_kernel.pair_scores_compact(
        a_g, b_g, torch.full_like(ida, -1), torch.full_like(idb, -1), 0.5,
        1000, 128, 128)
    assert int(n) == 0
    assert (rows == -1).all() and (cols == -1).all() and (scores == 0).all()


def test_pair_scores_compact_kernel_capacity_zero(dev):
    """capacity 0: nothing is written, and n_total is still the true
    count."""
    a_g, b_g, ida, idb = _tiles(dev, 40, 128, 64, 64, torch.float32, seed=1)
    full = ps_kernel.pair_scores_compact(a_g, b_g, ida, idb, 0.5,
                                         40 * 128 * 64, 128, 64)
    rows, cols, scores, n = ps_kernel.pair_scores_compact(
        a_g, b_g, ida, idb, 0.5, 0, 128, 64)
    assert rows.shape == (128 * 64, 1)
    assert int(n) == int(full[3]) > 0
    assert (rows == -1).all() and (cols == -1).all() and (scores == 0).all()


def _lanes(dev, n, p, lanes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(lanes):
        u = torch.from_numpy(rng.integers(0, n, p).astype(np.int32)).to(dev)
        v = torch.from_numpy(rng.integers(0, n, p).astype(np.int32)).to(dev)
        cluster = torch.from_numpy(rng.integers(0, max(2, n // 3), n)).to(dev)
        truth = cluster[u.long()] == cluster[v.long()]
        stage = torch.from_numpy(rng.integers(0, 3, p)).to(dev)
        parent0 = _union_impl(torch.arange(n, dtype=torch.int32, device=dev),
                              u, v, (stage == 0) & truth, n)
        ru, rv = parent0[u.long()], parent0[v.long()]
        kdt = key_dtype(n)
        keys = torch.minimum(ru, rv).to(kdt) * n + torch.maximum(ru, rv)
        negk = torch.where((stage == 0) & ~truth & (ru != rv), keys,
                           key_sentinel(kdt)).sort().values
        noise = torch.from_numpy(rng.random(p) < 0.01).to(dev)
        pos = (stage == 2) & (truth | noise)
        out.append((parent0, u, v, pos, negk))
    return [torch.stack(x) for x in zip(*out)]


@pytest.mark.parametrize("n,p,lanes", [(8192, 131072, 4), (64, 200, 7),
                                       (46340, 4096, 2)])
def test_union_deduce_kernel_matches_plain(dev, n, p, lanes):
    args = _lanes(dev, n, p, lanes, seed=n + p)
    got = ud_kernel.union_deduce(*args, n)
    exp = union_deduce_ref(*args, n)
    for name, g, e in zip(("roots", "deduced", "conflict"), got, exp):
        assert torch.equal(g, e), name
    assert (got[1] == NEG).any() and (got[1] == POS).any()


@pytest.mark.parametrize("n", [8192, 46340])
def test_union_deduce_kernel_path_graph(dev, n):
    u = torch.arange(n - 1, dtype=torch.int32, device=dev)[None]
    args = (torch.arange(n, dtype=torch.int32, device=dev)[None], u, u + 1,
            torch.ones_like(u, dtype=torch.bool),
            torch.full_like(u, key_sentinel(torch.int32)), n)
    roots, ded, conflict = ud_kernel.union_deduce(*args)
    assert not roots.any() and (ded == POS).all() and not conflict.any()


def _assert_union_deduce_equal(args):
    got = ud_kernel.union_deduce(*args)
    exp = union_deduce_ref(*args)
    for name, g, e in zip(("roots", "deduced", "conflict"), got, exp):
        assert torch.equal(g, e), name
    return got


# lanes 1, 4 and 7; the largest forest; P = 1; P that the cluster does
# not divide; a lane count that leaves clusters of the last wave alone
@pytest.mark.parametrize("n,p,lanes", [(5000, 30011, 1), (8192, 131072, 4),
                                       (300, 1001, 7), (46340, 20000, 1),
                                       (16, 1, 3), (2048, 8 * 1000 + 3, 4)])
def test_union_deduce_cluster_kernel_matches_plain(dev, n, p, lanes):
    """Bit for bit against the plain version, the launch's plan asked of
    the card first (a cluster it cannot place raises)."""
    pl = ud_kernel.plan(n, p, lanes)
    assert ud_kernel._clusters_placeable(torch.cuda.current_device(),
                                         pl.smem_bytes) > 0
    _assert_union_deduce_equal((*_lanes(dev, n, p, lanes, seed=n + p), n))


@pytest.mark.parametrize("center", ["least", "largest"])
@pytest.mark.parametrize("n", [8192, 46340])
def test_union_deduce_kernel_star_graph(dev, center, n):
    """Every edge meets one object: hooked under the least id it is one
    trip; at the largest id every hook of the first trip lands on one
    object's parent, so the union needs more trips."""
    c = 0 if center == "least" else n - 1
    others = torch.tensor([x for x in range(n) if x != c], dtype=torch.int32,
                          device=dev)[None]
    args = (torch.arange(n, dtype=torch.int32, device=dev)[None],
            torch.full_like(others, c), others,
            torch.ones_like(others, dtype=torch.bool),
            torch.full_like(others, key_sentinel(torch.int32)), n)
    roots, ded, conflict = _assert_union_deduce_equal(args)
    assert not roots.any() and (ded == POS).all() and not conflict.any()


def test_union_deduce_kernel_deduce_only(dev):
    """The round engine's deduce call: no POS bit, so the union is a no-op
    and the forest comes back as it went in; NEG from the neg index."""
    parent0, u, v, pos, negk = _lanes(dev, 8192, 131072, 4, seed=2)
    args = (parent0, u, v, torch.zeros_like(pos), negk, 8192)
    roots, ded, conflict = _assert_union_deduce_equal(args)
    assert torch.equal(roots, parent0) and not conflict.any()
    assert (ded == NEG).any() and (ded == POS).any()


def test_union_deduce_kernel_repeats_bitwise(dev):
    """Five calls agree bit for bit, with lanes that conflict and lanes that
    do not: the kernel writes its conflict and error flags itself, whatever
    the memory it is handed held before."""
    parent0, u, v, pos, negk = _lanes(dev, 8192, 131072, 4, seed=7)
    pos[1::2] = False       # lanes 1 and 3 unite nothing: no conflict
    args = (parent0, u, v, pos, negk, 8192)
    exp = union_deduce_ref(*args)
    assert exp[2].any() and not exp[2].all()
    outs = []
    for _ in range(5):
        junk = torch.ones(4, dtype=torch.int32, device=dev)
        del junk    # freed memory of the flags' size, holding ones
        outs.append(ud_kernel.union_deduce(*args))
    for out in outs:
        for x, y in zip(out, exp):
            assert torch.equal(x, y)


@pytest.mark.parametrize("n", [50000, 65536])
def test_union_deduce_kernel_refuses_oversized_forest(dev, n):
    """Past ``MAX_OBJECTS`` objects the wrapper refuses an int32 key index
    (its keys need int64) and runs the wide kernel on int64 keys: bit for
    bit against the plain version on stacked lanes with neg keys and
    conflicts, and on a path graph (pointer jumping's worst case)."""
    z = torch.zeros(1, 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int64"):
        ud_kernel.union_deduce(torch.zeros(1, n, dtype=torch.int32,
                                           device=dev), z, z, z.bool(), z, n)
    assert ud_kernel.plan(n, 20000, 3).wide
    parent0, u, v, pos, negk = _lanes(dev, n, 20000, 3, seed=n)
    assert negk.dtype == torch.int64 and (negk[0] < key_sentinel(
        torch.int64)).any()
    # lane 0 unites the two roots of its first neg key: a conflict
    u[0, 0], v[0, 0], pos[0, 0] = negk[0, 0] // n, negk[0, 0] % n, True
    roots, ded, conflict = _assert_union_deduce_equal(
        (parent0, u, v, pos, negk, n))
    assert conflict[0] and (ded == NEG).any() and (ded == POS).any()
    u = torch.arange(n - 1, dtype=torch.int32, device=dev)[None]
    roots, ded, conflict = _assert_union_deduce_equal((
        torch.arange(n, dtype=torch.int32, device=dev)[None], u, u + 1,
        torch.ones_like(u, dtype=torch.bool),
        torch.full_like(u, key_sentinel(torch.int64), dtype=torch.int64), n))
    assert not roots.any() and (ded == POS).all() and not conflict.any()


@pytest.mark.parametrize("lanes", [1, 8])
def test_union_deduce_wide_kernel_at_the_large_universe_size(dev, lanes):
    """The wide kernel at phase 4g's round-1 screen size (65536 objects,
    524288 pairs): one lane on the whole cooperative grid, and eight stacked
    lanes sharing it; lane 0 unites the roots of its first neg key (a
    conflict).  Bit for bit against the plain version, five calls bit for
    bit, on more blocks than one cluster's 16."""
    n, p = 65536, 524288
    parent0, u, v, pos, negk = _lanes(dev, n, p, lanes, seed=lanes)
    u[0, 0], v[0, 0], pos[0, 0] = negk[0, 0] // n, negk[0, 0] % n, True
    args = (parent0, u, v, pos, negk, n)
    pl = ud_kernel.plan(n, p, lanes,
                        ud_kernel._wide_blocks(torch.cuda.current_device()))
    assert pl.wide and pl.grid > ud_kernel.CLUSTER
    roots, ded, conflict = _assert_union_deduce_equal(args)
    assert conflict[0] and (ded == NEG).any() and (ded == POS).any()
    for _ in range(5):
        out = ud_kernel.union_deduce(*args)
        for x, y in zip(out, (roots, ded, conflict)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("n", [50000, 65536])
def test_union_deduce_wide_kernel_star_on_the_largest_id(dev, n):
    """Every edge meets the largest id: each hook of the lock-free union
    lands on one root, so its atomicCAS loses and climbs again and again.
    Every object ends at 0, bit for bit the plain version's."""
    c = n - 1
    others = torch.arange(n - 1, dtype=torch.int32, device=dev)[None]
    args = (torch.arange(n, dtype=torch.int32, device=dev)[None],
            torch.full_like(others, c), others,
            torch.ones_like(others, dtype=torch.bool),
            torch.full_like(others, key_sentinel(torch.int64),
                            dtype=torch.int64), n)
    roots, ded, conflict = _assert_union_deduce_equal(args)
    assert not roots.any() and (ded == POS).all() and not conflict.any()


def test_union_deduce_wide_kernel_refuses_rather_than_the_plain_version(dev):
    """What the wide kernel does not take raises a ValueError through the
    public wrapper, which counts no launch and never runs the plain
    version for a CUDA forest."""
    n = 50000
    z = torch.zeros(1, 4, dtype=torch.int32, device=dev)
    forest = torch.zeros(1, n, dtype=torch.int32, device=dev)
    before = (ud_ops.union_deduce.launches, ud_ops.union_deduce.wide_launches)
    for bad in ((forest, z, z, z.bool(), z.long().cpu(), n),    # keys on CPU
                (forest, z, z, z.bool(), z, n),                # int32 keys
                (forest, z, z[:, :3], z.bool(), z.long(), n),  # shapes
                (forest, z, z, z.bool(), z.long(), n + 1)):    # n
        with pytest.raises(ValueError):
            ud_ops.union_deduce(*bad)
    assert (ud_ops.union_deduce.launches,
            ud_ops.union_deduce.wide_launches) == before


def test_service_on_card_matches_cpu(dev):
    rng = np.random.default_rng(0)
    sessions = []
    for _ in range(5):
        n, p = int(rng.integers(20, 60)), int(rng.integers(40, 300))
        u = rng.integers(0, n, p)
        v = (u + 1 + rng.integers(0, n - 1, p)) % n
        ent = rng.integers(0, n // 4, n)
        truth = ent[u] == ent[v]
        lik = np.clip(np.where(truth, 0.8, 0.3)
                      + 0.2 * rng.standard_normal(p), 0, 1)
        sessions.append(PairSet(u, v, lik, truth, n))
    results = []
    for device in (dev, "cpu"):
        svc = JoinService(lanes=2, order="adaptive", device=device)
        rids = [svc.submit(ps, PerfectCrowd()) for ps in sessions]
        res = svc.run()
        results.append([res[r] for r in rids])
    for card, cpu in zip(*results):
        np.testing.assert_array_equal(card.labels, cpu.labels)
        np.testing.assert_array_equal(card.crowdsourced, cpu.crowdsourced)
        assert card.round_sizes == cpu.round_sizes
        assert (card.fold_rounds, card.n_spent_cents, card.quality) == \
            (cpu.fold_rounds, cpu.n_spent_cents, cpu.quality)


def _noisy_sessions(seed: int, n_sessions: int):
    """Entity-clustered sessions dense enough that a crowd erring 35% of
    the time contradicts transitivity."""
    rng = np.random.default_rng(seed)
    sessions = []
    for _ in range(n_sessions):
        n, p = int(rng.integers(25, 36)), int(rng.integers(120, 201))
        u = rng.integers(0, n, p)
        v = (u + 1 + rng.integers(0, n - 1, p)) % n
        ent = rng.integers(0, 4, n)
        truth = ent[u] == ent[v]
        lik = np.clip(np.where(truth, 0.7, 0.4)
                      + 0.25 * rng.standard_normal(p), 0, 1)
        sessions.append(PairSet(u, v, lik, truth, n))
    return sessions


@pytest.mark.parametrize("batched", [False, True])
def test_exact_fold_on_card_matches_cpu(dev, batched):
    """Noisy answer streams folded on a CUDA state and on a CPU state: the
    screen and the deduce through the kernel on the card, the exact replay
    on the lanes whose screen fired; every field and the conflict masks bit
    for bit, and the replay ran."""
    from repro_torch.convert import (session_state_from_numpy,
                                     session_state_to_numpy)
    from repro_torch.core import graph

    sessions = _noisy_sessions(1, 3)
    p_cap = 256
    states = [graph.make_session_state(ps.u, ps.v, ps.n_objects,
                                       pair_capacity=p_cap,
                                       object_capacity=64, device="cpu")
              for ps in sessions]
    snap = session_state_to_numpy(graph.stack_states(states))
    rng = np.random.default_rng(2)
    rejected, launches = 0, ud_ops.union_deduce.launches
    for _ in range(30):
        labels = snap["labels"]
        if not (labels == -1).any():
            break
        upd = np.full(labels.shape, -1, np.int32)
        for b, ps in enumerate(sessions):
            open_ = np.flatnonzero(labels[b, :len(ps)] == -1)
            pick = open_[rng.random(len(open_)) < 0.5]
            flip = rng.random(len(pick)) < 0.35
            upd[b, pick] = np.where(ps.truth[pick] ^ flip, POS, NEG)
        if batched:
            cpu = graph.session_fold_answers_batch(
                session_state_from_numpy(snap, "cpu"), upd)
            card = graph.session_fold_answers_batch(
                session_state_from_numpy(snap, dev), upd)
        else:
            outs = [[graph.session_fold_answers(session_state_from_numpy(
                {f: x[b] for f, x in snap.items()}, device), upd[b])
                for b in range(len(sessions))] for device in ("cpu", dev)]
            cpu, card = ((graph.stack_states([o[0] for o in out]),
                          torch.stack([o[1] for o in out])) for out in outs)
        got, want = session_state_to_numpy(card[0]), \
            session_state_to_numpy(cpu[0])
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        assert torch.equal(card[1].cpu(), cpu[1])
        rejected += int(cpu[1].sum())
        snap = want
    assert rejected > 0
    assert ud_ops.union_deduce.launches > launches


def test_noisy_service_on_card_matches_cpu(dev):
    """The per-round service under noisy crowds (a homogeneous one and the
    heterogeneous worker pool) on the card and on the CPU: every result
    field identical, the wall clock aside."""
    from repro_torch.core.crowd import NoisyCrowd

    sessions = _noisy_sessions(0, 4)
    results = []
    for device in (dev, "cpu"):
        svc = JoinService(lanes=3, fused_rounds=False, device=device)
        rids = [svc.submit(ps, NoisyCrowd(
            error_rate=0.35, qualification=False, seed=10 + k,
            n_workers=25 if k % 2 else None, worker_concentration=3.0))
            for k, ps in enumerate(sessions)]
        res = svc.run()
        results.append([res[r] for r in rids])
    for card, cpu in zip(*results):
        for f in dataclasses.fields(card):
            if f.name != "wall_seconds":
                a, b = getattr(card, f.name), getattr(cpu, f.name)
                assert (np.array_equal(a, b) if isinstance(a, np.ndarray)
                        else a == b), f.name
    assert sum(r.n_conflicts for r in results[0]) > 0


def _assert_fields_equal(card, cpu):
    for f in dataclasses.fields(card):
        if f.name != "wall_seconds":
            a, b = getattr(card, f.name), getattr(cpu, f.name)
            assert (np.array_equal(a, b) if isinstance(a, np.ndarray)
                    else a == b), f.name


@pytest.mark.parametrize("noisy", [False, True])
def test_async_service_on_card_matches_cpu(dev, noisy):
    """Async ID/NF serving on a latency-modelled crowd on the card and on
    the CPU: every result field identical, ``sim_minutes`` as floats, and
    ``union_deduce`` launched on the folds."""
    from repro_torch.core.crowd import LatencyModel, NoisyCrowd

    sessions = _noisy_sessions(3, 3)
    results, launches = [], ud_ops.union_deduce.launches
    for device in (dev, "cpu"):
        svc = JoinService(lanes=2, latency=LatencyModel(n_workers=6,
                                                        seed=7),
                          async_mode=True, nf=True, device=device)
        rids = [svc.submit(ps, NoisyCrowd(error_rate=0.35,
                                          qualification=False, seed=k)
                           if noisy else PerfectCrowd())
                for k, ps in enumerate(sessions)]
        res = svc.run()
        results.append([res[r] for r in rids])
    for card, cpu in zip(*results):
        _assert_fields_equal(card, cpu)
        assert card.sim_minutes > 0
    assert ud_ops.union_deduce.launches > launches


@pytest.mark.parametrize("async_mode", [False, True])
def test_budgeted_requery_service_on_card_matches_cpu(dev, async_mode):
    """Budgets, the slot allocator and requery escalation on the per-round
    path (barrier) and the event loop (async) on the card and on the CPU:
    every result field identical, ``union_deduce`` launched."""
    from repro_torch.core.crowd import LatencyModel, NoisyCrowd

    sessions = _noisy_sessions(3, 3)
    results, launches = [], ud_ops.union_deduce.launches
    for device in (dev, "cpu"):
        svc = JoinService(
            lanes=2, conflict_policy="requery", device=device,
            slots_per_round=None if async_mode else 40,
            latency=LatencyModel(n_workers=6, seed=7) if async_mode else None,
            async_mode=async_mode, nf=async_mode)
        rids = [svc.submit(ps, NoisyCrowd(error_rate=0.4, qualification=False,
                                          seed=k),
                           budget_cents=[120.0, None, 60.0][k],
                           cost_per_assignment=1.3)
                for k, ps in enumerate(sessions)]
        res = svc.run()
        results.append([res[r] for r in rids])
    for card, cpu in zip(*results):
        _assert_fields_equal(card, cpu)
    assert results[0][0].stopped_on_budget
    assert ud_ops.union_deduce.launches > launches


@pytest.mark.parametrize("async_mode", [False, True])
def test_mixed_cluster_service_on_card_matches_cpu(dev, async_mode):
    """EM aggregation and cluster tasks (the worker-quality stage's mixed
    config) on the card and on the CPU: every result field identical."""
    from repro_torch.core.crowd import LatencyModel, NoisyCrowd

    sessions = _noisy_sessions(3, 3)
    results = []
    for device in (dev, "cpu"):
        svc = JoinService(
            lanes=2, aggregation="em", cluster_tasks=True, device=device,
            latency=LatencyModel(n_workers=6, seed=7) if async_mode else None,
            async_mode=async_mode, nf=async_mode)
        rids = [svc.submit(ps, NoisyCrowd(error_rate=0.15, seed=30 + k,
                                          n_workers=25,
                                          worker_concentration=3.0,
                                          qualification=False))
                for k, ps in enumerate(sessions)]
        res = svc.run()
        results.append([res[r] for r in rids])
    for card, cpu in zip(*results):
        _assert_fields_equal(card, cpu)
    assert sum(r.n_cluster_tasks for r in results[0]) > 0


@pytest.mark.parametrize("fused_rounds", [True, False])
def test_service_past_46340_objects_on_card_matches_cpu(dev, fused_rounds):
    """A session over 65536 objects (int64 keys, the wide union_deduce
    kernel) through both service paths on the card and on the CPU: every
    result field identical."""
    rng = np.random.default_rng(5)
    n, p = 60000, 3000
    objs = np.append(rng.choice(n - 1, 399, replace=False), n - 1)
    ent = rng.integers(0, 60, len(objs))
    a = rng.integers(0, len(objs), p)
    b = (a + 1 + rng.integers(0, len(objs) - 1, p)) % len(objs)
    truth = ent[a] == ent[b]
    lik = np.clip(np.where(truth, 0.8, 0.3) + 0.15 * rng.random(p), 0, 1)
    ps = PairSet(objs[a], objs[b], lik, truth, n)
    results, wide = [], ud_ops.union_deduce.wide_launches
    for device in (dev, "cpu"):
        svc = JoinService(lanes=1, fused_rounds=fused_rounds, device=device)
        rid = svc.submit(ps, PerfectCrowd())
        results.append(svc.run()[rid])
    _assert_fields_equal(*results)
    np.testing.assert_array_equal(results[0].labels, truth)
    assert ud_ops.union_deduce.wide_launches > wide


def _pipeline_sessions(seed: int):
    """Seeded entity-clustered sessions of the pipeline tests: their pairs
    in labeling order, noisy answers (each flipped with probability 0.35)
    and the machine priors."""
    from repro_torch.data.entities import make_session_pairsets

    rng = np.random.default_rng(seed)
    out = []
    for ps in make_session_pairsets(3, seed=seed, n_objects=(25, 40),
                                    n_pairs=(120, 300), n_entities=4,
                                    likelihood=(0.7, 0.4, 0.25)):
        truth = np.where(ps.truth, POS, NEG).astype(np.int32)
        flip = rng.random(len(truth)) < 0.35
        out.append((ps, np.where(flip, 1 - truth, truth).astype(np.int32)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pipeline_wrappers_on_card_match_cpu(dev, seed):
    """``connected_components_batch`` and ``boruvka_frontier(_batch)`` from
    partly labeled, partly published sessions: the card's output equals
    the CPU's bit for bit, through the union_deduce kernel."""
    from repro_torch.core import graph

    sessions = _pipeline_sessions(seed)
    U, V, L, valid, n = graph.pack_sessions(
        [(ps.u, ps.v, ps.n_objects) for ps, _ in sessions])
    rng = np.random.default_rng(50 + seed)
    pub = np.zeros_like(valid)
    for b, (ps, ans) in enumerate(sessions):
        m = len(ps)
        lab = rng.random(m) < 0.4
        L[b, :m] = np.where(lab, np.where(ps.truth, POS, NEG), -1)
        pub[b, :m] = ~lab & (rng.random(m) < 0.2)
    launches = ud_ops.union_deduce.launches
    for fn, args in ((graph.connected_components_batch, (U, V, L == POS)),
                     (graph.boruvka_frontier_batch, (U, V, L, pub)),
                     (graph.deduce_sessions, (U, V, L))):
        got = fn(*args, n, device=dev)
        assert got.is_cuda
        assert torch.equal(got.cpu(), fn(*args, n, device="cpu")), \
            fn.__name__
    for b in range(len(sessions)):
        got = graph.boruvka_frontier(U[b], V[b], L[b], pub[b], n, device=dev)
        assert torch.equal(got.cpu(), graph.boruvka_frontier(
            U[b], V[b], L[b], pub[b], n, device="cpu"))
    assert ud_ops.union_deduce.launches > launches


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("prior", [False, True])
def test_label_parallel_torch_on_card_matches_cpu(dev, seed, prior):
    """The whole loop on the card and on the CPU under noisy answers:
    labels, crowdsourced masks, round sizes and conflicts equal; answers
    were rejected and the kernel launched."""
    from repro_torch.core import graph

    launches, conflicts = ud_ops.union_deduce.launches, 0
    for ps, ans in _pipeline_sessions(seed):
        pr = ps.likelihood if prior else None
        out = [graph.label_parallel_torch(ps.u, ps.v, ps.n_objects,
                                          lambda idx: ans[idx], prior=pr,
                                          device=device)
               for device in (dev, "cpu")]
        np.testing.assert_array_equal(out[0][0], out[1][0])
        np.testing.assert_array_equal(out[0][1], out[1][1])
        assert out[0][2:] == out[1][2:]
        conflicts += out[1][3]
    assert conflicts > 0
    assert ud_ops.union_deduce.launches > launches


@pytest.mark.parametrize("seed", [0, 1])
def test_label_parallel_torch_batch_on_card_matches_cpu(dev, seed):
    """Stacked sessions on the card: each equals the CPU's stacked run and
    the card's one-session run."""
    from repro_torch.core import graph

    sessions = _pipeline_sessions(seed)
    lanes = [(ps.u, ps.v, ps.n_objects) for ps, _ in sessions]

    def crowd(b, idx):
        return sessions[b][1][idx]

    card = graph.label_parallel_torch_batch(lanes, crowd, device=dev)
    cpu = graph.label_parallel_torch_batch(lanes, crowd, device="cpu")
    for b, (c, h) in enumerate(zip(card, cpu)):
        np.testing.assert_array_equal(c[0], h[0])
        np.testing.assert_array_equal(c[1], h[1])
        assert c[2:] == h[2:]
        alone = graph.label_parallel_torch(*lanes[b], lambda idx: crowd(b,
                                                                        idx),
                                           device=dev)
        np.testing.assert_array_equal(c[0], alone[0])
        assert c[2:] == tuple(alone[2:])


def test_crowdsourced_join_on_card_matches_cpu(dev):
    """``crowdsourced_join(labeler="torch")`` under a ``NoisyCrowd``: every
    result field but the wall clock equal on the card and the CPU."""
    from repro_torch.core.crowd import NoisyCrowd
    from repro_torch.core.join import crowdsourced_join

    for ps, _ in _pipeline_sessions(3):
        res = [crowdsourced_join(ps, NoisyCrowd(error_rate=0.35, seed=4),
                                 order=order, labeler="torch", device=device)
               for order in ("expected", "adaptive")
               for device in (dev, "cpu")]
        for card, cpu in (res[:2], res[2:]):
            for f in dataclasses.fields(card):
                if f.name != "wall_seconds":
                    a, b = getattr(card, f.name), getattr(cpu, f.name)
                    assert (np.array_equal(a, b) if isinstance(a, np.ndarray)
                            else a == b), f.name


# f32 outputs within an absolute tolerance: sums in another order.  bf16
# outputs within one bf16 ulp of the expected value (8 significant bits: at
# most 2**-7 of it) plus 1e-4: both sides sum in f32 and round once to bf16.
ATTN_TOL_F32 = {"flash": 2e-5, "decode": 1e-5}


def _assert_attn_close(got, exp, which):
    if exp.dtype == torch.bfloat16:
        diff = (got.float() - exp.float()).abs()
        limit = 2.0 ** -7 * exp.float().abs() + 1e-4
        assert bool((diff <= limit).all()), \
            f"max |d| {float(diff.max())}, worst {float((diff / limit).max())}"
    else:
        torch.testing.assert_close(got.float(), exp.float(), rtol=0,
                                   atol=ATTN_TOL_F32[which])


def _randn(dev, shape, dtype, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dev, dtype)


@pytest.mark.parametrize("B,S,H,K,d", [
    (8, 1491, 12, 12, 64),     # paper-scorer's first prefill wave
    (2, 2048, 32, 8, 64),      # granite-3-2b's head layout
    (1, 2048, 64, 8, 128),     # deepseek-67b's head layout
    (1, 2048, 40, 10, 128),    # phi3-medium-14b's head layout
    (3, 200, 6, 2, 32),        # ragged S, the reduced configs' head dim
    (2, 1, 4, 1, 64),          # one token
    (1, 65, 2, 2, 128),        # one row past a 64-row tile
    (32, 32, 12, 12, 64),      # score_pairs_with_lm's record batches
    (25, 32, 12, 12, 64),
    (4, 32, 12, 12, 64),
    # head dims and groups of public models' attention layers
    (1, 2048, 16, 16, 256),    # Gemma-7B
    (1, 2048, 8, 1, 256),      # Gemma-2B
    (1, 2048, 32, 32, 96),     # Phi-3-mini
    (1, 2048, 32, 32, 80),     # phi-2
    (1, 2048, 71, 1, 64),      # falcon-7b
    (1, 2048, 48, 1, 128),     # StarCoder
    # head dims between the compiled widths, ragged S
    (2, 200, 4, 2, 8),
    (2, 333, 4, 2, 40),
    (2, 129, 4, 4, 136),
    (2, 77, 6, 3, 200),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, B, S, H, K, d, dtype):
    q = _randn(dev, (B, S, H, d), dtype, S)
    k = _randn(dev, (B, S, K, d), dtype, S + 1)
    v = _randn(dev, (B, S, K, d), dtype, S + 2)
    launches = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(q, k, v)
    assert fa_ops.flash_attention.launches == launches + 1
    exp = mha_causal_ref(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, S, H, d)
    _assert_attn_close(got, exp, "flash")


def test_flash_attention_kernel_reads_strided_inputs(dev):
    """q, k and v as views of one fused projection, as strides allow."""
    qkv = _randn(dev, (2, 300, 8, 64), torch.float32, 3)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = fa_kernel.flash_attention(q, k, v)
    exp = mha_causal_ref(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, exp, rtol=0, atol=2e-5)


def test_flash_attention_bf16_kernel_reads_strided_inputs(dev):
    """The bf16 route's TMA maps are built from the views' own strides."""
    qkv = _randn(dev, (2, 300, 8, 64), torch.bfloat16, 3)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = fa_kernel.flash_attention(q, k, v)
    exp = mha_causal_ref(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    _assert_attn_close(got, exp, "flash")


def test_flash_attention_bf16_kernel_reads_head_major_views(dev):
    """q, k and v as (B, S, H, d) views of head-major (B, H, S, d) tensors:
    the sequence stride is smaller than the head stride, and the maps take
    the strides as they are."""
    q = _randn(dev, (2, 4, 130, 64), torch.bfloat16, 4).transpose(1, 2)
    k = _randn(dev, (2, 2, 130, 64), torch.bfloat16, 5).transpose(1, 2)
    v = _randn(dev, (2, 2, 130, 64), torch.bfloat16, 6).transpose(1, 2)
    got = fa_kernel.flash_attention(q, k, v)
    exp = mha_causal_ref(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    _assert_attn_close(got, exp, "flash")


@pytest.mark.parametrize("view", ["base", "stride"])
def test_flash_attention_bf16_kernel_refuses_unaligned_views(dev, view):
    """TMA needs 16-byte bases and strides: a view off by one element, or
    with rows of 68 bf16 (136 bytes), is staged into an aligned copy first
    (counted in ``flash_attention.staged``) and matches the plain version,
    where the kernel once refused it."""
    wide = _randn(dev, (1, 200, 2, 68 if view == "stride" else 72),
                  torch.bfloat16, 31)
    x = wide[..., 1:65] if view == "base" else wide[..., :64]
    assert fa_kernel.bf16_staging(x, x, x) is not None
    staged = fa_ops.flash_attention.staged
    got = fa_ops.flash_attention(x, x, x)
    assert fa_ops.flash_attention.staged == staged + 1
    exp = mha_causal_ref(x, x, x)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.shape == x.shape
    _assert_attn_close(got, exp, "flash")


def test_flash_attention_bf16_kernel_runs_on_tensor_cores(dev):
    """The bf16 kernel's SASS, read with the toolkit's cuobjdump, holds
    wgmma (HGMMA) and TMA loads (UTMALDG); the f32 kernel's holds neither."""
    from repro_torch.kernels._build import sass

    bf16 = sass("flash_attention_bf16_kernel")
    f32 = sass("flash_attention_kernel")
    assert bf16.count("HGMMA") > 0 and bf16.count("UTMALDG") > 0
    assert f32 and "HGMMA" not in f32


def _f32_case(dev, B, S, H, K, d, seed):
    return [_randn(dev, (B, S, n, d), torch.float32, seed + i)
            for i, n in enumerate((H, K, K))]


def _f32_boundaries():
    """(d, S): one below, at and one past the f32 plan's kv tile and q
    tile, for each compiled width."""
    out = []
    for d in fa_kernel.WIDTHS:
        p = fa_kernel.f32_plan(1, 1, 1, d)
        for edge in sorted({p.kv_rows, p.q_rows}):
            out += [(d, edge - 1), (d, edge), (d, edge + 1)]
    return out


@pytest.mark.parametrize("d,S", _f32_boundaries())
def test_flash_attention_f32_kernel_at_tile_boundaries(dev, d, S):
    q, k, v = _f32_case(dev, 2, S, 8, 2, d, S)
    got = fa_kernel.flash_attention(q, k, v)
    torch.testing.assert_close(got, mha_causal_ref(q, k, v), rtol=0,
                               atol=ATTN_TOL_F32["flash"])


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_flash_attention_f32_kernel_gqa_groups(dev, groups, d):
    q, k, v = _f32_case(dev, 2, 333, 8, 8 // groups, d, groups + d)
    got = fa_kernel.flash_attention(q, k, v)
    torch.testing.assert_close(got, mha_causal_ref(q, k, v), rtol=0,
                               atol=ATTN_TOL_F32["flash"])


@pytest.mark.parametrize("width", [8 * 64, 8 * 64 + 1],
                         ids=["aligned", "unaligned"])
def test_flash_attention_f32_kernel_reads_fused_projection_views(dev, width):
    """q, k and v as views of one fused projection; rows of 513 floats are
    not a multiple of 16 bytes, so the kernel copies 4 bytes at a time."""
    qkv = _randn(dev, (2, 300, width), torch.float32, width)
    x = qkv[..., :8 * 64].unflatten(-1, (8, 64))
    q, k, v = x[:, :, :4], x[:, :, 4:6], x[:, :, 6:]
    got = fa_kernel.flash_attention(q, k, v)
    exp = mha_causal_ref(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, exp, rtol=0, atol=ATTN_TOL_F32["flash"])


def test_flash_attention_f32_kernel_takes_65536_heads(dev):
    """B * H = 65536, past a grid's y axis: the f32 kernel's blocks lie on
    one axis (and so do the bf16 kernel's).  The plain version agrees on
    slices of heads at both ends."""
    B, S, H, d = 1024, 64, 64, 32
    assert fa_kernel.refusal(torch.bfloat16, B, S, H, H, d) is None
    q, k, v = _f32_case(dev, B, S, H, H, d, 11)
    got = fa_kernel.flash_attention(q, k, v)
    for b, h in ((slice(0, 4), slice(0, 3)), (slice(B - 4, B),
                                              slice(H - 3, H))):
        exp = mha_causal_ref(q[b, :, h], k[b, :, h], v[b, :, h])
        torch.testing.assert_close(got[b, :, h], exp, rtol=0,
                                   atol=ATTN_TOL_F32["flash"])
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("d", [32, 256])
def test_flash_attention_bf16_kernel_takes_65600_heads(dev, d):
    """B * H = 65600 in bf16: the tensor-core kernel's grid is one axis of
    q tiles x B * H blocks, so the heads past 65535 run and agree with the
    plain version at both ends."""
    B, S, H = 1025, 64, 64
    q, k, v = (_randn(dev, (B, S, n, d), torch.bfloat16, 12 + i)
               for i, n in enumerate((H, 8, 8)))
    got = fa_kernel.flash_attention(q, k, v)
    # query heads h0 .. h0 + 15 read kv heads h0 / 8 and h0 / 8 + 1
    for b, h0 in ((slice(0, 2), 0), (slice(B - 2, B), H - 16)):
        h, kv = slice(h0, h0 + 16), slice(h0 // 8, h0 // 8 + 2)
        exp = mha_causal_ref(q[b, :, h], k[b, :, kv], v[b, :, kv])
        torch.cuda.synchronize()
        _assert_attn_close(got[b, :, h], exp, "flash")
    assert bool(torch.isfinite(got.float()).all())


def test_flash_attention_f32_kernel_repeats_bitwise(dev):
    q, k, v = _f32_case(dev, 8, 1491, 12, 12, 64, 5)
    outs = [fa_kernel.flash_attention(q, k, v) for _ in range(5)]
    assert all(torch.equal(o.view(torch.int32), outs[0].view(torch.int32))
               for o in outs[1:])


def test_flash_attention_f32_kernel_runs_exact_fmas_from_async_copies(dev):
    """The f32 kernel's SASS holds FMAs (FFMA) and cp.async copies
    (LDGSTS), and no tensor-core product (HMMA, HGMMA), which would round
    its inputs to TF32."""
    from repro_torch.kernels._build import sass

    f32 = sass("flash_attention_kernel")
    assert f32.count("FFMA") > 0 and f32.count("LDGSTS") > 0
    assert "HMMA" not in f32 and "HGMMA" not in f32


def test_flash_attention_op_counts_the_f32_route(dev):
    q, k, v = _f32_case(dev, 1, 64, 2, 2, 64, 1)
    before = (fa_ops.flash_attention.launches,
              fa_ops.flash_attention.f32_launches)
    fa_ops.flash_attention(q, k, v)
    fa_ops.flash_attention(*(x.bfloat16() for x in (q, k, v)))
    assert (fa_ops.flash_attention.launches - before[0],
            fa_ops.flash_attention.f32_launches - before[1]) == (2, 1)


@pytest.mark.parametrize("B,S,H,K,d,length", [
    (8, 2048, 12, 12, 64, 1),
    (8, 2048, 12, 12, 64, 1337),
    (8, 2048, 12, 12, 64, 2048),
    (2, 300, 32, 2, 128, 299),      # 16 query heads a kv head
    (2, 2048, 32, 2, 128, 1500),    # and the most splits the launch plans
    (3, 77, 8, 2, 32, 77),          # S not a multiple of the 64-row tile
    (8, 2048, 32, 8, 64, 1337),     # granite-3-2b's served layout
    (8, 2048, 40, 10, 128, 2048),   # phi3-medium-14b's served layout
    # head dims and groups of public models' attention layers
    (8, 2048, 16, 16, 256, 1337),   # Gemma-7B
    (8, 2048, 8, 1, 256, 2048),     # Gemma-2B
    (8, 2048, 32, 32, 96, 1337),    # Phi-3-mini
    (8, 2048, 32, 32, 80, 2048),    # phi-2
    (8, 2048, 71, 1, 64, 1337),     # falcon-7b: 71 query heads a kv head
    (8, 2048, 48, 1, 128, 2048),    # StarCoder
    # head dims between the compiled widths, G = 71 at each
    (2, 300, 71, 1, 8, 299),
    (2, 300, 71, 1, 40, 250),
    (2, 300, 71, 1, 136, 300),
    (2, 300, 71, 1, 200, 123),
])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.bfloat16)],
                         ids=["f32", "bf16", "f32-over-bf16"])
def test_decode_attention_kernel_matches_plain(dev, B, S, H, K, d, length,
                                               dtypes):
    q_dt, kv_dt = dtypes
    q = _randn(dev, (B, H, d), q_dt, length)
    kc = _randn(dev, (B, S, K, d), kv_dt, length + 1)
    vc = _randn(dev, (B, S, K, d), kv_dt, length + 2)
    kc[:, length:] = 1e4      # past length: must not reach any sum
    vc[:, length:] = -1e4
    n = torch.tensor(length, dtype=torch.int32, device=dev)
    launches = da_ops.decode_attention.launches
    got = da_ops.decode_attention(q, kc, vc, n)
    assert da_ops.decode_attention.launches == launches + 1
    exp = decode_attention_ref(q, kc, vc, length)
    torch.cuda.synchronize()
    assert got.dtype == q_dt and got.shape == (B, H, d)
    _assert_attn_close(got, exp, "decode")


def _decode_args(dev, B, S, H, K, d, length, dtype, seed):
    q = _randn(dev, (B, H, d), dtype, seed)
    kc = _randn(dev, (B, S, K, d), dtype, seed + 1)
    vc = _randn(dev, (B, S, K, d), dtype, seed + 2)
    kc[:, length:] = 1e4
    vc[:, length:] = -1e4
    return q, kc, vc, torch.tensor(length, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("where", ["1", "below", "at", "above", "S"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_at_split_boundaries(dev, where, dtype):
    """paper-scorer's serving shape, at length 1, one below, at and one past
    the first split boundary (as the launch plans it on this card), and S:
    a split that holds no position must not reach the merge."""
    B, S, H, K, d = 8, 2048, 12, 12, 64
    q, kc, vc, _ = _decode_args(dev, B, S, H, K, d, 1, dtype, 0)
    splits, chunk = da_kernel.split_plan(q, kc)
    assert splits > 1 and splits * chunk >= S
    length = {"1": 1, "below": chunk - 1, "at": chunk, "above": chunk + 1,
              "S": S}[where]
    q, kc, vc, n = _decode_args(dev, B, S, H, K, d, length, dtype, length)
    got = da_kernel.decode_attention(q, kc, vc, n)
    exp = decode_attention_ref(q, kc, vc, length)
    torch.cuda.synchronize()
    _assert_attn_close(got, exp, "decode")


def test_decode_attention_kernel_repeats_bitwise(dev):
    """The splits merge in split order, so five calls agree bit for bit
    whichever block of a (lane, kv head) finishes last."""
    args = _decode_args(dev, 8, 2048, 12, 12, 64, 1337, torch.bfloat16, 5)
    outs = [da_kernel.decode_attention(*args) for _ in range(5)]
    for out in outs[1:]:
        assert torch.equal(out.view(torch.int16), outs[0].view(torch.int16))


def test_decode_attention_kernel_counters_reset_between_shapes(dev):
    """Two calls of different B * K back to back, then one like the first:
    each call's last blocks leave their counters at 0, so the third call
    merges every split again and equals the first bit for bit."""
    first = _decode_args(dev, 8, 2048, 12, 12, 64, 2000, torch.bfloat16, 1)
    other = _decode_args(dev, 3, 700, 8, 2, 32, 650, torch.float32, 2)
    o1 = da_kernel.decode_attention(*first)
    o2 = da_kernel.decode_attention(*other)
    o3 = da_kernel.decode_attention(*first)
    torch.cuda.synchronize()
    _assert_attn_close(o1, decode_attention_ref(*first[:3], 2000), "decode")
    _assert_attn_close(o2, decode_attention_ref(*other[:3], 650), "decode")
    assert torch.equal(o1.view(torch.int16), o3.view(torch.int16))
    assert not da_kernel._COUNTERS[o1.device].any()


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_reads_strided_caches(dev, offset, dtype):
    """Caches as views of a wider tensor: at an aligned offset the rows load
    16 bytes at a time, one element in they load element by element."""
    B, S, H, K, d, length = 3, 500, 8, 2, 64, 437
    wide = _randn(dev, (B, S, K, 2, d + 8), dtype, 21)
    wide[:, length:] = 1e4
    kc = wide[:, :, :, 0, offset:offset + d]
    vc = wide[:, :, :, 1, offset:offset + d]
    q = _randn(dev, (B, H, d), dtype, 22)
    n = torch.tensor(length, dtype=torch.int32, device=dev)
    got = da_kernel.decode_attention(q, kc, vc, n)
    exp = decode_attention_ref(q, kc.contiguous(), vc.contiguous(), length)
    torch.cuda.synchronize()
    _assert_attn_close(got, exp, "decode")


@pytest.mark.parametrize("d", [44, 264])
def test_decode_attention_kernel_refuses_what_it_does_not_take(dev, d):
    """A head dim that is not a multiple of 8, or past 256, runs as the
    Pallas kernel's does (it once raised here) and matches the plain
    version; a dtype pair the kernel is not built for still raises."""
    q = _randn(dev, (1, 4, d), torch.float32, d)
    kc = _randn(dev, (1, 8, 2, d), torch.float32, d + 1)
    vc = _randn(dev, (1, 8, 2, d), torch.float32, d + 2)
    n = torch.tensor(3, dtype=torch.int32, device=dev)
    got = da_kernel.decode_attention(q, kc, vc, n)
    exp = decode_attention_ref(q, kc, vc, 3)
    torch.cuda.synchronize()
    _assert_attn_close(got, exp, "decode")
    with pytest.raises(ValueError, match="dtypes"):
        da_kernel.decode_attention(q.bfloat16(), kc, kc, n)
    with pytest.raises(ValueError, match="head dim 0"):
        da_kernel.decode_attention(q[..., :0], kc[..., :0], kc[..., :0], n)


def _int8_cache(dev, B, S, K, d, length, seed, unit_scales=False):
    """An int8 cache and its bf16 scales: ``quantize_kv`` of seeded bf16
    rows, or small integers under scales of 1; garbage past ``length``."""
    if unit_scales:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        vals = torch.randint(-4, 5, (B, S, K, d), generator=gen,
                             dtype=torch.int8).to(dev)
        scales = torch.ones((B, S, K), dtype=torch.bfloat16, device=dev)
    else:
        vals, scales = quantize_kv(_randn(dev, (B, S, K, d), torch.bfloat16,
                                          seed))
    vals[:, length:] = 127
    scales[:, length:] = 1e4
    return vals, scales


@pytest.mark.parametrize("B,S,H,K,d,length", [
    (8, 2048, 12, 12, 64, 1),
    (8, 2048, 12, 12, 64, 1337),       # paper-scorer's serving shape
    (8, 2048, 12, 12, 64, 2048),
    (8, 2048, 16, 8, 128, 1500),       # internlm2-1.8b's heads
    (2, 300, 32, 2, 128, 299),         # 16 query heads a kv head
    (3, 77, 8, 2, 32, 77),
    (8, 2048, 16, 16, 256, 1337),      # Gemma-7B
    (8, 2048, 8, 1, 256, 2048),        # Gemma-2B
    (8, 2048, 32, 32, 96, 1337),       # Phi-3-mini
    (8, 2048, 32, 32, 80, 2048),       # phi-2
    (8, 2048, 71, 1, 64, 1337),        # falcon-7b
    (8, 2048, 48, 1, 128, 2048),       # StarCoder
    (2, 300, 71, 1, 40, 250),          # a lane half past d (d % 16 == 8)
    (2, 300, 71, 1, 200, 123),
])
@pytest.mark.parametrize("q_dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_attention_int8_cache_matches_plain(dev, B, S, H, K, d,
                                                   length, q_dt):
    """The kernel dequantizes as the plain version does (bit for bit: an
    int8 times a bf16 scale is exact in f32, rounded once to bf16), so the
    two differ by the attention's summation order alone."""
    q = _randn(dev, (B, H, d), q_dt, length)
    kc, ks = _int8_cache(dev, B, S, K, d, length, length + 1)
    vc, vs = _int8_cache(dev, B, S, K, d, length, length + 2)
    n = torch.tensor(length, dtype=torch.int32, device=dev)
    before = (da_ops.decode_attention.launches,
              da_ops.decode_attention.int8_launches)
    got = da_ops.decode_attention(q, kc, vc, n, ks, vs)
    assert (da_ops.decode_attention.launches,
            da_ops.decode_attention.int8_launches) == (before[0],
                                                        before[1] + 1)
    exp = decode_attention_ref(q, kc, vc, length, ks, vs)
    torch.cuda.synchronize()
    assert got.dtype == q_dt and got.shape == (B, H, d)
    _assert_attn_close(got, exp, "decode")


# head dims the Pallas kernels take and the card kernels once refused: not
# a multiple of 8, past 256, past two chunks of 256
NEW_HEAD_DIMS = (1, 3, 12, 100, 264, 320, 512, 1000)


@pytest.mark.parametrize("d", NEW_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_takes_every_head_dim(dev, d, dtype):
    """GQA 2:1 at a ragged S past two kv tiles; bf16 at a d that is not a
    multiple of 8 is staged (counted), at one that is it is not."""
    B, S, H, K = 2, 131, 4, 2
    q = _randn(dev, (B, S, H, d), dtype, d)
    k = _randn(dev, (B, S, K, d), dtype, d + 1)
    v = _randn(dev, (B, S, K, d), dtype, d + 2)
    launches, staged = (fa_ops.flash_attention.launches,
                        fa_ops.flash_attention.staged)
    got = fa_ops.flash_attention(q, k, v)
    assert fa_ops.flash_attention.launches == launches + 1
    assert fa_ops.flash_attention.staged == staged + (
        dtype == torch.bfloat16 and d % 8 != 0)
    exp = mha_causal_ref(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, S, H, d)
    assert got.is_contiguous()
    _assert_attn_close(got, exp, "flash")


@pytest.mark.parametrize("d", NEW_HEAD_DIMS)
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_decode_attention_kernel_takes_every_head_dim(dev, d, kv):
    """Cache rows of any head dim, their last at the allocation's end: the
    cache is a view whose last row ends the storage, so a load past the
    row's d elements would leave it (a fault under the caching allocator's
    block end only by luck; the values past length are 1e4 garbage)."""
    B, S, H, K, length = 2, 300, 8, 2, 300
    q_dt = torch.bfloat16 if kv == "bf16" else torch.float32
    q = _randn(dev, (B, H, d), q_dt, d)
    n = torch.tensor(length, dtype=torch.int32, device=dev)
    if kv == "int8":
        kc, ks = _int8_cache(dev, B, S, K, d, length, d + 1)
        vc, vs = _int8_cache(dev, B, S, K, d, length, d + 2)
        got = da_ops.decode_attention(q, kc, vc, n, ks, vs)
        exp = decode_attention_ref(q, kc, vc, length, ks, vs)
    else:
        dt = torch.bfloat16 if kv == "bf16" else torch.float32
        kc = _randn(dev, (B, S, K, d), dt, d + 1)
        vc = _randn(dev, (B, S, K, d), dt, d + 2)
        got = da_ops.decode_attention(q, kc, vc, n)
        exp = decode_attention_ref(q, kc, vc, length)
    torch.cuda.synchronize()
    assert got.dtype == q_dt and got.shape == (B, H, d)
    _assert_attn_close(got, exp, "decode")


@pytest.mark.parametrize("d", [12, 100, 264])
@pytest.mark.parametrize("kv", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_last_row_at_a_partial_vector(dev, d, kv):
    """A cache cut from the front of its storage so that its last row's
    partial vector ends exactly where the allocation does: the kernel
    reads that row's d elements and nothing past them."""
    B, S, K, H = 1, 64, 1, 4
    n_el = B * S * K * d
    store = _randn(dev, (n_el + 1,), kv, d)
    kc = store[1:].view(B, S, K, d)       # ends at the storage's end
    vc = _randn(dev, (B, S, K, d), kv, d + 1)
    q = _randn(dev, (B, H, d), torch.float32, d + 2)
    n = torch.tensor(S, dtype=torch.int32, device=dev)
    got = da_ops.decode_attention(q, kc, vc, n)
    exp = decode_attention_ref(q, kc, vc, S)
    torch.cuda.synchronize()
    _assert_attn_close(got, exp, "decode")


@pytest.mark.parametrize("d", [32, 40, 64, 96, 128, 256])
def test_decode_attention_int8_unit_scales_within_f32(dev, d):
    """Under scales of 1 the dequantized cache is the int8 values
    themselves, which the f32 path reads exactly: the int8 path must agree
    with the plain version within the f32 rule."""
    B, S, H, K, length = 4, 700, 8, 2, 650
    q = _randn(dev, (B, H, d), torch.float32, d)
    kc, ks = _int8_cache(dev, B, S, K, d, length, d + 1, unit_scales=True)
    vc, vs = _int8_cache(dev, B, S, K, d, length, d + 2, unit_scales=True)
    n = torch.tensor(length, dtype=torch.int32, device=dev)
    got = da_kernel.decode_attention(q, kc, vc, n, ks, vs)
    exp = decode_attention_ref(q, kc.float(), vc.float(), length)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, exp, rtol=0, atol=ATTN_TOL_F32["decode"])


# the kernels past head dim 256: f32 flash's cluster kernel (its slab loop
# past 8 slabs of 256, d = 2049) and decode's wide kernel (its chunked
# kernel past 4 vectors of 256, d = 1025)
WIDE_FLASH_DIMS = tuple(d for d in NEW_HEAD_DIMS if d > 256) + (2048, 2049)
WIDE_DECODE_DIMS = tuple(d for d in NEW_HEAD_DIMS if d > 256) + (1024, 1025,
                                                                  2048)


def _no_plain(monkeypatch):
    """Make the ops' plain versions raise, so a call that fell back to one
    on a CUDA tensor fails."""
    def refuse(*args, **kw):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(fa_ops, "mha_causal_ref", refuse)
    monkeypatch.setattr(da_ops, "decode_attention_ref", refuse)


@pytest.mark.parametrize("d", WIDE_FLASH_DIMS)
@pytest.mark.parametrize("groups", [1, 4, 8])
def test_f32_flash_wide_head_dim_matches_plain(dev, d, groups, monkeypatch):
    """f32 flash past 256 at S = 131 (past two q tiles of 64 or one of
    128, a multiple of neither), 8 query heads over 8 / groups kv heads,
    through the op: the cluster kernel (``wide_launches``) up to 8 slabs
    of 256, the slab loop past them; no plain version on the card."""
    B, S, H = 2, 131, 8
    K = H // groups
    q = _randn(dev, (B, S, H, d), torch.float32, d)
    k = _randn(dev, (B, S, K, d), torch.float32, d + 1)
    v = _randn(dev, (B, S, K, d), torch.float32, d + 2)
    plan = fa_kernel.f32_plan(B, S, H, d)
    assert plan.cluster == (plan.chunks if d <= 2048 else 1)
    _no_plain(monkeypatch)
    before = (fa_ops.flash_attention.launches,
              fa_ops.flash_attention.wide_launches)
    got = fa_ops.flash_attention(q, k, v)
    assert (fa_ops.flash_attention.launches,
            fa_ops.flash_attention.wide_launches) == (
        before[0] + 1, before[1] + (plan.cluster > 1))
    exp = mha_causal_ref(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (B, S, H, d) and got.dtype == torch.float32
    _assert_attn_close(got, exp, "flash")


@pytest.mark.parametrize("d", [264, 320, 512])
def test_f32_flash_wide_head_dim_reads_misaligned_views(dev, d):
    """q, k and v as views one float into rows of d + 4: no 16-byte copy
    fits, every slab's copies take 4 bytes each."""
    B, S, H, K = 2, 131, 4, 2
    q = _randn(dev, (B, S, H, d + 4), torch.float32, d)[..., 1:1 + d]
    k = _randn(dev, (B, S, K, d + 4), torch.float32, d + 1)[..., 1:1 + d]
    v = _randn(dev, (B, S, K, d + 4), torch.float32, d + 2)[..., 1:1 + d]
    got = fa_kernel.flash_attention(q, k, v)
    exp = mha_causal_ref(q, k, v)
    torch.cuda.synchronize()
    _assert_attn_close(got, exp, "flash")


@pytest.mark.parametrize("d", [320, 512, 1000])
def test_f32_flash_wide_head_dim_repeats_bitwise(dev, d):
    """Every block of a cluster adds the slabs' partial scores in slab
    order, so two calls give the same bits."""
    B, S, H, K = 2, 200, 4, 2
    q = _randn(dev, (B, S, H, d), torch.float32, 7)
    k = _randn(dev, (B, S, K, d), torch.float32, 8)
    v = _randn(dev, (B, S, K, d), torch.float32, 9)
    a = fa_kernel.flash_attention(q, k, v)
    b = fa_kernel.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("d", WIDE_DECODE_DIMS)
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("groups", [1, 4, 8])
def test_decode_wide_head_dim_matches_plain(dev, d, kv, groups,
                                            monkeypatch):
    """Decode past 256 at length 217 of 300 cached positions (garbage past
    it), 8 query heads over 8 / groups kv heads, through the op: the wide
    kernel (``wide_launches``) up to 4 vectors of 256 a lane, the chunked
    kernel past them; no plain version on the card."""
    B, S, H, length = 2, 300, 8, 217
    K = H // groups
    q_dt = torch.bfloat16 if kv == "bf16" else torch.float32
    q = _randn(dev, (B, H, d), q_dt, d)
    n = torch.tensor(length, dtype=torch.int32, device=dev)
    if kv == "int8":
        kc, ks = _int8_cache(dev, B, S, K, d, length, d + 1)
        vc, vs = _int8_cache(dev, B, S, K, d, length, d + 2)
        scales = (ks, vs)
    else:
        dt = torch.bfloat16 if kv == "bf16" else torch.float32
        kc = _randn(dev, (B, S, K, d), dt, d + 1)
        vc = _randn(dev, (B, S, K, d), dt, d + 2)
        kc[:, length:] = 1e4
        vc[:, length:] = -1e4
        scales = ()
    wide = da_kernel.lane_layout(kc.dtype, d)["vectors"] > 1
    _no_plain(monkeypatch)
    before = (da_ops.decode_attention.launches,
              da_ops.decode_attention.int8_launches,
              da_ops.decode_attention.wide_launches)
    got = da_ops.decode_attention(q, kc, vc, n, *scales)
    assert (da_ops.decode_attention.launches,
            da_ops.decode_attention.int8_launches,
            da_ops.decode_attention.wide_launches) == (
        before[0] + (kv != "int8"), before[1] + (kv == "int8"),
        before[2] + wide)
    exp = decode_attention_ref(q, kc, vc, length, *scales)
    torch.cuda.synchronize()
    assert got.dtype == q_dt and got.shape == (B, H, d)
    _assert_attn_close(got, exp, "decode")


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("d", [264, 320])
def test_decode_wide_head_dim_reads_misaligned_views(dev, kv, d):
    """Caches (and int8 scales) as views 3 elements into wider rows: no
    16-byte copy fits, a thread loads its vectors element by element into
    its ring slots."""
    B, S, K, H, length = 2, 300, 2, 8, 217
    if kv == "int8":
        vals, sc = _int8_cache(dev, B, S, 2 * K, d + 8, length, 31)
        kc = vals.view(B, S, K, 2, d + 8)[:, :, :, 0, 3:3 + d]
        vc = vals.view(B, S, K, 2, d + 8)[:, :, :, 1, 3:3 + d]
        scales = (sc.view(B, S, K, 2)[..., 0], sc.view(B, S, K, 2)[..., 1])
        exp_args = (kc.contiguous(), vc.contiguous(), length,
                    *(x.contiguous() for x in scales))
    else:
        dt = torch.bfloat16 if kv == "bf16" else torch.float32
        rows = _randn(dev, (B, S, K, 2, d + 8), dt, 31)
        kc, vc = rows[:, :, :, 0, 3:3 + d], rows[:, :, :, 1, 3:3 + d]
        scales = ()
        exp_args = (kc, vc, length)
    q = _randn(dev, (B, H, d), torch.float32, 32)
    n = torch.tensor(length, dtype=torch.int32, device=dev)
    got = da_kernel.decode_attention(q, kc, vc, n, *scales)
    exp = decode_attention_ref(q, *exp_args)
    torch.cuda.synchronize()
    _assert_attn_close(got, exp, "decode")


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_decode_wide_head_dim_repeats_bitwise(dev, kv):
    """The splits merge in split order, so two calls at a shape of many
    splits (8 lanes over 2048 of 2 kv heads, d = 320) give the same bits."""
    B, S, H, K, d, length = 8, 2048, 8, 2, 320, 1999
    q = _randn(dev, (B, H, d), torch.bfloat16, 3)
    n = torch.tensor(length, dtype=torch.int32, device=dev)
    if kv == "int8":
        kc, ks = _int8_cache(dev, B, S, K, d, length, 4)
        vc, vs = _int8_cache(dev, B, S, K, d, length, 5)
        args = (q, kc, vc, n, ks, vs)
    else:
        dt = torch.bfloat16 if kv == "bf16" else torch.float32
        args = (q.to(dt), _randn(dev, (B, S, K, d), dt, 4),
                _randn(dev, (B, S, K, d), dt, 5), n)
    splits, _ = da_kernel.split_plan(args[0], args[1])
    assert splits > 1
    a = da_kernel.decode_attention(*args)
    b = da_kernel.decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(a.float(), b.float())


@pytest.mark.parametrize("offset", [0, 3], ids=["aligned", "unaligned"])
def test_decode_attention_int8_reads_strided_caches(dev, offset):
    """Caches and scales as views of wider tensors: at an aligned offset
    the int8 rows load 8 bytes a lane, three elements in byte by byte."""
    B, S, H, K, d, length = 3, 500, 8, 2, 64, 437
    vals, scales = _int8_cache(dev, B, S, K * 2, d + 8, length, 31)
    kc = vals.view(B, S, K, 2, d + 8)[:, :, :, 0, offset:offset + d]
    vc = vals.view(B, S, K, 2, d + 8)[:, :, :, 1, offset:offset + d]
    ks = scales.view(B, S, K, 2)[..., 0]
    vs = scales.view(B, S, K, 2)[..., 1]
    q = _randn(dev, (B, H, d), torch.bfloat16, 32)
    n = torch.tensor(length, dtype=torch.int32, device=dev)
    got = da_kernel.decode_attention(q, kc, vc, n, ks, vs)
    exp = decode_attention_ref(q, kc.contiguous(), vc.contiguous(), length,
                               ks.contiguous(), vs.contiguous())
    torch.cuda.synchronize()
    _assert_attn_close(got, exp, "decode")


def test_decode_attention_int8_repeats_bitwise(dev):
    B, S, H, K, d, length = 8, 2048, 12, 12, 64, 1337
    q = _randn(dev, (B, H, d), torch.bfloat16, 41)
    kc, ks = _int8_cache(dev, B, S, K, d, length, 42)
    vc, vs = _int8_cache(dev, B, S, K, d, length, 43)
    n = torch.tensor(length, dtype=torch.int32, device=dev)
    outs = [da_kernel.decode_attention(q, kc, vc, n, ks, vs)
            for _ in range(5)]
    for out in outs[1:]:
        assert torch.equal(out.view(torch.int16), outs[0].view(torch.int16))


def test_decode_attention_int8_refuses_without_its_scales(dev):
    q = torch.zeros(1, 4, 64, device=dev)
    kc = torch.zeros(1, 8, 2, 64, dtype=torch.int8, device=dev)
    sc = torch.ones(1, 8, 2, dtype=torch.bfloat16, device=dev)
    n = torch.tensor(3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="scales"):
        da_kernel.decode_attention(q, kc, kc, n)
    with pytest.raises(ValueError, match="scales"):
        da_kernel.decode_attention(q, kc.bfloat16(), kc.bfloat16(), n, sc, sc)
    with pytest.raises(ValueError, match="scales"):
        da_kernel.decode_attention(q, kc, kc, n, sc.float(), sc.float())


@pytest.mark.parametrize("d", [32, 40, 64, 96, 128, 256])
@pytest.mark.parametrize("H,K", [(8, 8), (8, 4), (71, 1)],
                         ids=["G1", "G2", "G71"])
def test_decode_attention_int8_at_length_1_is_the_dequantized_row(dev, H, K,
                                                                   d):
    """At length 1 the softmax weighs one row by exactly 1, so under an f32
    query the output is the dequantized v row itself: bit for bit
    ``dequantize``'s, with rows that hold every int8 value in [-127, 127]
    under B x K distinct scales (2**-20 to 2**20)."""
    B, S = 4, 256
    gen = torch.Generator(device="cpu").manual_seed(d + H + K)
    vals = torch.randint(-127, 128, (B, S, K, d), generator=gen,
                         dtype=torch.int8)
    every = torch.arange(-127, 128, dtype=torch.int8)
    row0 = every.repeat(-(-B * K * d // 255))[:B * K * d]
    vals[:, 0] = row0.view(B, K, d)
    exps = torch.randperm(41, generator=gen)[:B * K].view(B, K) - 20
    scales = torch.rand((B, S, K), generator=gen).to(torch.bfloat16)
    scales[:, 0] = (2.0 ** exps.double() * 1.5).to(torch.bfloat16)
    assert scales[:, 0].unique().numel() == B * K
    kvals = torch.randint(-127, 128, (B, S, K, d), generator=gen,
                          dtype=torch.int8)
    q = torch.randn((B, H, d), generator=gen)
    kc, vc, ks, vs = (x.to(dev) for x in (kvals, vals, scales, scales))
    got = da_kernel.decode_attention(
        q.to(dev), kc, vc, torch.tensor(1, dtype=torch.int32, device=dev),
        ks, vs)
    want = dequantize(vals[:, :1], scales[:, :1])[:, 0].float()
    want = want.repeat_interleave(H // K, dim=1)      # (B, H, d)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_decode_attention_int8_refuses_rather_than_the_plain_version(dev):
    """An int8 cache the kernel does not take raises a ValueError through
    the public wrapper (scales on the CPU beside CUDA caches), counting no
    launch and never running the plain version.  A head dim of 44, which
    it once refused too, now launches the kernel (counted once) and
    matches the plain version."""
    q = _randn(dev, (1, 4, 64), torch.float32, 44)
    kc, sc = _int8_cache(dev, 1, 8, 2, 64, 3, 45)
    n = torch.tensor(3, dtype=torch.int32, device=dev)
    before = (da_ops.decode_attention.launches,
              da_ops.decode_attention.int8_launches)
    with pytest.raises(ValueError, match="CUDA"):
        da_ops.decode_attention(q, kc, kc, n, sc.cpu(), sc.cpu())
    assert (da_ops.decode_attention.launches,
            da_ops.decode_attention.int8_launches) == before
    q, kc = q[..., :44], kc[..., :44]
    got = da_ops.decode_attention(q, kc, kc, n, sc, sc)
    assert (da_ops.decode_attention.launches,
            da_ops.decode_attention.int8_launches) == (before[0],
                                                        before[1] + 1)
    exp = decode_attention_ref(q, kc, kc, 3, sc, sc)
    torch.cuda.synchronize()
    _assert_attn_close(got, exp, "decode")


def test_kv_quant_decode_runs_the_int8_kernel(dev):
    """A model under ``kv_quant`` decodes through the int8 kernel, once a
    layer a step, and its tokens on the card equal the CPU's under f32
    weights, as the bf16 cache's do (``test_lm_engine_on_card_matches_cpu``)."""
    cfg = get("internlm2-1.8b").reduced().replace(kv_quant=True)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(
                2, cfg.vocab, size=int(rng.integers(4, 40))).astype(np.int32),
                max_new_tokens=6) for i in range(2)]
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu").float()
    card = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(
        device=dev, dtype=torch.float32)
    before = da_ops.decode_attention.int8_launches
    out = [ServeEngine(cfg, m, batch_lanes=2, max_len=64).generate(reqs)
           for m in (card, model)]
    assert da_ops.decode_attention.int8_launches - before \
        == cfg.n_layers * 5
    assert out[0] == out[1]


def test_lm_engine_on_card_matches_cpu(dev):
    cfg = get("paper-scorer").reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu").float()
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
                2, cfg.vocab, size=int(rng.integers(4, 40))).astype(np.int32),
                max_new_tokens=8) for i in range(5)]
    card = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(
        device=dev, dtype=torch.float32)
    out = [ServeEngine(cfg, m, batch_lanes=2, max_len=64).generate(reqs)
           for m in (card, model)]
    assert out[0] == out[1]


def test_hybrid_prefill_and_decode_run_the_kernels(dev, monkeypatch):
    """Reduced ``zamba2-1.2b`` under f32 weights and f32 caches (so that no
    state rounds to bf16 on one side and not the other): the card's
    prefill and decode steps (the shared block through the flash kernel
    once an invocation, through the decode kernel once an invocation a
    step) against the same model's plain path on the CPU, logits and every
    state within 1e-4 of their scale (f32 sums in another order), and the
    engine's greedy tokens equal."""
    from repro_torch.models import model as M

    cfg = get("zamba2-1.2b").reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu").float()
    card = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(
        device=dev, dtype=torch.float32)
    make_cache = M.make_cache
    monkeypatch.setattr(M, "make_cache", lambda *a, **k: {
        n: t if n == "length" else t.float()
        for n, t in make_cache(*a, **k).items()})

    toks = torch.from_numpy(np.random.default_rng(6).integers(
        2, cfg.vocab, size=(2, 45)).astype(np.int32))
    n_inv = cfg.n_shared_attn
    outs = []
    for m in (card, model):
        before = (fa_ops.flash_attention.launches,
                  da_ops.decode_attention.launches)
        cache, logits = M.prefill(m, {"tokens": toks[:, :41].to(m.device)},
                                  64)
        steps = [logits]
        for i in range(41, 45):
            logits, cache = M.decode_step(
                m, cache, {"tokens": toks[:, i:i + 1].to(m.device)})
            steps.append(logits)
        launched = (fa_ops.flash_attention.launches - before[0],
                    da_ops.decode_attention.launches - before[1])
        outs.append(([t.cpu() for t in steps],
                     {n: t.cpu() for n, t in cache.items()}, launched))
    assert outs[0][2] == (n_inv, 4 * n_inv)
    assert outs[1][2] == (0, 0)
    for i, (got, ref) in enumerate(zip(outs[0][0], outs[1][0])):
        scale = max(float(ref.abs().max()), 1.0)
        err = float((got - ref).abs().max())
        assert err <= 1e-4 * scale, (i, err, scale)
    for name, ref in outs[1][1].items():
        got = outs[0][1][name]
        scale = max(float(ref.abs().max()), 1.0)
        err = float((got - ref).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(
                2, cfg.vocab, size=int(rng.integers(4, 40))).astype(np.int32),
                max_new_tokens=6) for i in range(3)]
    got = [ServeEngine(cfg, m, batch_lanes=2, max_len=64).generate(reqs)
           for m in (card, model)]
    assert got[0] == got[1]


def test_rwkv_engine_on_card_matches_cpu(dev):
    """Reduced ``rwkv6-3b`` under f32 weights: the same greedy tokens on the
    card as on the CPU, and no attention kernel launched."""
    cfg = get("rwkv6-3b").reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu").float()
    card = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(
        device=dev, dtype=torch.float32)
    rng = np.random.default_rng(8)
    reqs = [Request(rid=i, prompt=rng.integers(
                2, cfg.vocab, size=int(rng.integers(4, 40))).astype(np.int32),
                max_new_tokens=6) for i in range(3)]
    before = (fa_ops.flash_attention.launches,
              da_ops.decode_attention.launches)
    out = [ServeEngine(cfg, m, batch_lanes=2, max_len=64).generate(reqs)
           for m in (card, model)]
    assert (fa_ops.flash_attention.launches,
            da_ops.decode_attention.launches) == before
    assert out[0] == out[1]


def _stream_corpus(seed: int, n: int, d: int, n_ent: int):
    """Entity-clustered (n, d) tables a side, as numpy f32."""
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(n_ent, d))
    ia = rng.integers(0, n_ent, n)
    ib = rng.integers(0, n_ent, n)
    a = (cents[ia] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)
    b = (cents[ib] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)
    return ia, a, ib, b


def _bitwise_candidates(cand) -> dict:
    return {(int(r), int(c)): int(s) for r, c, s in
            zip(cand.rows, cand.cols, cand.scores.view(np.int32))}


@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_streaming_index_union_equals_batch_bitwise(dev, blocked):
    """On the card a cell's score depends only on its two rows (the
    mainloop sums each cell with fmaf in k order from 0; padding rows do
    not enter the sum), so the union of the index's epochs equals one batch
    call over the final corpora bit for bit: the same set, the same f32
    scores.  The corpus stays on the card."""
    from repro_torch.kernels.pair_scores.sharded import \
        StreamingCandidateIndex

    _, a, _, b = _stream_corpus(11, 1536, 384, 200)
    cfg = (blocking.BlockingConfig(n_bits=5, n_tables=6, bn=128, bm=128,
                                   tiles_per_call=64) if blocked else None)
    idx = StreamingCandidateIndex(0.7, blocking=cfg, device=dev)
    cuts = ((0, 700, 0, 500), (700, 1100, 500, 500), (1100, 1100, 500, 1200),
            (1100, 1536, 1200, 1536))
    counter = ps_ops.pair_scores_compact if blocked else ps_ops.pair_scores
    launches = counter.launches
    got = {}
    for a0, a1, b0, b1 in cuts:
        cand = idx.append(
            torch.from_numpy(a[a0:a1]).to(dev) if a1 > a0 else None,
            torch.from_numpy(b[b0:b1]).to(dev) if b1 > b0 else None)
        fresh = _bitwise_candidates(cand)
        assert not set(fresh) & set(got)
        got.update(fresh)
        assert idx._a.device.type == "cuda"
    assert counter.launches > launches
    fa, fb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    full = (blocking.blocked_candidates(fa, fb, 0.7, cfg) if blocked
            else sharded_candidates(fa, fb, 0.7))
    want = _bitwise_candidates(full)
    assert len(want) > 1000 and got == want
    assert idx.pairs_scored < idx.full_rescore_pairs
    if not blocked:
        assert idx.pairs_scored == 1536 * 1536


def test_grown_lane_first_fold_takes_the_wide_kernel(dev):
    """A lane opened at 40000 objects (int32 keys, the clustered kernel)
    grows to 65536 (int64 keys): its next fold launches the wide
    ``union_deduce`` kernel, and the state equals the CPU's bit for bit."""
    from repro_torch.convert import session_state_to_numpy
    from repro_torch.core import graph

    rng = np.random.default_rng(3)
    n0, n1, P = 40000, 65536, 512
    objs = np.sort(rng.choice(n0, 150, replace=False))
    cluster = rng.integers(0, 30, 150)
    x = rng.integers(0, 150, 400)
    y = (x + 1 + rng.integers(0, 149, 400)) % 150
    u, v = objs[x].astype(np.int32), objs[y].astype(np.int32)
    truth = np.where(cluster[x] == cluster[y], POS, NEG).astype(np.int32)
    hi = rng.choice(np.arange(n0, n1), 100, replace=False).astype(np.int32)
    au = np.zeros(2 * P, np.int32)
    av = np.zeros(2 * P, np.int32)
    am = np.zeros(2 * P, bool)
    au[400:500], av[400:500], am[400:500] = u[:100], hi, True
    upd = np.full(P, 3, np.int32)
    upd[:200] = truth[:200]
    upd2 = np.full(2 * P, 3, np.int32)
    upd2[200:400] = truth[200:]
    upd2[400:500] = NEG
    states = []
    for device in ("cpu", dev):
        st = graph.make_session_state(u, v, n0, pair_capacity=P,
                                      device=device)
        st, _ = graph.session_fold_answers(st, upd)
        assert st.neg_keys.dtype == torch.int32
        wide = ud_ops.union_deduce.wide_launches
        st = graph.session_append_pairs(graph.session_grow(st, 2 * P, n1),
                                        au, av, am)
        assert st.neg_keys.dtype == torch.int64
        st, _ = graph.session_fold_answers(st, upd2)
        if device == dev:
            assert ud_ops.union_deduce.wide_launches > wide
        states.append(session_state_to_numpy(st))
    for f in states[0]:
        np.testing.assert_array_equal(states[1][f], states[0][f], err_msg=f)


@pytest.mark.parametrize("async_mode", [False, True])
def test_streaming_service_on_card(dev, async_mode, monkeypatch):
    """``submit_embeddings(streaming=True)`` with two ``append_embeddings``
    epochs on the card labels every candidate to the truth; an interleaved
    ``submit_stream`` whose first two epochs lie below 32768 objects (int32
    keys; the second is ingested before the first round) and whose later
    ones reach 65535 widens the keys to int64 while real neg keys are in
    the index, takes the wide ``union_deduce`` kernel after it, and gives
    every result field identical on the card and on the CPU."""
    from repro_torch.serve import join_service

    grow = join_service.session_grow
    growths = []

    def rec(state, pair_capacity, object_capacity):
        live = int((state.neg_keys
                    != key_sentinel(state.neg_keys.dtype)).sum())
        out = grow(state, pair_capacity, object_capacity)
        growths.append((state.neg_keys.device.type, state.neg_keys.dtype,
                        out.neg_keys.dtype, live))
        return out

    monkeypatch.setattr(join_service, "session_grow", rec)
    ia, a, ib, b = _stream_corpus(5, 600, 64, 80)
    rng = np.random.default_rng(8)
    objs = np.sort(np.append(rng.choice(65535, 299, replace=False), 65535))
    low = objs[objs < 32768]
    cluster = rng.integers(0, 40, 65536)
    parts = [rng.choice(low, (60, 2)), rng.choice(low, (60, 2)),
             rng.choice(objs, (100, 2)), rng.choice(objs, (100, 2))]
    epochs = []
    for x in parts:
        x = x[x[:, 0] != x[:, 1]].astype(np.int32)
        t = cluster[x[:, 0]] == cluster[x[:, 1]]
        lik = (np.where(t, 0.8, 0.3) + 0.15 * rng.random(len(x))).astype(
            np.float32)
        epochs.append(PairSet(x[:, 0], x[:, 1], lik, t))
    truth = np.concatenate([e.truth for e in epochs])
    assert max(e.n_objects for e in epochs[:2]) <= 32768
    assert 46340 < max(e.n_objects for e in epochs)
    results = []
    wide = ud_ops.union_deduce.wide_launches
    for device in (dev, "cpu"):
        svc = JoinService(lanes=2, async_mode=async_mode, device=device)
        rid = svc.submit_stream(epochs, PerfectCrowd(), interleave=True)
        results.append(svc.run()[rid])
    _assert_fields_equal(*results)
    assert ud_ops.union_deduce.wide_launches > wide
    assert any(where == "cuda" and old == torch.int32
               and new == torch.int64 and live > 0
               for where, old, new, live in growths), growths
    np.testing.assert_array_equal(results[0].labels, truth)

    svc = JoinService(lanes=2, async_mode=async_mode, device=dev)
    rid = svc.submit_embeddings(
        torch.from_numpy(a[:300]).to(dev), torch.from_numpy(b[:300]).to(dev),
        0.8, crowd=PerfectCrowd(), truth_fn=lambda r, c: ia[r] == ib[c],
        streaming=True)
    for lo, hi in ((300, 450), (450, 600)):
        svc.append_embeddings(rid, torch.from_numpy(a[lo:hi]).to(dev),
                              torch.from_numpy(b[lo:hi]).to(dev))
    assert svc._streams[rid].index._a.device.type == "cuda"
    res = svc.run()[rid]
    assert res.quality.precision == 1.0 and res.quality.recall == 1.0
    assert res.n_deduced > 0


def _recovery_pairs(seed, n=36, p=110, clusters=7):
    """``tests/test_recovery.py``'s session generator."""
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, clusters, n)
    u = rng.integers(0, n, p).astype(np.int32)
    v = rng.integers(0, n, p).astype(np.int32)
    keep = u != v
    u, v = u[keep], v[keep]
    truth = assign[u] == assign[v]
    lik = np.clip(rng.random(len(u)) * 0.5 + truth * 0.4, 0.0, 1.0)
    return PairSet(u, v, lik.astype(np.float32), truth, n)


@pytest.mark.parametrize("async_mode", [False, True],
                         ids=["round_barrier", "async"])
def test_checkpoint_moves_between_card_and_cpu(dev, tmp_path, async_mode):
    """A run killed at a checkpoint written on the card restores on the CPU
    and on the card, and one written on the CPU restores on the card: every
    restored run gives every result field of the uninterrupted card run."""
    from repro_torch.core.crowd import NoisyCrowd
    from repro_torch.serve.join_service import ServiceKilled

    def service(device, **kw):
        svc = JoinService(lanes=2, async_mode=async_mode, device=device,
                          **kw)
        for s in range(3):
            svc.submit(_recovery_pairs(s), crowd=NoisyCrowd(seed=s))
        return svc

    base = service(dev).run()
    for written, restored_on in ((dev, "cpu"), (dev, dev), ("cpu", dev)):
        ckpt = tmp_path / f"{written}_{restored_on}"
        svc = service(written, checkpoint_dir=str(ckpt))
        svc._crash_after_checkpoints = 2
        with pytest.raises(ServiceKilled):
            svc.run()
        restored = JoinService.restore(str(ckpt), device=restored_on)
        lanes, _ = restored._resume
        assert lanes and all(lane.state.u.device.type ==
                             torch.device(restored_on).type
                             for lane in lanes)
        out = restored.run()
        assert sorted(out) == sorted(base)
        for r in base:
            _assert_fields_equal(out[r], base[r])


def test_int64_lane_restores_on_card(dev, tmp_path):
    """A lane whose universe passed 46340 objects while open (keys widened
    to int64 at ingest) is checkpointed on the card and restored on the
    card: int64 neg keys padded with the int64 sentinel, real keys among
    them, the wide ``union_deduce`` launching after the restore, and every
    result field the uninterrupted CPU run's."""
    from repro_torch.core.crowd import NoisyCrowd
    from repro_torch.serve.join_service import ServiceKilled

    rng = np.random.default_rng(7)
    low = rng.choice(30000, 60, replace=False)
    high = 46341 + rng.choice(65536 - 46341, 60, replace=False)
    ent = np.zeros(65536, np.int64)
    ent[low] = rng.integers(0, 6, 60)
    ent[high] = rng.integers(0, 6, 60)

    def epoch(pool, p):
        u, v = rng.choice(pool, p), rng.choice(pool, p)
        keep = u != v
        u, v = u[keep], v[keep]
        truth = ent[u] == ent[v]
        lik = np.clip(0.5 + 0.3 * (truth - 0.5)
                      + 0.2 * rng.random(len(u)), 0, 1).astype(np.float32)
        return PairSet(u, v, lik, truth,
                       n_objects=int(max(u.max(), v.max())) + 1)

    both = np.concatenate([low, high])
    epochs = [epoch(low, 200), epoch(both, 200), epoch(both, 200),
              epoch(both, 200)]

    def serve(device, **kw):
        svc = JoinService(lanes=1, fused_rounds=False, device=device, **kw)
        rid = svc.submit_stream(epochs, crowd=NoisyCrowd(seed=1,
                                                         error_rate=0.2),
                                interleave=True)
        return svc, rid

    svc, rid = serve("cpu")
    base = svc.run()[rid]
    svc, _ = serve(dev, checkpoint_dir=str(tmp_path))
    svc._crash_after_checkpoints = 3
    with pytest.raises(ServiceKilled):
        svc.run()
    restored = JoinService.restore(str(tmp_path), device=dev)
    lanes, _ = restored._resume
    keys = lanes[0].state.neg_keys
    assert keys.device.type == "cuda" and keys.dtype == torch.int64
    pad = keys == key_sentinel(torch.int64)
    assert bool(pad.any()) and bool((~pad).any())
    wide = ud_ops.union_deduce.wide_launches
    res = restored.run()[rid]
    assert ud_ops.union_deduce.wide_launches > wide
    _assert_fields_equal(res, base)


# --------------------------------------------------------------------------
# training: attention's gradient through the kernel's forward, a
# deterministic train step, the card against the CPU
# --------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,H,K,d", [(8, 128, 12, 12, 64),
                                       (2, 200, 4, 2, 32),
                                       (8, 128, 16, 16, 128)])  # 4s' layer
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_fn_gradients_match_plain(dev, B, S, H, K, d, dtype):
    """A CUDA tensor that requires a gradient gets one through attention:
    the output has a grad_fn, the forward launched the kernel, and dq, dk,
    dv match the plain version's autograd gradients on the card (f32
    within 2e-5; bf16 within 2**-7 |expected| + 1e-4 element by element:
    both recompute in f32 and round once to bf16)."""
    from repro_torch.models.layers import FlashAttentionFn

    gen = torch.Generator(device="cpu").manual_seed(S + H)
    q, k, v = (torch.randn(B, S, n, d, generator=gen).to(dev, dtype)
               .requires_grad_() for n in (H, K, K))
    g = torch.randn(B, S, H, d, generator=gen).to(dev, dtype)
    before = fa_ops.flash_attention.launches
    o = FlashAttentionFn.apply(q, k, v, 64)
    assert o.grad_fn is not None
    assert fa_ops.flash_attention.launches == before + 1
    got = torch.autograd.grad(o, (q, k, v), g)
    exp = torch.autograd.grad(mha_causal_ref(q, k, v), (q, k, v), g)
    torch.cuda.synchronize()
    for a, b in zip(got, exp):
        assert a.dtype == dtype
        err = (a.float() - b.float()).abs()
        if dtype == torch.float32:
            assert float(err.max()) <= 2e-5
        else:
            assert bool((err <= 2.0 ** -7 * b.float().abs() + 1e-4).all())


def _train(dev, steps, state=None, mb=1, comp=False):
    from repro_torch.data.entities import make_paper_dataset
    from repro_torch.data.tokens import TokenPipeline, corpus_from_records
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = get("paper-scorer").reduced()
    rows = corpus_from_records(make_paper_dataset().records, cfg.vocab, 128)
    pipe = TokenPipeline(rows, 8)
    if state is None:
        state = init_state(cfg, torch.Generator(device=dev).manual_seed(0),
                           comp, dev)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, total_steps=30,
                                            warmup_steps=2), mb, comp)
    losses = []
    for i in range(steps):
        state, met = step(state, pipe.batch_at(i))
        losses.append(float(met["loss"]))
    return state, losses


@pytest.mark.parametrize("mb,comp", [(1, False), (2, True)])
def test_train_step_is_deterministic_on_card(dev, mb, comp):
    """Two runs of the same steps give bit-identical parameters, moments
    and losses (the embedding's backward is ``F.embedding``'s, not
    indexing's atomics), and every attention forward of a step launched
    the flash kernel: twice a layer under remat."""
    from repro_torch.train.train_step import state_tree
    from repro_torch.train.optim import tree_leaves

    before = fa_ops.flash_attention.launches
    a, loss_a = _train(dev, 3, mb=mb, comp=comp)
    assert fa_ops.flash_attention.launches - before == 3 * mb * 2 * 2
    b, loss_b = _train(dev, 3, mb=mb, comp=comp)
    assert loss_a == loss_b and loss_a[-1] < loss_a[0]
    for (p, x), (_, y) in zip(tree_leaves(state_tree(a)),
                              tree_leaves(state_tree(b))):
        assert x.device.type == "cuda" and torch.equal(x, y), p


def test_train_step_on_card_matches_cpu(dev):
    """One reduced ``init_state`` drawn on the CPU, moved to the card: 3
    steps on each agree within the bf16 bound of
    ``tests/test_torch_train.py`` (2e-3 of the loss)."""
    from repro_torch.convert import (train_state_from_numpy,
                                     train_state_to_numpy)
    from repro_torch.train.train_step import init_state

    cfg = get("paper-scorer").reduced()
    host = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = train_state_from_numpy(cfg, train_state_to_numpy(host), dev)
    _, on_cpu = _train("cpu", 3, host)
    _, on_card = _train(dev, 3, card)
    np.testing.assert_allclose(on_card, on_cpu, rtol=2e-3, atol=0)


# ---------------------------------------------------------------------------
# the dry-run's cells (chip_smoke.py phase 4p): the kernels at their
# shapes, and the sliced parameter draw on a card's generator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,H,K,d", [
    (1, 8192, 16, 8, 128),     # internlm2-1.8b, prefill_32k's plain-held S
    (8, 1024, 16, 16, 128),    # moonshot-v1-16b-a3b's heads
])
def test_flash_attention_kernel_at_the_dryrun_cells(dev, B, S, H, K, d):
    q = _randn(dev, (B, S, H, d), torch.bfloat16, S)
    k = _randn(dev, (B, S, K, d), torch.bfloat16, S + 1)
    v = _randn(dev, (B, S, K, d), torch.bfloat16, S + 2)
    got = fa_kernel.flash_attention(q, k, v)
    _assert_attn_close(got, mha_causal_ref(q, k, v), "flash")


def test_flash_attention_kernel_at_32768_tokens_last_rows(dev):
    """(1, 32768, 16 / 8, 128): the plain version's f32 score matrix would
    be 68.7 GB, so the last 256 query rows are held to the plain f32
    attention of those rows over every key before them."""
    from repro_torch.models.layers import _attention_chunk

    S, rows = 32768, 256
    q = _randn(dev, (1, S, 16, 128), torch.bfloat16, 1)
    k = _randn(dev, (1, S, 8, 128), torch.bfloat16, 2)
    v = _randn(dev, (1, S, 8, 128), torch.bfloat16, 3)
    got = fa_kernel.flash_attention(q, k, v)[:, S - rows:]
    exp = _attention_chunk(q[:, S - rows:].float(), k.float(), v.float(),
                           S - rows).to(torch.bfloat16)
    _assert_attn_close(got, exp, "flash")


@pytest.mark.parametrize("B,S,H,K,d,length", [
    (8, 32768, 16, 8, 128, 32760),    # internlm2-1.8b at decode_32k, batch 8
    (1, 32768, 16, 16, 128, 32760),   # moonshot-v1-16b-a3b there, batch 1
    (8, 2048, 16, 16, 128, 1039),     # moonshot's serving wave
])
def test_decode_attention_kernel_at_the_dryrun_cells(dev, B, S, H, K, d,
                                                     length):
    q = _randn(dev, (B, H, d), torch.bfloat16, length)
    kc = _randn(dev, (B, S, K, d), torch.bfloat16, length + 1)
    vc = _randn(dev, (B, S, K, d), torch.bfloat16, length + 2)
    kc[:, length:] = 1e4
    vc[:, length:] = -1e4
    n = torch.tensor(length, dtype=torch.int32, device=dev)
    got = da_kernel.decode_attention(q, kc, vc, n)
    _assert_attn_close(got, decode_attention_ref(q, kc, vc, length),
                       "decode")


def test_sliced_draw_on_a_card_generator(dev, monkeypatch):
    """A leaf drawn a slice at a time on the card's generator is the
    slices drawn one after another from that generator, scaled and cast
    (the same generator order), and repeats bit for bit.  A config the card
    drew before is not sliced on an 80 GB card, so its draw is the whole
    draw of before, leaf for leaf (``paper-scorer`` here;
    ``chip_smoke.py`` phase 4p does ``internlm2-1.8b``)."""
    import math

    from repro_torch.models import model as M
    from repro_torch.models.layers import ParamSpec

    spec = ParamSpec((4, 8, 256, 96), (None,) * 4, fan_in=256)
    monkeypatch.setattr(M, "_device_bytes", lambda device: 0)
    draws = [M._normal_leaf(spec, torch.Generator(device=dev).manual_seed(5),
                            torch.device(dev), 0) for _ in range(2)]
    gen = torch.Generator(device=dev).manual_seed(5)
    want = torch.stack([(torch.randn(spec.shape[1:], generator=gen,
                                     device=dev) * (1.0 / math.sqrt(256)))
                        .to(torch.bfloat16) for _ in range(4)])
    for got in draws:
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    monkeypatch.undo()
    cfg = get("paper-scorer")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for path, spec in sorted(M.model_specs(cfg).items()):
        leaf = getattr(model, path.replace("/", "_"))
        if spec.fan_in == 0:
            assert not bool(leaf.any()), path
            continue
        w = torch.randn(spec.shape, generator=gen, device=dev)
        w *= 1.0 / math.sqrt(spec.fan_in)
        assert torch.equal(leaf.view(torch.int16),
                           w.to(torch.bfloat16).view(torch.int16)), path


def test_draw_room_counts_the_allocator_s_cached_blocks(dev):
    """``init_params`` sizes its draw by the room the card has when the draw
    starts: a block the caching allocator keeps after an earlier tensor is
    freed counts as room, a live tensor does not."""
    from repro_torch.models import model as M

    torch.cuda.synchronize()
    before = M._device_bytes(torch.device(dev))
    block = torch.empty(2 ** 30, dtype=torch.uint8, device=dev)
    held = M._device_bytes(torch.device(dev))
    del block
    freed = M._device_bytes(torch.device(dev))
    assert before - held >= 2 ** 30
    assert torch.cuda.memory_reserved(dev) >= 2 ** 30
    assert abs(freed - before) < 2 ** 26


# ---------------------------------------------------------------------------
# the (data, model) mesh: ranks sharing the card (tests/torch_mesh_ranks.py)
# ---------------------------------------------------------------------------
def test_mesh_ranks_on_the_card_gather_the_kernel_s_candidates(dev):
    """A (2, 2) mesh of four ranks on the card(s): the backend the launcher
    names (gloo where ranks share a card), each rank launching the
    pair_scores kernel once on its block, and the gathered candidates the
    single-device call's bit for bit (every cell fmaf-summed in k order from
    0 whatever the block's size), identical on every rank."""
    import torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import spawn

    rng = np.random.default_rng(11)
    cents = rng.normal(size=(40, 64))
    ea = (cents[rng.integers(0, 40, 301)]
          + 0.3 * rng.normal(size=(301, 64))).astype(np.float32)
    eb = (cents[rng.integers(0, 40, 263)]
          + 0.3 * rng.normal(size=(263, 64))).astype(np.float32)
    out = spawn(ranks.card_candidates, 2, 2, device="cuda",
                args=(ea, eb, 0.7), timeout=300)
    backend = "nccl" if torch.cuda.device_count() >= 4 else "gloo"
    assert f"backend='{backend}'" in out["mesh"]
    assert "device='cuda:0'" in out["mesh"]
    assert out["launches"] == [1, 1, 1, 1]
    assert len(set(out["digests"])) == 1
    single = sharded_candidates(torch.from_numpy(ea).to(dev),
                                torch.from_numpy(eb).to(dev), 0.7)
    got = out["cand"]
    key = np.lexsort((got["cols"], got["rows"]))
    assert got["n_dropped"] == 0 and len(single.rows) > 100
    np.testing.assert_array_equal(got["rows"][key], single.rows)
    np.testing.assert_array_equal(got["cols"][key], single.cols)
    np.testing.assert_array_equal(got["scores"][key].view(np.int32),
                                  single.scores.view(np.int32))


def test_mesh_launcher_fails_with_a_failing_rank_on_the_card(dev):
    import torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import spawn

    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        spawn(ranks.one_rank_raises, 1, 2, device="cuda", timeout=120)


def test_a2a_experts_on_the_card(dev):
    """moe_block_a2a on a (2, 2) mesh of ranks on the card (two experts a
    rank of the reduced olmoe-1b-7b): in bf16 within the reference test's
    8e-3 of the one-device moe_block, forward and input gradient; in f32
    the output and the input's, router's and experts' gradients within
    1e-4 (cuBLAS sums the batched products in orders of its own choosing
    for the two shapes)."""
    import torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import spawn

    cfg = get("olmoe-1b-7b").reduced()
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    rng = np.random.default_rng(5)

    def bf16(shape, scale):
        x = torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32))
        return x.to(torch.bfloat16).float().numpy()

    ins = {"capacity_factor": 8.0, "moe_x": bf16((4, 64, d), 0.5),
           "moe_router": bf16((d, E), d ** -0.5),
           "moe_wi_gate": bf16((E, d, f), d ** -0.5),
           "moe_wi_up": bf16((E, d, f), d ** -0.5),
           "moe_wo": bf16((E, f, d), f ** -0.5)}
    out = spawn(ranks.a2a, 2, 2, device="cuda", args=(ins,), timeout=300)
    for key in ("y", "x_grad"):
        assert np.abs(out["bf16_a2a"][key]
                      - out["bf16_one"][key]).max() < 8e-3, key
    for key in ("y", "x_grad", "router_grad", "wi_gate_grad", "wi_up_grad",
                "wo_grad"):
        np.testing.assert_allclose(out["f32_a2a"][key], out["f32_one"][key],
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_mesh_train_step_on_the_card(dev):
    """The reduced paper-scorer's mesh step on a (2, 2) mesh of ranks on
    the card, 3 steps twice from the same seeded draw in the same ranks:
    the two runs' losses and final states equal bit for bit on every rank,
    every rank launched the flash kernel twice a layer a step (remat), and
    the losses are the one-device step's on the card within the bf16
    bound of tests/test_torch_train.py (2e-3 of the loss)."""
    import torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import spawn
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = get("paper-scorer").reduced()
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(3):
        toks = rng.integers(2, cfg.vocab, size=(8, 65)).astype(np.int32)
        tgt = toks[:, 1:].copy()
        tgt[:, -1] = -1
        batches.append({"tokens": toks[:, :-1].copy(), "targets": tgt})
    out = spawn(ranks.card_train, 2, 2, device="cuda", args=(batches,),
                timeout=300)
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1))
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    one = [float(step(state, b)[1]["loss"]) for b in batches]
    for rank in out:
        a, b = rank["runs"]
        assert a == b and a == out[0]["runs"][0]
        assert rank["launches"] == 2 * 3 * 2 * cfg.n_layers
        np.testing.assert_allclose(a["losses"], one, rtol=2e-3, atol=0)
