"""The port's LSH-blocked machine phase (``repro_torch.kernels.pair_scores``:
``pair_scores_compact`` and ``blocking``) and the service's
``submit_embeddings(blocking=...)`` against the JAX package on the CPU, the
reference's Pallas kernel run in interpret mode.

Tolerances (ROADMAP C4).  The port's plain version takes each tile's product
with PyTorch's CPU matrix product and the reference with XLA's CPU dot, so a
score moves on the scale of an ulp of 1.0: scores from identical normalized
inputs are held to 2 ulp of 1.0, and, with each side normalizing its own
inputs, to 4.  Candidate sets, their order, counts and all the blocking
accounting must be identical.  The test data keeps every score at least 1e-5
from the threshold, and every LSH projection at least 1e-4 from 0, so that
those ulps cannot move a pair across the threshold or into another bucket.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PerfectCrowd as JaxPerfectCrowd
from repro.kernels.pair_scores import blocking as jax_blocking
from repro.kernels.pair_scores.kernel import \
    pair_scores_compact as jax_pair_scores_compact
from repro.kernels.pair_scores.ops import l2_normalize as jax_l2_normalize
from repro.launch.mesh import make_host_mesh
from repro.serve.join_service import JoinService as JaxJoinService
from repro_torch.core.crowd import PerfectCrowd
from repro_torch.kernels.pair_scores import blocking
from repro_torch.kernels.pair_scores.ops import pair_scores_compact
from repro_torch.kernels.pair_scores.ref import pair_scores_compact_ref
from repro_torch.serve.join_service import JoinService

ULP_ONE = 2.0 ** -23
TAU = 0.85
MARGIN = 1e-5        # no score this close to the threshold
PROJ_MARGIN = 1e-4   # no LSH projection this close to 0


def _corpus(seed, n_a=40, n_b=36, n_ent=12, dim=16, noise=0.15):
    """Entity-clustered embeddings (the pattern of tests/test_blocking.py),
    not normalized.  Returns (entity id per a-row, a, entity id per b-row,
    b) as numpy."""
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(n_ent, dim))
    ia = rng.integers(0, n_ent, n_a)
    ib = rng.integers(0, n_ent, n_b)
    a = (cents[ia] + noise * rng.normal(size=(n_a, dim))).astype(np.float32)
    b = (cents[ib] + noise * rng.normal(size=(n_b, dim))).astype(np.float32)
    return ia, a, ib, b


def _normalized(x):
    return np.array(jax_l2_normalize(jnp.asarray(x)))


def _check_margins(a, b, tau, cfg=None):
    """The data is far enough from every decision boundary for exact set
    comparison (see the module docstring)."""
    s = a.astype(np.float64) @ b.astype(np.float64).T
    assert np.abs(s - tau).min() > MARGIN
    if cfg is not None:
        planes = np.random.default_rng(cfg.seed).normal(
            size=(cfg.n_tables, a.shape[1], cfg.n_bits)).astype(np.float32)
        for x in (a, b):
            proj = np.einsum("nd,ldb->lnb", x.astype(np.float64), planes)
            assert np.abs(proj).min() > PROJ_MARGIN


def _gather(a, b, tiles_a, tiles_b):
    """The tile gather of score_block_pairs, in numpy: (a_g, b_g, ida,
    idb)."""
    a_ext = np.concatenate([a, np.zeros((1, a.shape[1]), a.dtype)])
    b_ext = np.concatenate([b, np.zeros((1, b.shape[1]), b.dtype)])
    a_g = a_ext[np.where(tiles_a < 0, len(a), tiles_a).reshape(-1)]
    b_g = b_ext[np.where(tiles_b < 0, len(b), tiles_b).reshape(-1)]
    return (a_g, b_g, tiles_a.reshape(-1, 1).astype(np.int32),
            tiles_b.reshape(-1, 1).astype(np.int32))


def _assert_compact_equal(got, ref, capacity):
    rows, cols, scores, n_total = (x.numpy() for x in got)
    r_rows, r_cols, r_scores, r_n = (np.asarray(x) for x in ref)
    assert rows.shape == r_rows.shape and scores.dtype == np.float32
    assert int(n_total[0, 0]) == int(r_n[0, 0])
    n = min(int(r_n[0, 0]), capacity)
    np.testing.assert_array_equal(rows[:n], r_rows[:n])
    np.testing.assert_array_equal(cols[:n], r_cols[:n])
    np.testing.assert_allclose(scores[:n], r_scores[:n], rtol=0,
                               atol=2 * ULP_ONE)
    for x, y, fill in ((rows, r_rows, -1), (cols, r_cols, -1),
                       (scores, r_scores, 0)):
        assert (x[n:capacity] == fill).all() and (y[n:capacity] == fill).all()
    return int(r_n[0, 0])


def _compact_both(a_g, b_g, ida, idb, tau, capacity, bn, bm):
    ref = jax_pair_scores_compact(
        jnp.asarray(a_g), jnp.asarray(b_g), jnp.asarray(ida),
        jnp.asarray(idb), tau, capacity, bn, bm, interpret=True)
    got = pair_scores_compact(torch.from_numpy(a_g), torch.from_numpy(b_g),
                              torch.from_numpy(ida), torch.from_numpy(idb),
                              tau, capacity, bn, bm)
    return got, ref


# ---------------------------------------------------------------------------
# the compact kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_a,n_b,dim,bn,bm", [
    (37, 51, 16, 16, 16),   # ragged edges on both sides
    (33, 20, 24, 8, 32),    # bn != bm, depth not a multiple of 16
    (16, 16, 16, 16, 16),   # one full tile
])
def test_compact_ref_matches_interpret_on_dense_tilings(n_a, n_b, dim, bn,
                                                        bm):
    _, a, _, b = _corpus(n_a + n_b, n_a=n_a, n_b=n_b, dim=dim)
    a, b = _normalized(a), _normalized(b)
    _check_margins(a, b, TAU)
    ta, tb = blocking.dense_block_pairs(n_a, n_b, bn, bm)
    args = _gather(a, b, ta, tb)
    cap = len(ta) * bn * bm
    n_total = _assert_compact_equal(*_compact_both(*args, TAU, cap, bn, bm),
                                    cap)
    assert n_total == int((a @ b.T >= TAU).sum()) > 0
    # an overflowing capacity keeps the same prefix and the true count
    cap = n_total // 2
    _assert_compact_equal(*_compact_both(*args, TAU, cap, bn, bm), cap)


def test_compact_ref_matches_interpret_on_an_lsh_tile_list():
    _, a, _, b = _corpus(5)
    a, b = _normalized(a), _normalized(b)
    _check_margins(a, b, TAU)
    cfg = blocking.BlockingConfig(n_bits=3, n_tables=2, bn=8, bm=8)
    ta, tb = blocking.block_pairs(blocking.signatures(a, cfg),
                                  np.arange(len(a)),
                                  blocking.signatures(b, cfg),
                                  np.arange(len(b)), cfg.bn, cfg.bm)
    assert len(ta) > 1 and (ta < 0).any()
    cap = len(ta) * cfg.bn * cfg.bm
    assert _assert_compact_equal(
        *_compact_both(*_gather(a, b, ta, tb), TAU, cap, cfg.bn, cfg.bm),
        cap) > 0


# tiles past the card kernel's 128 rows a side (its band kernel): T = 2
# tiles of a dense tiling each, ragged on the wide side
@pytest.mark.parametrize("n_a,n_b,bn,bm", [
    (200, 400, 256, 256),
    (150, 250, 200, 136),
    (600, 50, 512, 64),
])
def test_compact_ref_matches_interpret_on_wide_tiles(n_a, n_b, bn, bm):
    _, a, _, b = _corpus(bn + bm, n_a=n_a, n_b=n_b, dim=16)
    a, b = _normalized(a), _normalized(b)
    _check_margins(a, b, TAU)
    ta, tb = blocking.dense_block_pairs(n_a, n_b, bn, bm)
    assert len(ta) == 2
    args = _gather(a, b, ta, tb)
    cap = len(ta) * bn * bm
    n_total = _assert_compact_equal(*_compact_both(*args, TAU, cap, bn, bm),
                                    cap)
    assert n_total == int((a @ b.T >= TAU).sum()) > 0
    # an overflowing capacity keeps the same prefix and the true count
    cap = n_total // 2
    _assert_compact_equal(*_compact_both(*args, TAU, cap, bn, bm), cap)


def cluster_positions(keep, cluster):
    """The card's band kernel's output positions for one bn x bm tile whose
    kept cells are ``keep``, as its clusters compute them
    (``pair_scores_compact.cu``): a band of 128 rows a cluster, column
    block ``round * cluster + rank`` a block and round.  Each block scans
    its (row, 4-column group) counts within the row and keeps each row's
    cells, which the cluster's blocks read from one another; a cell's
    position is base (the look-back over earlier bands) + its row's offset
    in the band (the scan over rows of every column block's cells) + its
    row's cells in earlier rounds + in the round's blocks before its own +
    its rank in the row within its block.  Returns the positions and the
    tile's count."""
    from repro_torch.kernels.pair_scores.kernel import TILE_ROWS

    bn, bm = keep.shape
    rounds = -(-(-(-bm // TILE_ROWS)) // cluster)
    width = rounds * cluster * TILE_ROWS
    padded = np.zeros((bn, width), bool)
    padded[:, :bm] = keep
    got = np.full((bn, width), -1)
    base = 0
    for r0 in range(0, bn, TILE_ROWS):
        # (row, round, rank, 4-column group, column in the group)
        band = padded[r0:r0 + TILE_ROWS].reshape(-1, rounds, cluster,
                                                 TILE_ROWS // 4, 4)
        groups = band.sum(axis=4)
        within = np.cumsum(groups, axis=3) - groups
        row_cnt = groups.sum(axis=3)
        before = np.cumsum(row_cnt, axis=2) - row_cnt
        per_round = row_cnt.sum(axis=2)
        done = np.cumsum(per_round, axis=1) - per_round
        row_cells = per_round.sum(axis=1)
        row_off = np.cumsum(row_cells) - row_cells
        first = base + row_off[:, None, None, None] \
            + done[:, :, None, None] + before[..., None] + within
        pos = first[..., None] + np.cumsum(band, axis=4) - band
        got[r0:r0 + TILE_ROWS] = pos.reshape(band.shape[0], -1)
        base += int(row_cells.sum())
    return got[:, :bm], base


# past 128 rows a side, with one to eight column blocks a cluster, and past
# eight (bm > 1024: a block takes every eighth column block)
@pytest.mark.parametrize("bn,bm", [(256, 256), (200, 136), (512, 64),
                                   (64, 512), (129, 1), (130, 1029),
                                   (1, 2049), (300, 1024)])
def test_band_positions_are_row_major_order(bn, bm):
    """The band kernel's rank arithmetic, mirrored on the CPU, puts every
    kept cell of a tile past 128 rows a side where row-major order over the
    whole bn x bm tile (the reference's order) puts it, band after band."""
    from repro_torch.kernels.pair_scores.kernel import compact_plan

    rng = np.random.default_rng(bn * 1000 + bm)
    keep = rng.random((bn, bm)) < 0.3
    want = np.cumsum(keep.reshape(-1)).reshape(bn, bm) - keep
    got, n = cluster_positions(keep, compact_plan(1, bn, bm).cluster)
    np.testing.assert_array_equal(got[keep], want[keep])
    assert n == int(keep.sum())


@pytest.mark.parametrize("T,bn,bm,want", [
    (3, 128, 128, ("one-pass", 3, 1, 3)),
    (5, 1, 1, ("one-pass", 5, 1, 5)),
    (64, 256, 256, ("band", 128, 2, 256)),
    (154, 200, 136, ("band", 308, 2, 616)),
    (128, 512, 64, ("band", 512, 1, 512)),
    (3, 64, 512, ("band", 3, 4, 12)),
    (2, 129, 1, ("band", 4, 1, 4)),
    (1, 300, 1024, ("band", 3, 8, 24)),
    (2, 130, 1029, ("band", 4, 8, 32)),
    (1, 1, 2049, ("band", 1, 8, 8)),
])
def test_compact_plan(T, bn, bm, want):
    """The launch: a block a tile up to 128 x 128, else a band of 128 rows
    an item on a cluster of a block a 128-column block, at most 8."""
    from repro_torch.kernels.pair_scores.kernel import compact_plan

    assert tuple(compact_plan(T, bn, bm)) == want


def test_compact_ref_all_padding_tiles_find_nothing():
    a = np.zeros((1, 16), np.float32)
    ta = np.full((3, 8), -1, np.int64)
    got, ref = _compact_both(*_gather(a, a, ta, ta), TAU, 64, 8, 8)
    assert _assert_compact_equal(got, ref, 64) == 0


def test_compact_ref_order_is_tile_then_row_major():
    """The plain version's own contract, independent of the reference."""
    rng = np.random.default_rng(0)
    a_g = torch.from_numpy(rng.normal(size=(3 * 4, 8)).astype(np.float32))
    b_g = torch.from_numpy(rng.normal(size=(3 * 5, 8)).astype(np.float32))
    ida = torch.arange(12, dtype=torch.int32)[:, None]
    idb = torch.arange(15, dtype=torch.int32)[:, None]
    rows, cols, scores, n = pair_scores_compact_ref(a_g, b_g, ida, idb, 0.5,
                                                    1000, 4, 5)
    n = int(n)
    keys = rows[:n, 0] // 4 * 10000 + rows[:n, 0] * 100 + cols[:n, 0]
    assert n > 0 and bool((keys[1:] > keys[:-1]).all())
    s = (a_g @ b_g.T)[rows[:n, 0].long(), cols[:n, 0].long()]
    assert bool((s >= 0.5).all()) and bool((rows[:n, 0] // 4
                                             == cols[:n, 0] // 5).all())


# ---------------------------------------------------------------------------
# the host side: identical to the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_bits,n_tables,bn,bm", [(5, 3, 16, 16),
                                                   (2, 4, 8, 32),
                                                   (8, 1, 128, 128)])
def test_signatures_and_block_pairs_are_the_reference(n_bits, n_tables, bn,
                                                      bm):
    _, a, _, b = _corpus(n_bits, n_a=70, n_b=50)
    a, b = _normalized(a), _normalized(b)
    kw = dict(n_bits=n_bits, n_tables=n_tables, bn=bn, bm=bm, seed=3)
    cfg, ref_cfg = blocking.BlockingConfig(**kw), \
        jax_blocking.BlockingConfig(**kw)
    codes = blocking.signatures(torch.from_numpy(a), cfg)
    ref_codes = jax_blocking.signatures(a, ref_cfg)
    np.testing.assert_array_equal(codes, ref_codes)
    codes_b = blocking.signatures(b, cfg)
    idx_a = np.arange(0, len(a), 2)
    for got, ref in zip(
            blocking.block_pairs(codes, idx_a, codes_b, np.arange(len(b)),
                                 bn, bm),
            jax_blocking.block_pairs(ref_codes, idx_a, codes_b,
                                     np.arange(len(b)), bn, bm)):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(blocking.dense_block_pairs(70, 50, bn, bm),
                        jax_blocking.dense_block_pairs(70, 50, bn, bm)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kw", [dict(n_bits=0), dict(n_bits=31),
                                dict(n_tables=0), dict(bn=0), dict(bm=-1),
                                dict(tiles_per_call=0)])
def test_blocking_config_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        jax_blocking.BlockingConfig(**kw)
    with pytest.raises(ValueError):
        blocking.BlockingConfig(**kw)


@pytest.mark.parametrize("floor,tau,n_bits", [(0.95, 0.85, 5), (0.9, 0.7, 6),
                                              (0.99, 0.9, 8)])
def test_for_recall_and_expected_recall_match(floor, tau, n_bits):
    cfg = blocking.BlockingConfig.for_recall(floor, tau, n_bits=n_bits,
                                             bn=16)
    ref = jax_blocking.BlockingConfig.for_recall(floor, tau, n_bits=n_bits,
                                                 bn=16)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    for s in (tau, 0.5, 0.99):
        assert blocking.expected_recall(cfg, s) == \
            jax_blocking.expected_recall(ref, s)
    assert blocking.expected_recall(cfg, tau) >= floor
    with pytest.raises(ValueError, match="max_tables"):
        blocking.BlockingConfig.for_recall(0.999, 0.5, n_bits=30)


# ---------------------------------------------------------------------------
# the blocked machine phase, field for field
# ---------------------------------------------------------------------------
CAND_FIELDS = ("n_dropped", "capacity", "suggested_capacity", "cells_scored",
               "padded_cells", "dense_cells", "n_tiles", "n_duplicates")


def _assert_candidates_equal(got, ref, tol=2 * ULP_ONE):
    np.testing.assert_array_equal(got.rows, ref.rows)
    np.testing.assert_array_equal(got.cols, ref.cols)
    np.testing.assert_allclose(got.scores, ref.scores, rtol=0, atol=tol)
    assert got.rows.dtype == np.int32 and got.scores.dtype == np.float32
    for f in CAND_FIELDS:
        assert getattr(got, f) == getattr(ref, f), f


@pytest.mark.parametrize("tiles_per_call,capacity", [
    (64, None),    # one chunk
    (4, None),     # several chunks (tiles_per_call < T)
    (4, 60),       # a capacity that overflows
])
@pytest.mark.parametrize("seed", [0, 7])
def test_blocked_candidates_match_reference(seed, tiles_per_call, capacity):
    _, a, _, b = _corpus(seed)
    a, b = _normalized(a), _normalized(b)
    cfg_kw = dict(n_bits=4, n_tables=3, bn=16, bm=8,
                  tiles_per_call=tiles_per_call)
    cfg = blocking.BlockingConfig(**cfg_kw)
    _check_margins(a, b, TAU, cfg)
    ref = jax_blocking.blocked_candidates(
        a, b, TAU, jax_blocking.BlockingConfig(**cfg_kw), capacity=capacity,
        normalize=False, impl="interpret")
    got = blocking.blocked_candidates(torch.from_numpy(a),
                                      torch.from_numpy(b), TAU, cfg,
                                      capacity=capacity, normalize=False)
    _assert_candidates_equal(got, ref)
    assert got.n_tiles > tiles_per_call or tiles_per_call == 64
    assert (got.n_dropped > 0) == (capacity is not None)
    assert got.n_duplicates > 0 or capacity is not None
    sample = np.arange(0, len(a), 3)
    assert blocking.blocker_recall(got, torch.from_numpy(a),
                                   torch.from_numpy(b), TAU,
                                   row_sample=sample, col_chunk=16) == \
        jax_blocking.blocker_recall(ref, a, b, TAU, row_sample=sample,
                                    col_chunk=16)


def test_score_block_pairs_on_a_dense_tiling_matches_reference():
    _, a, _, b = _corpus(3, n_a=37, n_b=51)
    a, b = _normalized(a), _normalized(b)
    _check_margins(a, b, TAU)
    kw = dict(n_bits=5, bn=16, bm=16, tiles_per_call=4)
    ta, tb = blocking.dense_block_pairs(len(a), len(b), 16, 16)
    ref = jax_blocking.score_block_pairs(
        a, b, ta, tb, TAU, jax_blocking.BlockingConfig(**kw),
        impl="interpret")
    got = blocking.score_block_pairs(torch.from_numpy(a), torch.from_numpy(b),
                                     ta, tb, TAU, blocking.BlockingConfig(**kw))
    _assert_candidates_equal(got, ref)
    rows, cols = np.nonzero(a @ b.T >= TAU)
    np.testing.assert_array_equal(got.rows, rows)
    np.testing.assert_array_equal(got.cols, cols)
    assert blocking.blocker_recall(got, torch.from_numpy(a),
                                   torch.from_numpy(b), TAU) == \
        (1.0, len(rows))


def test_blocked_path_rejects_bad_threshold():
    a = torch.ones(4, 8)
    cfg = blocking.BlockingConfig()
    with pytest.raises(ValueError, match="threshold > 0"):
        blocking.blocked_candidates(a, a, 0.0, cfg)
    ta, tb = blocking.dense_block_pairs(4, 4, 8, 8)
    with pytest.raises(ValueError, match="threshold > 0"):
        blocking.score_block_pairs(a, a, ta, tb, -0.5, cfg)


# ---------------------------------------------------------------------------
# the service: submit_embeddings(blocking=...) -> run()
# ---------------------------------------------------------------------------
def _result_fields(res) -> dict:
    out = {}
    for f in dataclasses.fields(res):
        if f.name == "wall_seconds":
            continue
        val = getattr(res, f.name)
        if isinstance(val, np.ndarray):
            val = (val.dtype, val.tolist())
        elif dataclasses.is_dataclass(val):
            val = dataclasses.asdict(val)
        out[f.name] = val
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_blocked_submit_embeddings_matches_reference(seed):
    """Each side normalizes its own embeddings, so scores are held to 4 ulp
    of 1.0 and no two scores lie that close, so the labeling orders agree
    and the sessions are the same problem."""
    ia, a, ib, b = _corpus(seed, n_a=48, n_b=40)
    cfg_kw = dict(n_bits=4, n_tables=4, bn=16, bm=16, tiles_per_call=8)
    _check_margins(_normalized(a), _normalized(b), TAU,
                   blocking.BlockingConfig(**cfg_kw))

    def truth(r, c):
        return ia[r] == ib[c]

    ttm = int((ia[:, None] == ib[None, :]).sum())
    ref_svc = JaxJoinService(lanes=2)
    ref_rid = ref_svc.submit_embeddings(
        jnp.asarray(a), jnp.asarray(b), TAU, make_host_mesh(1, 1),
        crowd=JaxPerfectCrowd(), truth_fn=truth, impl="interpret",
        total_true_matches=ttm,
        blocking=jax_blocking.BlockingConfig(**cfg_kw))
    svc = JoinService(lanes=2, device="cpu")
    rid = svc.submit_embeddings(
        torch.from_numpy(a), torch.from_numpy(b), TAU, crowd=PerfectCrowd(),
        truth_fn=truth, total_true_matches=ttm,
        blocking=blocking.BlockingConfig(**cfg_kw))
    ref_pairs, pairs = ref_svc.queue[0].pairs, svc.queue[0].pairs
    np.testing.assert_array_equal(pairs.u, ref_pairs.u)
    np.testing.assert_array_equal(pairs.v, ref_pairs.v)
    np.testing.assert_array_equal(pairs.truth, ref_pairs.truth)
    assert pairs.n_objects == ref_pairs.n_objects == 88
    ref_scores = 2.0 * ref_pairs.likelihood - 1.0
    np.testing.assert_allclose(2.0 * pairs.likelihood - 1.0, ref_scores,
                               rtol=0, atol=5 * ULP_ONE)
    ranked = np.sort(ref_scores)
    assert (np.diff(ranked) > 4 * np.spacing(ranked[1:])).all()
    got, ref = svc.run(), ref_svc.run()
    assert _result_fields(got[rid]) == _result_fields(ref[ref_rid])
    assert got[rid].quality.precision == 1.0 and got[rid].n_deduced > 0


def test_blocked_overflow_reports_a_capacity_that_fits():
    ia, a, ib, b = _corpus(4)
    cfg = blocking.BlockingConfig(n_bits=4, n_tables=3, bn=16, bm=16)
    full = blocking.blocked_candidates(torch.from_numpy(a),
                                       torch.from_numpy(b), TAU, cfg)
    small = blocking.blocked_candidates(torch.from_numpy(a),
                                        torch.from_numpy(b), TAU, cfg,
                                        capacity=20)
    assert small.n_dropped > 0
    svc = JoinService(device="cpu")
    with pytest.raises(RuntimeError,
                       match=f"capacity={small.suggested_capacity}"):
        svc.submit_embeddings(torch.from_numpy(a), torch.from_numpy(b), TAU,
                              capacity=20, blocking=cfg)
    assert not svc.queue
    svc.submit_embeddings(torch.from_numpy(a), torch.from_numpy(b), TAU,
                          truth_fn=lambda r, c: ia[r] == ib[c],
                          capacity=small.suggested_capacity, blocking=cfg)
    np.testing.assert_array_equal(svc.queue[0].pairs.u, full.rows)
    np.testing.assert_array_equal(svc.queue[0].pairs.v,
                                  full.cols + len(a))


def test_blocked_streaming_serves():
    """``submit_embeddings(streaming=True, blocking=...)`` then an
    ``append_embeddings`` epoch on each side: every queued epoch's pairs
    equal the reference's (scores within 4 ulp of 1.0, each side
    normalizing its own rows, no two of them that close), and the join
    gives every result field the reference's."""
    ia, a, ib, b = _corpus(2, n_a=48, n_b=40)
    cfg_kw = dict(n_bits=4, n_tables=4, bn=16, bm=16, tiles_per_call=8)
    _check_margins(_normalized(a), _normalized(b), TAU,
                   blocking.BlockingConfig(**cfg_kw))

    def truth(r, c):
        return ia[r] == ib[c]

    ref_svc = JaxJoinService(lanes=1)
    ref_rid = ref_svc.submit_embeddings(
        jnp.asarray(a[:30]), jnp.asarray(b[:24]), TAU, make_host_mesh(1, 1),
        crowd=JaxPerfectCrowd(), truth_fn=truth, impl="interpret",
        streaming=True, blocking=jax_blocking.BlockingConfig(**cfg_kw))
    ref_svc.append_embeddings(ref_rid, jnp.asarray(a[30:]),
                              jnp.asarray(b[24:]))
    svc = JoinService(lanes=1, device="cpu")
    rid = svc.submit_embeddings(
        torch.from_numpy(a[:30]), torch.from_numpy(b[:24]), TAU,
        crowd=PerfectCrowd(), truth_fn=truth, streaming=True,
        blocking=blocking.BlockingConfig(**cfg_kw))
    svc.append_embeddings(rid, torch.from_numpy(a[30:]),
                          torch.from_numpy(b[24:]))
    epochs = [svc.queue[0].pairs, *svc._pending_arrivals[rid]]
    ref_epochs = [ref_svc.queue[0].pairs,
                  *ref_svc._pending_arrivals[ref_rid]]
    scores = []
    for pairs, ref_pairs in zip(epochs, ref_epochs):
        np.testing.assert_array_equal(pairs.u, ref_pairs.u)
        np.testing.assert_array_equal(pairs.v, ref_pairs.v)
        np.testing.assert_array_equal(pairs.truth, ref_pairs.truth)
        assert pairs.n_objects == ref_pairs.n_objects
        ref_scores = 2.0 * ref_pairs.likelihood - 1.0
        np.testing.assert_allclose(2.0 * pairs.likelihood - 1.0, ref_scores,
                                   rtol=0, atol=5 * ULP_ONE)
        scores.append(ref_scores)
    ranked = np.sort(np.concatenate(scores))
    assert (np.diff(ranked) > 4 * np.spacing(ranked[1:])).all()
    assert len(epochs) == 2 and epochs[1].n_objects == 88
    got, ref = svc.run(), ref_svc.run()
    assert _result_fields(got[rid]) == _result_fields(ref[ref_rid])
    assert got[rid].quality.precision == 1.0
