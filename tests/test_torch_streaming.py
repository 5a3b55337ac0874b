"""Streaming ingest (DESIGN.md §11, ROADMAP A7 + A8 + A9.6): the port's
growing lanes, ``StreamingCandidateIndex`` and the service's streaming
surface against the JAX package's, on the CPU, on the same seeded inputs.

Three layers, as ``tests/test_streaming.py`` has them:

* engine: ``session_grow(_batch)`` and ``session_append_pairs(_batch)`` field
  for field against ``jax_graph``'s, the batch form against the one-lane
  form, a grown + appended state equal to one built from the concatenated
  pairs through noisy (conflicting) folds, and a lane grown past 46340
  objects (keys widen to int64) against the reference under
  ``jax.enable_x64(True)``, keys compared as int64 values;
* machine phase: the index, dense and LSH-blocked, over mixed epochs: the
  union of its epochs equals one batch call (sets exact, scores within
  1e-6: on the CPU a block's matrix product may sum in another order than
  the whole one's, ROADMAP C4), its per-epoch candidates and counters equal
  the reference index's, and a rolled-back epoch leaves no trace;
* serving: ``submit_stream`` (up front and interleaved), ``append``,
  ``submit_embeddings(streaming=True)`` and ``append_embeddings`` under
  both disciplines, every ``JoinSessionResult`` field identical to the
  reference's (the wall clock aside; ``sim_minutes`` compared with ``==``),
  and an up-front stream equal to the single-shot batch run of the same
  pairs.

The reference's ``_noisy_stream_parity`` harness hard-codes the first
epoch's pair capacity at 8 and so raises ``IndexError`` for a longer first
epoch (ROADMAP R2); here epoch 1 is sized from its own length.  The
embedding data is entity-clustered and kept clear of the threshold by more
than the score tolerance (ROADMAP C7), so the candidate sets are exact.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st

from benchmarks.common import split_epochs as jax_split_epochs
from repro.core import LatencyModel as JaxLatencyModel
from repro.core import NoisyCrowd as JaxNoisyCrowd
from repro.core import PerfectCrowd as JaxPerfectCrowd
from repro.core import jax_graph as jg
from repro.core.pairs import PairSet as JaxPairSet
from repro.data.entities import make_session_pairsets
from repro.kernels.pair_scores.blocking import BlockingConfig as JaxBlocking
from repro.kernels.pair_scores.sharded import \
    StreamingCandidateIndex as JaxIndex
from repro.launch.mesh import make_host_mesh
from repro.serve.join_service import JoinService as JaxJoinService
from repro_torch.convert import session_state_to_numpy
from repro_torch.core import graph as tg
from repro_torch.core.cluster_graph import NEG, POS, UNKNOWN, ClusterGraph
from repro_torch.core.crowd import LatencyModel, NoisyCrowd, PerfectCrowd
from repro_torch.core.pairs import PairSet
from repro_torch.kernels.pair_scores.blocking import (BlockingConfig,
                                                      blocked_candidates)
from repro_torch.kernels.pair_scores.sharded import (StreamingCandidateIndex,
                                                     sharded_candidates)
from repro_torch.serve.join_service import JoinService

FIELDS = ("u", "v", "labels", "published", "roots", "neg_keys", "rounds",
          "conflicts", "priority")
SCORE_TOL = 1e-6
BLOCKING = dict(n_bits=4, n_tables=3, bn=16, bm=16, tiles_per_call=32)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _fields(res) -> dict:
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


def _port_pairs(ps) -> PairSet:
    return PairSet(ps.u, ps.v, ps.likelihood, ps.truth, ps.n_objects)


def _split_epochs(pairs, k: int, seed: int):
    """``benchmarks/common.py::split_epochs`` for the port's ``PairSet``
    (k non-empty contiguous chunks; each epoch's universe is the largest id
    it holds, so later epochs grow it); checked against the original in
    :func:`test_split_epochs_copy_matches_the_benchmark_helper`."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, len(pairs)), size=k - 1,
                              replace=False))
    bounds = [0, *cuts.tolist(), len(pairs)]
    return [PairSet(pairs.u[a:b], pairs.v[a:b], pairs.likelihood[a:b],
                    None if pairs.truth is None else pairs.truth[a:b])
            for a, b in zip(bounds, bounds[1:])]


def _roots_from_labels(ps, labels: np.ndarray) -> np.ndarray:
    """Canonical cluster roots implied by a labeling of the pair set."""
    g = ClusterGraph(ps.n_objects)
    for i in np.nonzero(labels)[0]:
        g.add_label(int(ps.u[i]), int(ps.v[i]), POS)
    return np.array([g.find(i) for i in range(ps.n_objects)])


def _snap(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def _assert_state(got, exp: dict, msg: str = "", fields=FIELDS) -> None:
    """Field for field; neg keys as int64 values (the port's are int32
    below 46340 objects), every other dtype equal."""
    got = session_state_to_numpy(got)
    for f in fields:
        g, e = got[f], exp[f]
        if f == "neg_keys":
            g = np.where(g == np.iinfo(g.dtype).max, np.iinfo(np.int64).max,
                         g.astype(np.int64))
            e = np.where(e == np.iinfo(e.dtype).max, np.iinfo(np.int64).max,
                         e.astype(np.int64))
        else:
            assert g.dtype == e.dtype, f"{msg} {f} dtype"
        np.testing.assert_array_equal(g, e, err_msg=f"{msg} {f}")


def _candidates(cand) -> dict:
    return {(int(r), int(c)): float(s)
            for r, c, s in zip(cand.rows, cand.cols, cand.scores)}


def _assert_candidates(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, s in got.items():
        assert abs(s - want[key]) <= SCORE_TOL, key


def _entity_rows(rng, cents, n, noise=0.15):
    ids = rng.integers(0, len(cents), n)
    return ids, (cents[ids] + noise * rng.normal(size=(n, cents.shape[1]))
                 ).astype(np.float32)


def _scores_clear_of(a, b, tau, margin=1e-5) -> None:
    """No cosine within ``margin`` of the threshold (ROADMAP C7)."""
    a = a / np.linalg.norm(a.astype(np.float64), axis=1, keepdims=True)
    b = b / np.linalg.norm(b.astype(np.float64), axis=1, keepdims=True)
    assert np.abs(a @ b.T - tau).min() > margin


def test_split_epochs_copy_matches_the_benchmark_helper():
    ps = make_session_pairsets(1, seed=4, n_objects=(20, 30),
                               n_pairs=(40, 60))[0]
    for k, seed in ((3, 7), (4, 0)):
        for mine, ref in zip(_split_epochs(_port_pairs(ps), k, seed),
                             jax_split_epochs(ps, k, seed)):
            for f in ("u", "v", "likelihood", "truth"):
                np.testing.assert_array_equal(getattr(mine, f),
                                              getattr(ref, f))
            assert mine.n_objects == ref.n_objects


# ---------------------------------------------------------------------------
# engine: growth and appended pairs
# ---------------------------------------------------------------------------
def test_grown_fresh_state_equals_make_session_state():
    """Growing a fresh state equals building it at the larger capacities,
    and equals the reference's grown state field for field."""
    u = np.array([0, 1, 2], np.int32)
    v = np.array([1, 2, 3], np.int32)
    small = tg.make_session_state(u, v, 4, pair_capacity=4,
                                  object_capacity=4, device="cpu")
    grown = tg.session_grow(small, 16, 8)
    built = tg.make_session_state(u, v, 4, pair_capacity=16,
                                  object_capacity=8, device="cpu")
    _assert_state(grown, _snap(built), "make")
    assert grown.n_objects == 8
    exp = jg.session_grow(jg.make_session_state(u, v, 4, pair_capacity=4,
                                                object_capacity=4), 16, 8)
    _assert_state(grown, _snap(exp), "reference")


def test_session_grow_rejects_shrink_and_key_overflow():
    st_ = tg.make_session_state([0], [1], 2, pair_capacity=8,
                                object_capacity=8, device="cpu")
    batch = tg.stack_states([st_, st_])
    for grow, state in ((tg.session_grow, st_),
                        (tg.session_grow_batch, batch)):
        with pytest.raises(ValueError, match="shrink pair"):
            grow(state, 4, 8)
        with pytest.raises(ValueError, match="shrink object"):
            grow(state, 8, 4)
        with pytest.raises(ValueError, match="overflows"):
            grow(state, 8, 3037000500)  # 63-bit keys, as under x64


def _epoch_world(world_builder, seed: int):
    """A random world split into 2-3 epochs (the reference harness's)."""
    rng = np.random.default_rng(seed)
    n, u, v, truth = world_builder(rng)
    k = int(rng.integers(2, 4))
    m = len(u)
    cut = sorted(rng.choice(np.arange(1, m), size=min(k - 1, m - 1),
                            replace=False).tolist())
    bounds = [0, *cut, m]
    epochs = [(u[a:b], v[a:b]) for a, b in zip(bounds, bounds[1:])]
    return n, u, v, truth, epochs, rng


def _noisy_stream_parity(world_builder, seed: int, flip: float = 0.35):
    """Fold-after-grow equals from-scratch ``make_session_state`` on the
    concatenated pairs, conflict counts included, under a noisy replay,
    and every state equals the reference's.  Stage 1 applies noisy answers
    for some epoch-1 pairs to a state holding only epoch 1 and to one built
    with every epoch's pairs; the epoch-1 state then grows and appends the
    other epochs (the two must now agree), and stage 2 folds noisy answers
    for every pending pair through both.  Returns the conflicts counted."""
    n, u, v, truth, epochs, rng = _epoch_world(world_builder, seed)
    m = len(u)
    p_cap, n_cap = 32, 16
    u1, v1 = epochs[0]
    p1 = len(u1)
    cap1 = tg.next_pow2(p1, 8)   # sized from the epoch (ROADMAP R2)
    state = tg.make_session_state(u1, v1, n, pair_capacity=cap1,
                                  object_capacity=n, device="cpu")
    full = tg.make_session_state(u, v, n, pair_capacity=p_cap,
                                 object_capacity=n_cap, device="cpu")
    j_state = jg.make_session_state(u1, v1, n, pair_capacity=cap1,
                                    object_capacity=n)
    j_full = jg.make_session_state(u, v, n, pair_capacity=p_cap,
                                   object_capacity=n_cap)

    def noisy(idx):
        return np.where(rng.random(len(idx)) < flip, NEG + POS - truth[idx],
                        truth[idx]).astype(np.int32)

    take1 = rng.permutation(p1)[:max(p1 // 2, 1)]
    ans1 = noisy(take1)
    upd_small = np.full(cap1, UNKNOWN, np.int32)
    upd_small[take1] = ans1
    upd_full = np.full(p_cap, UNKNOWN, np.int32)
    upd_full[take1] = ans1
    state, cm_s = tg.session_apply_answers(state, upd_small)
    full, cm_f = tg.session_apply_answers(full, upd_full)
    j_state, _ = jg.session_apply_answers(j_state, jnp.asarray(upd_small))
    j_full, _ = jg.session_apply_answers(j_full, jnp.asarray(upd_full))
    np.testing.assert_array_equal(cm_s.numpy()[:p1], cm_f.numpy()[:p1])
    _assert_state(state, _snap(j_state), "stage 1")

    state = tg.session_grow(state, p_cap, n_cap)
    j_state = jg.session_grow(j_state, p_cap, n_cap)
    _assert_state(state, _snap(j_state), "grow")
    off = p1
    for ue, ve in epochs[1:]:
        au = np.zeros(p_cap, np.int32)
        av = np.zeros(p_cap, np.int32)
        mask = np.zeros(p_cap, bool)
        au[off:off + len(ue)] = ue
        av[off:off + len(ue)] = ve
        mask[off:off + len(ue)] = True
        state = tg.session_append_pairs(state, au, av, mask)
        j_state = jg.session_append_pairs(j_state, au, av, mask)
        off += len(ue)
    _assert_state(state, _snap(full), "grown vs built")
    _assert_state(state, _snap(j_state), "append")

    pending = np.nonzero(state.labels.numpy()[:m] == UNKNOWN)[0]
    if len(pending):
        upd = np.full(p_cap, UNKNOWN, np.int32)
        upd[pending] = noisy(pending)
        state, cm_s = tg.session_fold_answers(state, upd)
        full, cm_f = tg.session_fold_answers(full, upd)
        j_state, _ = jg.session_fold_answers(j_state, jnp.asarray(upd))
        np.testing.assert_array_equal(cm_s.numpy(), cm_f.numpy())
    _assert_state(state, _snap(full), "stage 2",
                  ("labels", "roots", "neg_keys", "conflicts", "rounds"))
    _assert_state(state, _snap(j_state), "stage 2 reference")
    return int(state.conflicts.sum())


@pytest.mark.parametrize("seed", range(6))
def test_fold_after_grow_bit_identical(make_random_world, seed):
    _noisy_stream_parity(make_random_world, seed)


def test_fold_after_grow_conflicts_actually_exercised(make_random_world):
    """The seeded runs must include rejected answers, or the conflict-count
    clause is vacuous."""
    assert sum(_noisy_stream_parity(make_random_world, seed)
               for seed in range(6)) > 0


@given(st.integers(0, 10**6))
def test_fold_after_grow_bit_identical_property(make_random_world, seed):
    _noisy_stream_parity(make_random_world, seed)


def test_grow_append_batched_matches_unbatched(make_random_world):
    """The stacked grow / append equal the one-lane forms lane by lane, and
    the reference's stacked ones."""
    worlds = [make_random_world(np.random.default_rng(200 + b))
              for b in range(3)]
    sessions = [(u[:3], v[:3], n) for n, u, v, _ in worlds]
    U, V, labels0, _, n_cap = tg.pack_sessions(sessions)
    batch = tg.make_session_state_batch(U, V, labels0, n_cap, device="cpu")
    batch = tg.session_grow_batch(batch, 16, n_cap + 4)
    AU = np.zeros((3, 16), np.int32)
    AV = np.zeros((3, 16), np.int32)
    AM = np.zeros((3, 16), bool)
    for b, (n, u, v, _) in enumerate(worlds):
        extra = min(len(u) - 3, 4)
        AU[b, 3:3 + extra] = u[3:3 + extra]
        AV[b, 3:3 + extra] = v[3:3 + extra]
        AM[b, 3:3 + extra] = True
    batch = tg.session_append_pairs_batch(batch, AU, AV, AM)
    JU, JV, jl0, _, j_cap = jg.pack_sessions(sessions)
    j_batch = jg.session_append_pairs_batch(
        jg.session_grow_batch(jg.make_session_state_batch(JU, JV, jl0, j_cap),
                              16, j_cap + 4), AU, AV, AM)
    _assert_state(batch, _snap(j_batch), "reference batch")
    for b, (n, u, v, _) in enumerate(worlds):
        one = tg.make_session_state(u[:3], v[:3], n, pair_capacity=3,
                                    object_capacity=n_cap, device="cpu")
        one = tg.session_append_pairs(tg.session_grow(one, 16, n_cap + 4),
                                      AU[b], AV[b], AM[b])
        _assert_state(tg.index_state(batch, b), _snap(one), f"lane {b}",
                      ("u", "v", "labels", "published", "roots", "neg_keys",
                       "conflicts", "priority"))


def _record_growth(monkeypatch) -> list:
    """Record each growth of a served lane: the key dtype before and after,
    and how many real (non-sentinel) neg keys the grown state held."""
    from repro_torch.serve import join_service

    grow = join_service.session_grow
    growths = []

    def rec(state, pair_capacity, object_capacity):
        live = int((state.neg_keys
                    != tg.key_sentinel(state.neg_keys.dtype)).sum())
        out = grow(state, pair_capacity, object_capacity)
        growths.append((state.neg_keys.dtype, out.neg_keys.dtype, live))
        return out

    monkeypatch.setattr(join_service, "session_grow", rec)
    return growths


def _wide_world(seed: int, n0: int, n1: int, p: int):
    """``p`` pairs among 150 objects in 30 clusters (the truth): the first
    ``p // 2`` among 75 objects below ``n0`` (the top one ``n0 - 1``), the
    rest from any object to one of 75 in ``[n0, n1)`` (the top one
    ``n1 - 1``).  Returns (u, v, likelihood, truth, p // 2)."""
    rng = np.random.default_rng(seed)
    lo = np.unique(np.append(rng.choice(n0 - 1, 74, replace=False), n0 - 1))
    hi = np.unique(np.append(rng.choice(np.arange(n0, n1 - 1), 74,
                                        replace=False), n1 - 1))
    objs = np.concatenate([lo, hi])
    cluster = rng.integers(0, 30, len(objs))
    half = p // 2
    a1 = rng.integers(0, len(lo), half)
    b1 = (a1 + 1 + rng.integers(0, len(lo) - 1, half)) % len(lo)
    a2 = rng.integers(0, len(objs), p - half)
    b2 = len(lo) + rng.integers(0, len(hi), p - half)
    same = a2 == b2
    b2[same] = len(lo) + (b2[same] - len(lo) + 1) % len(hi)
    a, b = np.concatenate([a1, a2]), np.concatenate([b1, b2])
    truth = cluster[a] == cluster[b]
    lik = (np.where(truth, 0.8, 0.3) + 0.15 * rng.random(p)).astype(
        np.float32)
    return (objs[a].astype(np.int32), objs[b].astype(np.int32), lik, truth,
            half)


def test_lane_grown_past_46340_widens_keys_against_reference_x64():
    """Two stacked lanes opened at 40000 objects (int32 keys) fold noisy
    answers, grow to 65536 objects and take appended pairs there: the keys
    widen to int64 in the same step that re-keys them, the sentinel is
    int64's max, and every field equals the reference's under x64."""
    n0, n1, P = 40000, 65536, 256
    lanes = []
    for seed in (1, 2):
        u, v, _, truth, h = _wide_world(seed, n0, n1, 240)
        lanes.append((u, v, np.where(truth, POS, NEG).astype(np.int32), h))
    U = np.zeros((2, P), np.int32)
    V = np.zeros((2, P), np.int32)
    L0 = np.full((2, P), POS, np.int32)
    AU, AV, AM = (np.zeros((2, 2 * P), np.int32), np.zeros((2, 2 * P),
                                                          np.int32),
                  np.zeros((2, 2 * P), bool))
    upd = np.full((2, P), UNKNOWN, np.int32)
    rng = np.random.default_rng(5)
    for b, (u, v, truth, h) in enumerate(lanes):
        U[b, :h], V[b, :h], L0[b, :h] = u[:h], v[:h], UNKNOWN
        flip = rng.random(h) < 0.3
        upd[b, :h] = np.where(flip, NEG + POS - truth[:h], truth[:h])
        AU[b, h:len(u)], AV[b, h:len(u)], AM[b, h:len(u)] = u[h:], v[h:], True
    port = tg.make_session_state_batch(U, V, L0, n0, device="cpu")
    port, _ = tg.session_fold_answers_batch(port, upd)
    assert port.neg_keys.dtype == torch.int32
    grown = tg.session_append_pairs_batch(
        tg.session_grow_batch(port, 2 * P, n1), AU, AV, AM)
    assert grown.neg_keys.dtype == torch.int64 and grown.n_objects == n1
    # the sentinel is int64's max: an int32 one would sort as a real key
    assert (grown.neg_keys == torch.iinfo(torch.int64).max).any()
    assert not (grown.neg_keys == torch.iinfo(torch.int32).max).any()
    upd2 = np.full((2, 2 * P), UNKNOWN, np.int32)
    for b, (u, v, truth, h) in enumerate(lanes):
        upd2[b, h:len(u)] = truth[h:]
    folded, _ = tg.session_fold_answers_batch(grown, upd2)
    with jax.enable_x64(True):
        st, _ = jg.session_fold_answers_batch(
            jg.make_session_state_batch(U, V, L0, n0), jnp.asarray(upd))
        j_grown = jg.session_append_pairs_batch(
            jg.session_grow_batch(st, 2 * P, n1), AU, AV, AM)
        exp_grown = _snap(j_grown)
        exp = _snap(jg.session_fold_answers_batch(j_grown,
                                                  jnp.asarray(upd2))[0])
    _assert_state(grown, exp_grown, "grown")
    _assert_state(folded, exp, "folded")
    real = exp["neg_keys"][exp["neg_keys"] < 2 ** 63 - 1]
    assert real.max() >= 2 ** 31
    for b in range(2):
        one = tg.session_append_pairs(
            tg.session_grow(tg.index_state(port, b), 2 * P, n1),
            AU[b], AV[b], AM[b])
        _assert_state(one, {f: x[b] for f, x in exp_grown.items()},
                      f"lane {b}")


@pytest.mark.parametrize("async_mode", [False, True],
                         ids=["barrier", "async"])
def test_stream_grown_past_46340_matches_reference_x64(async_mode,
                                                      monkeypatch):
    """A served lane opened at 32768 objects (int32 keys) whose later epochs
    reach 65535: interleaved, so it grows to int64 keys while its neg-key
    index holds real keys from answers already folded (an interleaved
    stream ingests its second epoch before the first round, so the first
    two stay below 32768 objects); every result field equals the
    reference's under x64, labels the truth."""
    u, v, lik, truth, h = _wide_world(9, 32768, 65536, 300)
    low = PairSet(u[:h], v[:h], lik[:h], truth[:h])
    rest = PairSet(u[h:], v[h:], lik[h:], truth[h:])
    epochs = _split_epochs(low, 2, seed=1) + _split_epochs(rest, 3, seed=1)
    assert max(e.n_objects for e in epochs[:2]) <= 32768
    assert epochs[-1].n_objects <= 65536
    growths = _record_growth(monkeypatch)
    svc = JoinService(lanes=1, async_mode=async_mode, device="cpu")
    rid = svc.submit_stream(epochs, PerfectCrowd(), interleave=True)
    got = svc.run()[rid]
    assert any(old == torch.int32 and new == torch.int64 and live > 0
               for old, new, live in growths), growths
    with jax.enable_x64(True):
        ref_svc = JaxJoinService(lanes=1, async_mode=async_mode)
        ref_rid = ref_svc.submit_stream(
            [JaxPairSet(e.u, e.v, e.likelihood, e.truth) for e in epochs],
            JaxPerfectCrowd(), interleave=True)
        exp = ref_svc.run()[ref_rid]
    assert _fields(got) == _fields(exp)
    np.testing.assert_array_equal(got.labels, np.concatenate(
        [e.truth for e in epochs]))
    assert got.n_rounds > 1


# ---------------------------------------------------------------------------
# machine phase: the incremental candidate index
# ---------------------------------------------------------------------------
def _mixed_corpus():
    rng = np.random.default_rng(7)
    cents = rng.normal(size=(8, 16))
    _, a = _entity_rows(rng, cents, 28)
    _, b = _entity_rows(rng, cents, 22)
    _scores_clear_of(a, b, 0.6)
    epochs = ((a[:10], b[:8]), (a[10:18], None), (None, b[8:15]),
              (a[18:], b[15:]))
    return a, b, epochs


def _maybe(x, wrap):
    return None if x is None else wrap(x)


@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_streaming_candidate_index_matches_batch(blocked):
    """Across mixed arrival epochs every new cell is reported once, the
    union equals one batch call over the final corpora, each epoch's
    candidates and the work counters equal the reference index's, and the
    corpus stays on the index's device as tensors."""
    a, b, epochs = _mixed_corpus()
    cfg = BlockingConfig(**BLOCKING) if blocked else None
    idx = StreamingCandidateIndex(0.6, blocking=cfg, device="cpu")
    ref = JaxIndex(0.6, make_host_mesh(1, 1), impl="interpret",
                   blocking=JaxBlocking(**BLOCKING) if blocked else None)
    got = {}
    for ea, eb in epochs:
        c = idx.append(_maybe(ea, torch.from_numpy),
                       _maybe(eb, torch.from_numpy))
        r = ref.append(_maybe(ea, jnp.asarray), _maybe(eb, jnp.asarray))
        np.testing.assert_array_equal(c.rows, r.rows)
        np.testing.assert_array_equal(c.cols, r.cols)
        np.testing.assert_allclose(c.scores, r.scores, rtol=0,
                                   atol=SCORE_TOL)
        assert c.n_dropped == r.n_dropped == 0
        if blocked:
            assert (c.cells_scored, c.dense_cells, c.n_tiles,
                    c.n_duplicates, c.padded_cells) == (
                r.cells_scored, r.dense_cells, r.n_tiles, r.n_duplicates,
                r.padded_cells)
        for key, s in _candidates(c).items():
            assert key not in got   # each new cell reported exactly once
            got[key] = s
        assert isinstance(idx._a, torch.Tensor) and \
            idx._a.device.type == "cpu"
    full = (blocked_candidates(torch.from_numpy(a), torch.from_numpy(b), 0.6,
                               cfg) if blocked else
            sharded_candidates(torch.from_numpy(a), torch.from_numpy(b), 0.6))
    _assert_candidates(got, _candidates(full))
    assert (idx.pairs_scored, idx.full_rescore_pairs) == (
        ref.pairs_scored, ref.full_rescore_pairs)
    assert idx.pairs_scored < idx.full_rescore_pairs
    assert idx.n_a == 28 and idx.n_b == 22
    if not blocked:
        assert idx.pairs_scored == 28 * 22


@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_streaming_candidate_index_rollback(blocked):
    """A rolled-back epoch leaves the corpus, the cached codes and the
    counters as they were, and the same epoch appended again returns the
    same candidates; there is nothing to roll back twice."""
    a, b, epochs = _mixed_corpus()
    cfg = BlockingConfig(**BLOCKING) if blocked else None
    idx = StreamingCandidateIndex(0.6, blocking=cfg, device="cpu")
    idx.append(torch.from_numpy(a[:10]), torch.from_numpy(b[:8]))
    before = (idx._a, idx._b, idx._codes_a.copy(), idx._codes_b.copy(),
              idx.pairs_scored, idx.full_rescore_pairs)
    first = idx.append(torch.from_numpy(a[10:]), torch.from_numpy(b[8:]))
    idx.rollback_append()
    assert idx._a is before[0] and idx._b is before[1]
    np.testing.assert_array_equal(idx._codes_a, before[2])
    np.testing.assert_array_equal(idx._codes_b, before[3])
    assert (idx.pairs_scored, idx.full_rescore_pairs) == before[4:]
    assert (idx.n_a, idx.n_b) == (10, 8)
    with pytest.raises(RuntimeError, match="no append"):
        idx.rollback_append()
    again = idx.append(torch.from_numpy(a[10:]), torch.from_numpy(b[8:]))
    assert _candidates(again) == _candidates(first)


def test_streaming_candidate_index_refusals():
    with pytest.raises(ValueError, match="threshold"):
        StreamingCandidateIndex(0.0, device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        StreamingCandidateIndex(0.5, mesh=(2, 1), device="cpu")


# ---------------------------------------------------------------------------
# serving: the differential batch-vs-stream harness, against the reference
# ---------------------------------------------------------------------------
def _serve_streams(pairsets, seeds, k, latency=None, interleave=False,
                   crowds=None, stream_opts=None, **svc_kwargs):
    """The same epoch streams through the reference's and the port's
    service; every result field must be identical.  Returns the port's
    results in submission order."""
    crowds = crowds or (lambda i: (JaxPerfectCrowd(), PerfectCrowd()))
    stream_opts = stream_opts or {}
    ref_svc = JaxJoinService(
        latency=None if latency is None else JaxLatencyModel(**latency),
        **svc_kwargs)
    svc = JoinService(
        latency=None if latency is None else LatencyModel(**latency),
        device="cpu", **svc_kwargs)
    ref_rids, rids = [], []
    for i, (ps, seed) in enumerate(zip(pairsets, seeds)):
        ref_crowd, crowd = crowds(i)
        ref_rids.append(ref_svc.submit_stream(
            jax_split_epochs(ps, k, seed=seed), ref_crowd,
            interleave=interleave, **stream_opts))
        rids.append(svc.submit_stream(
            _split_epochs(_port_pairs(ps), k, seed=seed), crowd,
            interleave=interleave, **stream_opts))
    ref, got = ref_svc.run(), svc.run()
    for r_ref, r_got in zip(ref_rids, rids):
        assert _fields(got[r_got]) == _fields(ref[r_ref]), f"rid {r_ref}"
    return [got[r] for r in rids]


@pytest.mark.parametrize("async_mode", [False, True],
                         ids=["barrier", "async"])
@pytest.mark.parametrize("order", ["expected", "adaptive"])
def test_streaming_differential_matches_batch(session_pairsets, async_mode,
                                              order):
    """A 3-epoch up-front ``submit_stream`` equals the reference's stream
    run field for field and the single-shot batch ``submit`` label for
    label, root for root, crowdsourced pair for pair and round for
    round."""
    for seed in (0, 1):
        pairsets = session_pairsets(3, seed=seed)
        streamed = _serve_streams(pairsets, [7, 8, 9], 3, lanes=2,
                                  async_mode=async_mode, order=order)
        svc = JoinService(lanes=2, async_mode=async_mode, order=order,
                          device="cpu")
        rids = [svc.submit(_port_pairs(ps), PerfectCrowd())
                for ps in pairsets]
        batch = svc.run()
        for rid, stream, ps in zip(rids, streamed, pairsets):
            np.testing.assert_array_equal(batch[rid].labels, stream.labels)
            np.testing.assert_array_equal(stream.labels, ps.truth)
            np.testing.assert_array_equal(
                _roots_from_labels(ps, batch[rid].labels),
                _roots_from_labels(ps, stream.labels))
            assert batch[rid].n_crowdsourced == stream.n_crowdsourced
            assert batch[rid].round_sizes == stream.round_sizes


def test_streaming_differential_async_latency_model(session_pairsets):
    """Under the simulated platform (worker pool, lognormal latency, NF
    steering) identical states mean identical gateway calls, so even the
    simulated clock equals the batch run's and the reference's."""
    pairsets = session_pairsets(2, seed=5)
    latency = dict(n_workers=6, seed=3)
    streamed = _serve_streams(pairsets, [0, 1], 3, latency=latency, lanes=2,
                              async_mode=True, nf=True)
    svc = JoinService(lanes=2, async_mode=True, nf=True,
                      latency=LatencyModel(**latency), device="cpu")
    rids = [svc.submit(_port_pairs(ps), PerfectCrowd()) for ps in pairsets]
    batch = svc.run()
    for rid, stream in zip(rids, streamed):
        np.testing.assert_array_equal(batch[rid].labels, stream.labels)
        assert batch[rid].n_crowdsourced == stream.n_crowdsourced
        assert batch[rid].sim_minutes == stream.sim_minutes
        assert stream.sim_minutes is not None


@pytest.mark.parametrize("async_mode", [False, True],
                         ids=["barrier", "async"])
def test_streaming_interleaved_arrivals_match_reference(session_pairsets,
                                                        async_mode):
    """Interleaved epochs land while earlier crowd work is in flight: every
    pair labels to the truth and every field is the reference's."""
    pairsets = session_pairsets(3, seed=3)
    got = _serve_streams(pairsets, [0, 1, 2], 4, interleave=True, lanes=2,
                         async_mode=async_mode)
    for res, ps in zip(got, pairsets):
        np.testing.assert_array_equal(res.labels, ps.truth)
        assert res.n_crowdsourced + res.n_deduced == len(ps)


@pytest.mark.parametrize("async_mode", [False, True],
                         ids=["barrier", "async"])
def test_streaming_budget_carries_over_epochs(session_pairsets, async_mode):
    """A budgeted interleaved stream keeps one spend ledger across every
    epoch: the reference's spend and stop, within the budget."""
    ps = session_pairsets(1, seed=11, n_objects=(20, 24),
                          n_pairs=(50, 60))[0]
    res = _serve_streams([ps], [0], 3, interleave=True, lanes=1,
                         async_mode=async_mode,
                         stream_opts=dict(budget_cents=8.0,
                                          cost_per_assignment=2.0))[0]
    assert res.stopped_on_budget
    assert 0 < res.n_spent_cents <= 8.0
    assert res.n_crowdsourced <= 4


@pytest.mark.parametrize("interleave", [False, True],
                         ids=["upfront", "interleaved"])
@pytest.mark.parametrize("options", [
    {}, {"conflict_policy": "requery"},
    {"aggregation": "em", "cluster_tasks": True, "cluster_size": 6}],
    ids=["drop", "requery", "em-cluster"])
def test_streaming_noisy_crowd_matches_reference(conflicting_pairsets,
                                                 options, interleave):
    """Streams under a noisy crowd (``bench_join_service.py``'s requery
    crowd: a 35% error, unqualified workers): rejected answers, requery
    ladders and cluster-task coverage carry over the epochs; every field is
    the reference's."""
    pairsets = conflicting_pairsets(2, seed=1)
    crowd = dict(error_rate=0.35, qualification=False, seed=10)
    got = _serve_streams(
        pairsets, [3, 4], 3, interleave=interleave, lanes=2,
        crowds=lambda i: (JaxNoisyCrowd(**crowd), NoisyCrowd(**crowd)),
        **options)
    assert sum(r.n_conflicts for r in got) > 0
    if options.get("conflict_policy") == "requery":
        assert sum(r.n_requeried for r in got) > 0
    if options.get("cluster_tasks"):
        assert sum(r.n_cluster_tasks for r in got) > 0


def test_append_validation_and_empty_epochs(session_pairsets):
    ps = _port_pairs(session_pairsets(1, seed=2)[0])
    empty = PairSet(np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.float32), np.zeros(0, bool), n_objects=4)
    svc = JoinService(lanes=1, device="cpu")
    with pytest.raises(ValueError, match="unknown rid"):
        svc.append(99, ps)
    rid = svc.submit(ps, PerfectCrowd())
    svc.append(rid, empty)  # a no-op that must not wedge the run
    res = svc.run()
    np.testing.assert_array_equal(res[rid].labels, ps.truth)
    with pytest.raises(ValueError, match="already finished"):
        svc.append(rid, ps)
    with pytest.raises(ValueError, match="at least one epoch"):
        svc.submit_stream([], PerfectCrowd())


def test_pairset_concat_rejects_mixed_truth():
    a = PairSet(np.array([0], np.int32), np.array([1], np.int32),
                np.array([0.5], np.float32), np.array([True]))
    b = PairSet(np.array([1], np.int32), np.array([2], np.int32),
                np.array([0.5], np.float32), None)
    with pytest.raises(ValueError, match="truth"):
        a.concat(b)
    both = a.concat(a)
    assert len(both) == 2 and both.n_objects == 2
    wide = a.concat(PairSet(np.array([3], np.int32), np.array([9], np.int32),
                            np.array([0.7], np.float32), np.array([False])))
    assert wide.n_objects == 10 and wide.truth.tolist() == [True, False]


# ---------------------------------------------------------------------------
# serving: the incremental machine phase end to end
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_submit_embeddings_overflow_reports_post_growth_capacity(blocked):
    """A streaming submit that overflows rolls back, registers no stream
    and names a capacity that fits."""
    rng = np.random.default_rng(5)
    cents = rng.normal(size=(4, 16))
    ia, ea = _entity_rows(rng, cents, 24, noise=0.1)
    ib, eb = _entity_rows(rng, cents, 20, noise=0.1)
    cfg = BlockingConfig(**BLOCKING) if blocked else None
    svc = JoinService(lanes=1, device="cpu")
    with pytest.raises(RuntimeError,
                       match=r"re-submit with capacity=\d+") as exc:
        svc.submit_embeddings(torch.from_numpy(ea), torch.from_numpy(eb),
                              0.5, capacity=2, blocking=cfg, streaming=True)
    assert not svc._streams and not svc.queue
    cap = int(re.search(r"capacity=(\d+)", str(exc.value)).group(1))
    rid = svc.submit_embeddings(torch.from_numpy(ea), torch.from_numpy(eb),
                                0.5, capacity=cap, blocking=cfg,
                                streaming=True,
                                truth_fn=lambda r, c: ia[r] == ib[c])
    lossless = (blocked_candidates(torch.from_numpy(ea),
                                   torch.from_numpy(eb), 0.5, cfg)
                if blocked else
                sharded_candidates(torch.from_numpy(ea), torch.from_numpy(eb),
                                   0.5))
    assert len(svc.queue[0].pairs) == len(lossless.rows)
    assert svc._streams[rid].index.n_a == 24
    assert svc.run()[rid].quality.precision == 1.0


@pytest.mark.parametrize("async_mode", [False, True],
                         ids=["barrier", "async"])
@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_streaming_embeddings_end_to_end(blocked, async_mode):
    """Machine-phase streaming: the cached index and ``append_embeddings``
    feed the live session; every epoch's queued pairs equal the
    reference's (ids, truth; likelihoods within the score tolerance), the
    appended rows get fresh object ids, ``truth_fn`` sees global rows, and
    the join labels every pair as the reference does."""
    rng = np.random.default_rng(3)
    cents = rng.normal(size=(10, 16))
    ids_a, ea = _entity_rows(rng, cents, 24)
    ids_b, eb = _entity_rows(rng, cents, 20)
    arrivals = [(_entity_rows(rng, cents, 8), _entity_rows(rng, cents, 6))
                for _ in range(2)]
    all_a = np.concatenate([ids_a] + [x[0][0] for x in arrivals])
    all_b = np.concatenate([ids_b] + [x[1][0] for x in arrivals])
    _scores_clear_of(np.concatenate([ea] + [x[0][1] for x in arrivals]),
                     np.concatenate([eb] + [x[1][1] for x in arrivals]), 0.8)
    seen = []

    def truth_fn(r, c):
        seen.append((np.max(r, initial=0), np.max(c, initial=0)))
        return all_a[r] == all_b[c]

    cfg = BlockingConfig(**BLOCKING) if blocked else None
    svc = JoinService(lanes=1, async_mode=async_mode, device="cpu")
    rid = svc.submit_embeddings(torch.from_numpy(ea), torch.from_numpy(eb),
                                0.8, crowd=PerfectCrowd(), truth_fn=truth_fn,
                                blocking=cfg, streaming=True)
    ref_svc = JaxJoinService(lanes=1, async_mode=async_mode)
    ref_rid = ref_svc.submit_embeddings(
        jnp.asarray(ea), jnp.asarray(eb), 0.8, make_host_mesh(1, 1),
        crowd=JaxPerfectCrowd(), truth_fn=lambda r, c: all_a[r] == all_b[c],
        impl="interpret", streaming=True,
        blocking=JaxBlocking(**BLOCKING) if blocked else None)
    for (_, na), (_, nb) in arrivals:
        svc.append_embeddings(rid, torch.from_numpy(na), torch.from_numpy(nb))
        ref_svc.append_embeddings(ref_rid, jnp.asarray(na), jnp.asarray(nb))
    stream = svc._streams[rid]
    assert stream.next_id == 24 + 20 + 2 * 14
    np.testing.assert_array_equal(stream.ids_a,
                                  ref_svc._streams[ref_rid].ids_a)
    np.testing.assert_array_equal(stream.ids_b,
                                  ref_svc._streams[ref_rid].ids_b)
    assert max(r for r, _ in seen) >= 24    # global rows past the first
    epochs = [svc.queue[0].pairs] + list(svc._pending_arrivals[rid])
    ref_epochs = [ref_svc.queue[0].pairs] + list(
        ref_svc._pending_arrivals[ref_rid])
    assert len(epochs) == len(ref_epochs) == 3
    for e, r in zip(epochs, ref_epochs):
        for f in ("u", "v", "truth"):
            np.testing.assert_array_equal(getattr(e, f), getattr(r, f))
        assert e.n_objects == r.n_objects
        np.testing.assert_allclose(e.likelihood, r.likelihood, rtol=0,
                                   atol=SCORE_TOL)
    res, ref = svc.run()[rid], ref_svc.run()[ref_rid]
    np.testing.assert_array_equal(res.labels, ref.labels)
    assert dataclasses.asdict(res.quality) == dataclasses.asdict(ref.quality)
    assert res.quality.precision == 1.0
    assert res.n_deduced > 0
    # the cached index is dropped once the request finalizes
    with pytest.raises(ValueError, match="no cached embedding index"):
        svc.append_embeddings(rid, torch.from_numpy(ea[:1]), None)


@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_append_embeddings_overflow_rolls_back_the_epoch(blocked):
    """A rejected arrival epoch leaves the stream usable: the index forgets
    the failed rows (and their codes), the row -> id maps stay in sync, and
    a smaller retry ingests."""
    rng = np.random.default_rng(13)
    cents = rng.normal(size=(6, 16))
    ia, ea = _entity_rows(rng, cents, 12, noise=0.1)
    ib, eb = _entity_rows(rng, cents, 10, noise=0.1)
    big_ids, big = _entity_rows(rng, cents, 90, noise=0.1)
    small_ids, small = _entity_rows(rng, cents, 3, noise=0.1)
    all_a = np.concatenate([ia, small_ids])
    cfg = (BlockingConfig(n_bits=3, n_tables=6, bn=16, bm=16,
                          tiles_per_call=32) if blocked else None)
    svc = JoinService(lanes=1, device="cpu")
    rid = svc.submit_embeddings(torch.from_numpy(ea), torch.from_numpy(eb),
                                0.5, crowd=PerfectCrowd(),
                                truth_fn=lambda r, c: all_a[r] == ib[c],
                                capacity=128, blocking=cfg, streaming=True)
    stream = svc._streams[rid]
    with pytest.raises(RuntimeError, match="rolled back"):
        svc.append_embeddings(rid, torch.from_numpy(big), None)
    assert stream.index.n_a == len(stream.ids_a) == 12
    assert stream.index._codes_a.shape[1] == (12 if blocked else 0)
    assert rid not in svc._pending_arrivals
    svc.append_embeddings(rid, torch.from_numpy(small), None)
    assert stream.index.n_a == len(stream.ids_a) == 15
    res = svc.run()[rid]
    assert res.quality.precision == 1.0


def test_append_embeddings_requires_streaming_submit():
    rng = np.random.default_rng(9)
    cents = rng.normal(size=(6, 16))
    _, ea = _entity_rows(rng, cents, 12)
    _, eb = _entity_rows(rng, cents, 10)
    svc = JoinService(lanes=1, device="cpu")
    rid = svc.submit_embeddings(torch.from_numpy(ea), torch.from_numpy(eb),
                                0.8, crowd=PerfectCrowd())
    with pytest.raises(ValueError, match="streaming=True"):
        svc.append_embeddings(rid, torch.from_numpy(ea[:2]), None)


def test_streaming_index_never_falls_back(monkeypatch):
    """The index runs where the service runs: the card by default (raising
    without one), and an epoch on a non-CPU device goes to the kernel and
    raises there when it cannot launch, never to the plain version."""
    from repro_torch.kernels.pair_scores import ops as ps_ops

    def no_plain(*args, **kwargs):
        raise AssertionError("a wrapper fell back to its plain version")

    monkeypatch.setattr(ps_ops, "pair_scores_ref", no_plain)
    idx = StreamingCandidateIndex(0.5, device="cpu")
    idx.device = torch.device("meta")
    meta = torch.empty(128, 16, device="meta")
    launches = ps_ops.pair_scores.launches
    with pytest.raises(ValueError, match="CUDA"):
        idx.append(meta, meta)
    assert ps_ops.pair_scores.launches == launches
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingCandidateIndex(0.5)
