"""The port's per-round engine (``repro_torch.core.graph`` and
``repro_torch.core.ordering``) against the JAX package's, on the CPU.

Every transformation and public wrapper — screen, fast and exact apply, the
§9 sequential replay, deduce, fold, seed, mark-published, trust-graph,
frontier, gains and priority refresh, unbatched and stacked — starts from
the same numpy-seeded state on both sides and must agree field for field:
integers exactly, f32 priorities and gains bit for bit, conflict masks and
screen flags exactly.  The answer streams are noisy (each answer flipped
against a consistent truth with probability 0.35, chunks of one to four
answers or every open pair at once), so the exact replay runs; each stream
test asserts that it rejected answers.  The reference donates its input
states, so every call gets a fresh copy of the snapshot."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st

from repro.core import jax_graph as jg
from repro.core import ordering as jo
from repro_torch.convert import (session_state_from_numpy,
                                 session_state_to_numpy)
from repro_torch.core import graph as tg
from repro_torch.core import ordering as to
from repro_torch.core.cluster_graph import NEG, POS, UNKNOWN

FIELDS = ("u", "v", "labels", "published", "roots", "neg_keys", "rounds",
          "conflicts", "priority")
# one capacity for every session, so the reference compiles each entry
# point once per file
N_CAP, P_CAP, B = 16, 32, 3
FLIP = 0.35


def _snap(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def _jax(snap: dict):
    return jg.SessionState(**{f: jnp.asarray(snap[f]) for f in FIELDS},
                           n_objects=N_CAP)


def _port(snap: dict):
    return session_state_from_numpy(snap, device="cpu")


def _assert_same(got, exp: dict, msg: str = "") -> None:
    got = session_state_to_numpy(got)
    for f in FIELDS:
        assert got[f].dtype == exp[f].dtype, f"{msg} {f} dtype"
        np.testing.assert_array_equal(got[f], exp[f], err_msg=f"{msg} {f}")


def _assert_eq(got, exp, msg: str = "") -> None:
    got = got.numpy()
    exp = np.asarray(exp)
    assert got.dtype == exp.dtype, msg
    np.testing.assert_array_equal(got, exp, err_msg=msg)


def _fresh(world) -> dict:
    n, u, v, _ = world
    return _snap(jg.make_session_state(u, v, n, pair_capacity=P_CAP,
                                       object_capacity=N_CAP))


def _chunk(rng, labels, truth, m):
    """Noisy answers for some still-UNKNOWN real pairs: every one at once
    half the time, else one to four; each flipped with probability FLIP."""
    avail = [int(i) for i in rng.permutation(m) if labels[i] == UNKNOWN]
    upd = np.full(labels.shape, UNKNOWN, np.int32)
    step = len(avail) if rng.random() < 0.5 else int(rng.integers(1, 5))
    for i in avail[:step]:
        upd[i] = truth[i] if rng.random() >= FLIP else 1 - truth[i]
    return upd


def _stream(world, seed: int, keep: bool, max_folds: int = 40) -> int:
    """Fold one noisy stream through both engines, fold by fold, from the
    same state each time; returns the answers the reference rejected."""
    rng = np.random.default_rng(seed)
    _, _, _, truth = world
    m = len(truth)
    snap, rejected = _fresh(world), 0
    for k in range(max_folds):
        if not (snap["labels"][:m] == UNKNOWN).any():
            break
        upd = _chunk(rng, snap["labels"], truth, m)
        exp, ecm = jg.session_fold_answers(_jax(snap), jnp.asarray(upd),
                                           keep)
        got, gcm = tg.session_fold_answers(_port(snap), upd, keep)
        exp = _snap(exp)
        _assert_same(got, exp, f"seed {seed} fold {k}")
        _assert_eq(gcm, ecm, f"seed {seed} fold {k} cmask")
        rejected += int(np.asarray(ecm).sum())
        snap = exp
    return rejected


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("seeds", [range(0, 8), range(8, 16)])
def test_fold_stream_matches_reference(make_random_world, seeds, keep):
    rejected = sum(_stream(make_random_world(np.random.default_rng(s)), s,
                           keep) for s in seeds)
    assert rejected > 0, "no answer was rejected: the replay never ran"


@given(st.integers(0, 10**6))
def test_fold_stream_matches_reference_property(make_random_world, seed):
    _stream(make_random_world(np.random.default_rng(seed)), seed, False)


def test_fold_stream_property_seeds_reject_answers(make_random_world):
    """The property's worlds do exercise the replay: over a spread of its
    seeds the reference rejects answers."""
    rejected = sum(_stream(make_random_world(np.random.default_rng(s)), s,
                           False) for s in range(10**5, 10**5 + 6))
    assert rejected > 0


def _packed(make_random_world, seed: int):
    rng = np.random.default_rng(seed)
    worlds = [make_random_world(rng) for _ in range(B)]
    U, V, labels0, _, _ = jg.pack_sessions(
        [(u, v, n) for n, u, v, _ in worlds], pair_capacity=P_CAP,
        object_capacity=N_CAP)
    return rng, worlds, U, V, labels0


def _batched_stream(make_random_world, seed: int, keep: bool):
    """Stacked noisy streams, one per lane, fold by fold; returns the
    answers rejected and the screens that fired."""
    rng, worlds, U, V, labels0 = _packed(make_random_world, seed)
    snap = _snap(jg.make_session_state_batch(U, V, labels0, N_CAP))
    _assert_same(tg.make_session_state_batch(U, V, labels0, N_CAP,
                                             device="cpu"), snap, "make")
    rejected, flagged = 0, 0
    for k in range(40):
        if not (snap["labels"] == UNKNOWN).any():
            break
        upd = np.stack([_chunk(rng, snap["labels"][b], w[3], len(w[3]))
                        for b, w in enumerate(worlds)])
        exp, ecm = jg.session_fold_answers_batch(_jax(snap),
                                                 jnp.asarray(upd), keep)
        got, gcm = tg.session_fold_answers_batch(_port(snap), upd, keep)
        _, _, flags = tg._fold_fast_flagged_impl(
            _port(snap), torch.from_numpy(upd), keep)
        exp = _snap(exp)
        _assert_same(got, exp, f"seed {seed} fold {k}")
        _assert_eq(gcm, ecm, f"seed {seed} fold {k} cmask")
        rejected += int(np.asarray(ecm).sum())
        flagged += int(flags.sum())
        snap = exp
    return rejected, flagged


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("seeds", [range(0, 4), range(4, 8)])
def test_batched_fold_stream_matches_reference(make_random_world, seeds,
                                               keep):
    rejected, flagged = np.sum([_batched_stream(make_random_world, s, keep)
                                for s in seeds], axis=0)
    assert rejected > 0 and flagged > 0


def test_mixed_batch_equals_each_lane_folded_alone():
    """One lane whose screen fires (two POS answers close a chain across a
    NEG edge), one clean lane: the stacked fold replays only the first, and
    each lane equals the same lane folded alone, and the reference."""
    u = np.array([0, 1, 0, 3], np.int32)
    v = np.array([1, 2, 2, 4], np.int32)
    conflicting = jg.session_from_labels(
        u, v, np.array([UNKNOWN, UNKNOWN, NEG, UNKNOWN], np.int32),
        np.zeros(4, bool), N_CAP)
    clean = jg.session_from_labels(
        u, v, np.array([POS, UNKNOWN, UNKNOWN, UNKNOWN], np.int32),
        np.zeros(4, bool), N_CAP)
    lanes = [_snap(conflicting), _snap(clean)]
    upd = np.array([[POS, POS, UNKNOWN, NEG], [UNKNOWN, NEG, UNKNOWN, POS]],
                   np.int32)
    stacked = {f: np.stack([s[f] for s in lanes]) for f in FIELDS}
    _, _, flags = tg._fold_fast_flagged_impl(
        _port(stacked), torch.from_numpy(upd), False)
    assert flags.tolist() == [True, False]
    got, gcm = tg.session_fold_answers_batch(_port(stacked), upd)
    exp, ecm = jg.session_fold_answers_batch(_jax(stacked), jnp.asarray(upd))
    _assert_same(got, _snap(exp), "batched")
    _assert_eq(gcm, ecm, "batched cmask")
    assert gcm.tolist()[0] == [False, True, False, False]
    for b, snap in enumerate(lanes):
        alone, acm = tg.session_fold_answers(_port(snap), upd[b])
        _assert_same(tg.index_state(got, b), session_state_to_numpy(alone),
                     f"lane {b}")
        _assert_eq(gcm[b], acm.numpy(), f"lane {b} cmask")


def _mid_state(make_random_world, seed: int, batched: bool,
               publish: float = 0.3):
    """A mid-run state on the reference: a few noisy folds, then some open
    pairs marked in flight.  Returns (snapshot, rng, truths)."""
    if batched:
        rng, worlds, U, V, labels0 = _packed(make_random_world, seed)
        snap = _snap(jg.make_session_state_batch(U, V, labels0, N_CAP))
        truths = [w[3] for w in worlds]
        fold = jg.session_fold_answers_batch
    else:
        rng = np.random.default_rng(seed)
        world = make_random_world(rng)
        snap, truths = _fresh(world), [world[3]]
        fold = jg.session_fold_answers
    for _ in range(2):
        labels = snap["labels"].reshape(len(truths), -1)
        upd = np.stack([_chunk(rng, labels[b], t, len(t))
                        for b, t in enumerate(truths)])
        upd = upd if batched else upd[0]
        snap = _snap(fold(_jax(snap), jnp.asarray(upd))[0])
    pub = (rng.random(snap["labels"].shape) < publish) \
        & (snap["labels"] == UNKNOWN)
    mark = jg.session_mark_published_batch if batched else \
        jg.session_mark_published
    return _snap(mark(_jax(snap), jnp.asarray(pub))), rng, truths


def _updates(rng, snap, truths):
    labels = snap["labels"].reshape(len(truths), -1)
    upd = np.stack([_chunk(rng, labels[b], t, len(t))
                    for b, t in enumerate(truths)])
    return upd.reshape(snap["labels"].shape)


@pytest.mark.parametrize("batched", [False, True])
def test_frontier_deduce_publish_and_trust_match_reference(
        make_random_world, batched):
    sfx = "_batch" if batched else ""
    in_flight = 0
    for seed in range(4):
        snap, rng, _ = _mid_state(make_random_world, seed, batched)

        def both(name, *args):
            exp = getattr(jg, name + sfx)(_jax(snap),
                                          *map(jnp.asarray, args))
            got = getattr(tg, name + sfx)(_port(snap), *args)
            return got, exp

        got, exp = both("session_frontier")
        _assert_eq(got, exp, f"seed {seed} frontier")
        got, exp = both("session_deduce")
        _assert_same(got, _snap(exp), f"seed {seed} deduce")
        mask = rng.random(snap["labels"].shape) < 0.4
        got, exp = both("session_mark_published", mask)
        _assert_same(got, _snap(exp), f"seed {seed} mark_published")
        got, exp = both("session_trust_graph", snap["published"] & mask)
        _assert_same(got, _snap(exp), f"seed {seed} trust_graph")
        in_flight += int(snap["published"].sum())
    assert in_flight > 0


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_apply_and_seed_match_reference(make_random_world, batched, keep):
    sfx = "_batch" if batched else ""
    rejected = 0
    for seed in range(6):
        snap, rng, truths = _mid_state(make_random_world, seed, batched,
                                       publish=0.0)
        upd = _updates(rng, snap, truths)
        exp, ecm = getattr(jg, "session_apply_answers" + sfx)(
            _jax(snap), jnp.asarray(upd), keep)
        got, gcm = getattr(tg, "session_apply_answers" + sfx)(
            _port(snap), upd, keep)
        _assert_same(got, _snap(exp), f"apply seed {seed}")
        _assert_eq(gcm, ecm, f"apply seed {seed} cmask")
        rejected += int(np.asarray(ecm).sum())
        exp, ecm = getattr(jg, "session_seed_labels" + sfx)(
            _jax(snap), jnp.asarray(upd))
        got, gcm = getattr(tg, "session_seed_labels" + sfx)(_port(snap), upd)
        _assert_same(got, _snap(exp), f"seed seed {seed}")
        _assert_eq(gcm, ecm, f"seed seed {seed} cmask")
    assert rejected > 0


@pytest.mark.parametrize("keep", [False, True])
def test_fast_flagged_twins_match_reference(make_random_world, keep):
    """The speculative passes, flags included, and on a flagged lane the
    fast (discarded) state too."""
    flagged = 0
    for seed in range(4):
        snap, rng, truths = _mid_state(make_random_world, seed, True,
                                       publish=0.0)
        upd = _updates(rng, snap, truths)
        upd_t = torch.from_numpy(upd)
        pairs = [
            (jg._session_apply_fast_batch_jit(_jax(snap), jnp.asarray(upd),
                                              keep),
             tg._apply_fast_flagged_impl(_port(snap), upd_t, True, keep)),
            (jg._session_fold_fast_batch_jit(_jax(snap), jnp.asarray(upd),
                                             keep),
             tg._fold_fast_flagged_impl(_port(snap), upd_t, keep)),
            (jg._session_seed_fast_batch_jit(_jax(snap), jnp.asarray(upd)),
             tg._seed_labels_fast_flagged_impl(_port(snap), upd_t)),
        ]
        for k, ((es, ecm, ef), (gs, gcm, gf)) in enumerate(pairs):
            _assert_same(gs, _snap(es), f"seed {seed} variant {k}")
            _assert_eq(gcm, ecm, f"seed {seed} variant {k} cmask")
            _assert_eq(gf, ef, f"seed {seed} variant {k} flags")
        flagged += int(np.asarray(pairs[0][0][2]).sum())
    assert flagged > 0


def test_screen_and_sequential_replay_match_reference(make_random_world):
    """The screen's masks, optimistic roots and flag, and the replay's
    labels, roots, neg keys and conflict mask, lane by lane against the
    reference's ``_apply_sequential``."""
    replayed = 0
    for seed in range(6):
        snap, rng, truths = _mid_state(make_random_world, seed, True,
                                       publish=0.0)
        upd = _updates(rng, snap, truths)
        state = _port(snap)
        upd_t = torch.from_numpy(upd)
        got_screen = tg._screen_impl(state, upd_t)
        lanes = np.ones(B, bool)
        got_seq = tg._apply_sequential(state, upd_t, got_screen[0], lanes)
        for b in range(B):
            lane = {f: snap[f][b] for f in FIELDS}
            exp_screen = jg._screen_impl(_jax(lane), jnp.asarray(upd[b]))
            for g, e in zip(got_screen, exp_screen):
                _assert_eq(g[b], e, f"seed {seed} lane {b} screen")
            exp_seq = jg._apply_sequential(_jax(lane), jnp.asarray(upd[b]),
                                           exp_screen[0])
            for g, e in zip(got_seq, exp_seq):
                _assert_eq(g[b], e, f"seed {seed} lane {b} replay")
            replayed += int(np.asarray(exp_seq[3]).sum())
    assert replayed > 0


@pytest.mark.parametrize("count_round", [False, True])
@pytest.mark.parametrize("keep", [False, True])
def test_finish_apply_matches_reference(make_random_world, count_round,
                                        keep):
    snap, rng, truths = _mid_state(make_random_world, 5, False, publish=0.5)
    upd = _updates(rng, snap, truths)
    new = (upd != UNKNOWN) & (snap["labels"] == UNKNOWN)
    cmask = new & (rng.random(new.shape) < 0.5)
    labels = np.where(new & ~cmask, upd, snap["labels"]).astype(np.int32)
    exp = jg._finish_apply(_jax(snap), jnp.asarray(labels),
                           jnp.asarray(snap["roots"]),
                           jnp.asarray(snap["neg_keys"]), jnp.asarray(cmask),
                           jnp.asarray(new), count_round, keep)
    one = tg.stack_states([_port(snap)])
    got = tg._finish_apply(one, *(torch.tensor(x)[None] for x in (
        labels, snap["roots"], snap["neg_keys"], cmask, new)), count_round,
        keep)
    _assert_same(tg.index_state(got, 0), _snap(exp))


def test_session_from_labels_matches_reference(make_random_world):
    for seed in range(4):
        rng = np.random.default_rng(seed)
        n, u, v, truth = make_random_world(rng)
        labels = np.where(rng.random(len(u)) < 0.6, truth, UNKNOWN)
        published = rng.random(len(u)) < 0.3
        exp = jg.session_from_labels(u, v, labels.astype(np.int32),
                                     published, N_CAP)
        got = tg.session_from_labels(u, v, labels, published, N_CAP,
                                     device="cpu")
        _assert_same(got, _snap(exp), f"seed {seed}")


def _chain_across_neg_edge():
    """Two POS answers that close a chain across a NEG edge: the screen
    must fire in the first round."""
    snap = _snap(jg.session_from_labels(
        np.array([0, 1, 0], np.int32), np.array([1, 2, 2], np.int32),
        np.array([UNKNOWN, UNKNOWN, NEG], np.int32), np.zeros(3, bool),
        N_CAP))
    return snap, np.array([POS, POS, UNKNOWN], np.int32)


@pytest.mark.parametrize("consistent", [True, False])
@pytest.mark.parametrize("adaptive", [False, True])
def test_run_rounds_unbatched_matches_reference(make_random_world,
                                                consistent, adaptive):
    cases = []
    for seed in range(5):
        rng = np.random.default_rng(seed)
        world = make_random_world(rng)
        m = len(world[3])
        answers = np.full(P_CAP, UNKNOWN, np.int32)
        answers[:m] = world[3] if consistent else \
            np.where(rng.random(m) < 0.5, POS, NEG)
        cases.append((_fresh(world), answers))
    if not consistent:
        cases.append(_chain_across_neg_edge())
    codes = set()
    for k, (snap, answers) in enumerate(cases):
        prior = np.random.default_rng(k).random(answers.shape).astype(
            np.float32)
        exp = jg.session_run_rounds(_jax(snap), answers, 4, prior=prior,
                                    adaptive=adaptive)
        got = tg.session_run_rounds(_port(snap), answers, 4, prior=prior,
                                    adaptive=adaptive)
        _assert_same(got[0], _snap(exp[0]), f"case {k}")
        for name, g, e in zip(("crowd", "sizes", "rounds", "code"), got[1:],
                              exp[1:]):
            _assert_eq(g, e, f"case {k} {name}")
        codes.add(int(exp[4]))
    assert (jg.ROUNDS_CONFLICT in codes) == (not consistent)


@pytest.mark.parametrize("batched", [False, True])
def test_gains_and_refresh_match_reference_bitwise(make_random_world,
                                                   batched):
    """Pure f32 mul/div: gains and refreshed priorities bit for bit, on
    states with neg keys (so the damping is not 1) and pairs in flight."""
    for seed in range(4):
        snap, rng, _ = _mid_state(make_random_world, seed, batched)
        prior = rng.random(snap["labels"].shape).astype(np.float32)
        if batched:
            enable = np.array([True, False, True])
            exp_g = jo.session_gains_batch(_jax(snap), jnp.asarray(prior))
            got_g = to.session_gains_batch(_port(snap), prior)
            exp = jo.session_refresh_priorities_batch(
                _jax(snap), jnp.asarray(prior), enable)
            got = to.session_refresh_priorities_batch(_port(snap), prior,
                                                      enable)
        else:
            exp_g = jo.session_gains(_jax(snap), jnp.asarray(prior))
            got_g = to.session_gains(_port(snap), prior)
            exp = jo.session_refresh_priorities(_jax(snap),
                                                jnp.asarray(prior))
            got = to.session_refresh_priorities(_port(snap), prior)
        _assert_eq(got_g, exp_g, f"seed {seed} gains")
        _assert_same(got, _snap(exp), f"seed {seed} refresh")
        assert (np.asarray(exp_g) != np.clip(prior, 1e-4, 1 - 1e-4)).any()
