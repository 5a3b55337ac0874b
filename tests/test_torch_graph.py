"""The port's round engine (``repro_torch.core.graph``) against the JAX
package's ``session_run_rounds_batch``: both start from the same mid-run
stacked state, carried across with ``repro_torch.convert``, and must agree
bit for bit in every ``SessionState`` field, the crowdsourced masks, the
round sizes, the rounds done and the exit codes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_graph as jg
from repro_torch.convert import (session_state_from_numpy,
                                 session_state_to_numpy)
from repro_torch.core import graph as tg
from repro_torch.core.cluster_graph import NEG, POS, UNKNOWN

FIELDS = ("u", "v", "labels", "published", "roots", "neg_keys", "rounds",
          "conflicts", "priority")
B, N_OBJ, P_CAP = 3, 16, 32


def _snap(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def _assert_fields_equal(got: dict, exp: dict, msg: str) -> None:
    for f in FIELDS:
        assert got[f].dtype == exp[f].dtype, f"{msg} {f} dtype"
        np.testing.assert_array_equal(got[f], exp[f], err_msg=f"{msg} {f}")


def _sessions(rng, consistent=True):
    """B sessions of fixed capacity: random pairs, answers from a random
    partition (a perfect crowd) or, when not ``consistent``, random answers
    that contradict each other, and random machine priors."""
    us, vs, answers, priors = [], [], [], []
    for _ in range(B):
        n = int(rng.integers(6, N_OBJ + 1))
        p = int(rng.integers(8, P_CAP + 1))
        u = rng.integers(0, n, p).astype(np.int32)
        v = ((u + 1 + rng.integers(0, n - 1, p)) % n).astype(np.int32)
        cluster = rng.integers(0, max(2, n // 3), n)
        truth = np.where(cluster[u] == cluster[v], POS, NEG)
        if not consistent:
            truth = np.where(rng.random(p) < 0.5, POS, NEG)
        ans = np.full(P_CAP, UNKNOWN, np.int32)
        ans[:p] = truth
        prior = np.zeros(P_CAP, np.float32)
        prior[:p] = rng.random(p)
        us.append(u)
        vs.append(v)
        answers.append(ans)
        priors.append(prior)
    jstates = [jg.make_session_state(u, v, N_OBJ, pair_capacity=P_CAP,
                                     object_capacity=N_OBJ)
               for u, v in zip(us, vs)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jstates)
    return stacked, np.stack(answers), np.stack(priors)


def _check(seed, warm_rounds, max_rounds, consistent=True, publish=0.0,
           full_rounds=False):
    rng = np.random.default_rng(seed)
    jstate, answers, prior = _sessions(rng, consistent)
    adaptive = rng.random(B) < 0.5
    if warm_rounds:
        # a mid-run state: the reference advances the lanes a little first
        jstate = jg.session_run_rounds_batch(
            jstate, answers, warm_rounds, prior=prior, adaptive=adaptive)[0]
    if publish:
        jstate = jg.session_mark_published_batch(
            jstate, jnp.asarray(rng.random((B, P_CAP)) < publish))
    start = _snap(jstate)
    rounds_allowed = rng.integers(0, max_rounds + 1, B).astype(np.int32)
    if full_rounds:
        rounds_allowed[:] = max_rounds
    tstate = session_state_from_numpy(start, device="cpu")
    _assert_fields_equal(session_state_to_numpy(tstate), start, "convert")
    exp = jg.session_run_rounds_batch(jstate, answers, max_rounds,
                                      prior=prior, adaptive=adaptive,
                                      rounds_allowed=rounds_allowed)
    got = tg.session_run_rounds_batch(tstate, answers, max_rounds,
                                      prior=prior, adaptive=adaptive,
                                      rounds_allowed=rounds_allowed)
    msg = f"seed={seed} warm={warm_rounds} k={max_rounds}"
    _assert_fields_equal(session_state_to_numpy(got[0]), _snap(exp[0]), msg)
    for name, g, e in zip(("crowdsourced", "round_sizes", "rounds_done",
                           "code"), got[1:], exp[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e),
                                      err_msg=f"{msg} {name}")
    return np.asarray(exp[4])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("warm_rounds,max_rounds", [(0, 4), (1, 1), (2, 4)])
def test_run_rounds_batch_matches_reference(seed, warm_rounds, max_rounds):
    _check(seed, warm_rounds, max_rounds)


@pytest.mark.parametrize("seed", [1, 2, 5, 7])
def test_run_rounds_batch_conflicts_match_reference(seed):
    """Contradictory answers fire the §9 screen: the lane exits CONFLICT
    with its pre-fold state, exactly as the reference's does.  (A frontier
    is a forest, so random answers conflict only when one Borůvka round's
    winners join neg-adjacent clusters; these seeds are ones where that
    happens.)"""
    codes = _check(seed, 0, 4, consistent=False, full_rounds=True)
    assert (codes == jg.ROUNDS_CONFLICT).any()


@pytest.mark.parametrize("seed", range(3))
def test_run_rounds_batch_with_published_pairs_matches_reference(seed):
    """In-flight pairs are hooked into the frontier as assumed-matching and
    skipped by the deduce sweep."""
    _check(seed, 1, 4, publish=0.3)


def test_make_session_state_and_grow_match_reference():
    rng = np.random.default_rng(5)
    u = rng.integers(0, 11, 19).astype(np.int32)
    v = ((u + 1 + rng.integers(0, 10, 19)) % 11).astype(np.int32)
    jstate = jg.make_session_state(u, v, 11, pair_capacity=24,
                                   object_capacity=16)
    tstate = tg.make_session_state(u, v, 11, pair_capacity=24,
                                   object_capacity=16, device="cpu")
    _assert_fields_equal(session_state_to_numpy(tstate), _snap(jstate),
                         "make")
    # grow a state that carries labels, a merged forest and neg keys
    answers = np.where(rng.random(24) < 0.5, POS, NEG).astype(np.int32)
    jmid = jg.session_run_rounds(jstate, answers, 2)[0]
    tmid = session_state_from_numpy(_snap(jmid), device="cpu")
    _assert_fields_equal(
        session_state_to_numpy(tg.session_grow(tmid, 64, 32)),
        _snap(jg.session_grow(jmid, 64, 32)), "grow")


def test_key_guards():
    """63 usable key bits, as the reference has under x64 (its production
    configuration); int32 keys while n * n < 2**31, int64 past it."""
    with jax.enable_x64(True):
        assert tg.pair_key_bits() == jg.pair_key_bits() == 63
        for n in (46340, 46341, 3037000499, 3037000500):
            assert tg.pair_keys_fit(n) == jg.pair_keys_fit(n)
    assert tg.pair_keys_fit(3037000499) and not tg.pair_keys_fit(3037000500)
    assert tg.key_dtype(46340) == torch.int32
    assert tg.key_dtype(46341) == torch.int64
    assert tg.key_sentinel(torch.int64) == 2 ** 63 - 1
    assert [tg.next_pow2(n, 8) for n in (0, 8, 9, 1000)] == \
        [jg.next_pow2(n, 8) for n in (0, 8, 9, 1000)]
    with pytest.raises(ValueError, match="overflows"):
        tg.session_grow(tg.make_session_state([0], [1], 2, device="cpu"),
                        4, 3037000500)
