"""63-bit pair keys: the port's integer state against the JAX package's
under ``jax.enable_x64(True)`` (its production configuration), on the CPU,
past the 46340 objects where 32-bit keys overflow.

Every reference call runs inside ``jax.enable_x64(True)`` as a context
manager, so the rest of the process keeps x64 off.  Under x64 the
reference's keys are int64 at any size; the port's are int32 while
``n * n < 2**31`` for the state's object capacity and int64 past it, so the
keys are compared as int64 values and every other field dtype for dtype.
n = 50000 needs int64 keys on both sides.  n = 40000 is the band where the
reference's two configurations differ (its 32-bit service keeps
``n_cap = n``, x64 buckets to 65536): there the port follows x64.  The
sessions draw their pairs among 150 objects spread over the whole
id range, so roots, keys and clusters reach the top of it; noisy answers
(each flipped with probability 0.3) make the folds conflict, so the exact
replay runs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PerfectCrowd as JaxPerfectCrowd
from repro.core import jax_graph as jg
from repro.core.pairs import PairSet as JaxPairSet
from repro.serve.join_service import JoinService as JaxJoinService
from repro_torch.convert import (session_state_from_numpy,
                                 session_state_to_numpy)
from repro_torch.core import graph as tg
from repro_torch.core.cluster_graph import NEG, POS, UNKNOWN
from repro_torch.core.crowd import PerfectCrowd
from repro_torch.core.pairs import PairSet
from repro_torch.serve.join_service import JoinService

FIELDS = ("u", "v", "labels", "published", "roots", "neg_keys", "rounds",
          "conflicts", "priority")
P_CAP = 512
FLIP = 0.3


def _snap(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def _jax(snap: dict, n: int):
    return jg.SessionState(**{f: jnp.asarray(snap[f]) for f in FIELDS},
                           n_objects=n)


def _assert_same(got, exp: dict, msg: str = "") -> None:
    """Field for field; neg keys as int64 values (int32 or int64 on the
    port's side, int64 on the reference's), every other dtype equal."""
    got = session_state_to_numpy(got)
    for f in FIELDS:
        g, e = got[f], exp[f]
        if f == "neg_keys":
            assert e.dtype == np.int64 and g.dtype in (np.int32, np.int64)
            g = np.where(g == np.iinfo(g.dtype).max, np.iinfo(np.int64).max,
                         g.astype(np.int64))
        else:
            assert g.dtype == e.dtype, f"{msg} {f} dtype"
        np.testing.assert_array_equal(g, e, err_msg=f"{msg} {f}")


def _world(n: int, seed: int, p: int = 480):
    """p pairs among 150 objects spread over [0, n), the top id among
    them, in 30 clusters; the truth is cluster membership."""
    rng = np.random.default_rng(seed)
    objs = np.unique(np.concatenate([rng.choice(n - 1, 149, replace=False),
                                     [n - 1]]))
    cluster = rng.integers(0, 30, len(objs))
    a = rng.integers(0, len(objs), p)
    b = (a + 1 + rng.integers(0, len(objs) - 1, p)) % len(objs)
    u, v = objs[a].astype(np.int32), objs[b].astype(np.int32)
    truth = np.where(cluster[a] == cluster[b], POS, NEG).astype(np.int32)
    return u, v, truth


def _noisy(rng, truth: np.ndarray) -> np.ndarray:
    flip = rng.random(len(truth)) < FLIP
    return np.where(flip, 1 - truth, truth).astype(np.int32)


@pytest.mark.parametrize("n", [40000, 50000])
def test_canonical_keys_match_reference_under_x64(n):
    rng = np.random.default_rng(n)
    ru = rng.integers(0, n, 4096).astype(np.int32)
    rv = rng.integers(0, n, 4096).astype(np.int32)
    ru[:2], rv[:2] = n - 1, n - 2
    got = tg.canonical_keys(torch.from_numpy(ru), torch.from_numpy(rv), n)
    assert got.dtype == tg.key_dtype(n)
    with jax.enable_x64(True):
        exp = np.asarray(jg.canonical_keys(jnp.asarray(ru), jnp.asarray(rv),
                                           n))
    assert exp.dtype == np.int64
    np.testing.assert_array_equal(got.numpy().astype(np.int64), exp)
    if n > 46340:
        assert exp.max() >= 2 ** 31 and got.dtype == torch.int64
    # an int64 index at a size int32 keys would take: the values are equal
    wide = tg.canonical_keys(torch.from_numpy(ru), torch.from_numpy(rv), n,
                             torch.int64)
    np.testing.assert_array_equal(wide.numpy(), exp)


@pytest.mark.parametrize("n", [40000, 50000])
def test_make_session_state_matches_reference_under_x64(n):
    u, v, _ = _world(n, seed=1)
    got = tg.make_session_state(u, v, n, pair_capacity=P_CAP, device="cpu")
    with jax.enable_x64(True):
        exp = _snap(jg.make_session_state(u, v, n, pair_capacity=P_CAP))
    _assert_same(got, exp, "make")
    assert got.neg_keys.dtype == tg.key_dtype(n)
    assert int(got.neg_keys[0]) == tg.key_sentinel(tg.key_dtype(n))


def _fold_stream(n: int, seed: int, apply_only: bool = False):
    """Noisy answer chunks folded into one session on both sides, the
    states compared after every fold.  Returns the answers rejected."""
    rng = np.random.default_rng(seed)
    u, v, truth = _world(n, seed)
    p = len(u)
    port = tg.make_session_state(u, v, n, pair_capacity=P_CAP, device="cpu")
    with jax.enable_x64(True):
        ref = _snap(jg.make_session_state(u, v, n, pair_capacity=P_CAP))
    rejected = 0
    for step in range(6):
        labels = ref["labels"]
        open_ = np.flatnonzero(labels[:p] == UNKNOWN)
        if not len(open_):
            break
        take = rng.permutation(open_)[:max(1, len(open_) // 3)]
        upd = np.full(P_CAP, UNKNOWN, np.int32)
        upd[take] = _noisy(rng, truth[take])
        fn_t = tg.session_apply_answers if apply_only \
            else tg.session_fold_answers
        port, cmask = fn_t(port, upd)
        with jax.enable_x64(True):
            fn_j = jg.session_apply_answers if apply_only \
                else jg.session_fold_answers
            st, jmask = fn_j(_jax(ref, n), jnp.asarray(upd))
            ref = _snap(st)
            jmask = np.asarray(jmask)
        _assert_same(port, ref, f"fold {step}")
        np.testing.assert_array_equal(cmask.numpy(), jmask)
        rejected += int(jmask.sum())
    assert (ref["neg_keys"] != np.iinfo(np.int64).max).any()
    return rejected


@pytest.mark.parametrize("n", [40000, 50000])
def test_session_fold_answers_matches_reference_under_x64(n):
    """Apply + deduce on noisy chunks: the exact replay's host pass runs on
    keys past 2**31 (no int32 cast) and rejects answers."""
    assert _fold_stream(n, seed=n + 1) > 0


@pytest.mark.parametrize("n", [40000, 50000])
def test_exact_replay_matches_reference_under_x64(n):
    """The apply alone (no deduce), so every rejected answer comes from the
    §9 replay and the later chunks meet an index the replay built."""
    assert _fold_stream(n, seed=n + 2, apply_only=True) > 0


@pytest.mark.parametrize("n", [40000, 50000])
def test_session_run_rounds_matches_reference_under_x64(n):
    u, v, truth = _world(n, seed=n + 3)
    answers = np.full(P_CAP, POS, np.int32)
    answers[:len(u)] = truth
    port = tg.make_session_state(u, v, n, pair_capacity=P_CAP, device="cpu")
    got = tg.session_run_rounds(port, answers, 16)
    with jax.enable_x64(True):
        st = jg.make_session_state(u, v, n, pair_capacity=P_CAP)
        out = jg.session_run_rounds(st, jnp.asarray(answers), 16)
        exp_state, exp_rest = _snap(out[0]), [np.asarray(x) for x in out[1:]]
    _assert_same(got[0], exp_state, "rounds")
    for name, g, e in zip(("crowdsourced", "round_sizes", "rounds_done",
                           "code"), got[1:], exp_rest):
        np.testing.assert_array_equal(g.numpy(), e, err_msg=name)
    assert int(got[3]) > 1 and (got[0].labels[:len(u)] != UNKNOWN).all()


def test_session_grow_across_46340_widens_keys():
    """int32 keys at 40000 objects, int64 once grown to 70000: the index
    re-encoded under the larger universe, value for value the
    reference's."""
    n0, n1 = 40000, 70000
    rng = np.random.default_rng(7)
    u, v, truth = _world(n0, seed=7)
    upd = np.full(P_CAP, UNKNOWN, np.int32)
    upd[:len(u)] = _noisy(rng, truth)
    port, _ = tg.session_fold_answers(
        tg.make_session_state(u, v, n0, pair_capacity=P_CAP, device="cpu"),
        upd)
    assert port.neg_keys.dtype == torch.int32
    grown = tg.session_grow(port, 2 * P_CAP, n1)
    assert grown.neg_keys.dtype == torch.int64 and grown.n_objects == n1
    with jax.enable_x64(True):
        st, _ = jg.session_fold_answers(
            jg.make_session_state(u, v, n0, pair_capacity=P_CAP),
            jnp.asarray(upd))
        exp = _snap(jg.session_grow(st, 2 * P_CAP, n1))
    _assert_same(grown, exp, "grow")
    assert exp["neg_keys"][exp["neg_keys"] < 2 ** 63 - 1].max() >= 2 ** 31


@pytest.mark.parametrize("n", [40000, 50000])
def test_convert_round_trips_int64_keys(n):
    """The reference's int64 index converts in both directions, keeping its
    dtype (int64 even at 40000, where the port's own states use int32), and
    the port's engine folds on it as the reference does."""
    u, v, truth = _world(n, seed=n + 4)
    upd = np.full(P_CAP, UNKNOWN, np.int32)
    upd[:len(u) // 2] = truth[:len(u) // 2]
    with jax.enable_x64(True):
        st, _ = jg.session_fold_answers(
            jg.make_session_state(u, v, n, pair_capacity=P_CAP),
            jnp.asarray(upd))
        snap = _snap(st)
    port = session_state_from_numpy(snap, device="cpu")
    assert port.neg_keys.dtype == torch.int64 and port.n_objects == n
    back = session_state_to_numpy(port)
    for f in FIELDS:
        assert back[f].dtype == snap[f].dtype
        np.testing.assert_array_equal(back[f], snap[f])
    rest = np.full(P_CAP, UNKNOWN, np.int32)
    rest[len(u) // 2:len(u)] = truth[len(u) // 2:]
    got, gmask = tg.session_fold_answers(port, rest)
    with jax.enable_x64(True):
        exp, emask = jg.session_fold_answers(_jax(snap, n), jnp.asarray(rest))
        exp = _snap(exp)
    assert got.neg_keys.dtype == torch.int64
    _assert_same(got, exp, "fold after convert")
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(emask))
    with pytest.raises(ValueError, match="int32 or int64"):
        session_state_from_numpy({**snap, "neg_keys":
                                  snap["neg_keys"].astype(np.float64)},
                                 device="cpu")


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


@pytest.mark.parametrize("fused_rounds", [True, False])
@pytest.mark.parametrize("n", [40000, 50000])
def test_service_serves_past_46340_objects(n, fused_rounds):
    """The probe of ROADMAP C8: a 5-pair session (a triangle of matches
    and two non-matches at the top of the id range) through ``submit`` on
    both service paths, every result field identical to the reference's
    under x64 — where the port used to raise."""
    u = np.array([n - 1, n - 2, n - 1, 0, 5], np.int32)
    v = np.array([n - 2, n - 3, n - 3, n - 1, n - 3], np.int32)
    truth = np.array([True, True, True, False, False])
    lik = np.array([0.9, 0.8, 0.7, 0.4, 0.3], np.float32)
    svc = JoinService(lanes=1, fused_rounds=fused_rounds, device="cpu")
    rid = svc.submit(PairSet(u, v, lik, truth, n), PerfectCrowd())
    got = svc.run()[rid]
    with jax.enable_x64(True):
        ref_svc = JaxJoinService(lanes=1, fused_rounds=fused_rounds)
        ref_rid = ref_svc.submit(JaxPairSet(u, v, lik, truth, n),
                                 JaxPerfectCrowd())
        exp = ref_svc.run()[ref_rid]
    assert _result_fields(got) == _result_fields(exp)
    assert got.quality.precision == 1.0 and got.n_deduced >= 1
