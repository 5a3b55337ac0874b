"""The port's ``JoinService`` against the JAX package's, on the CPU: the same
sessions through ``submit`` (the fused round engine under a
``PerfectCrowd``; the per-round engine under a ``NoisyCrowd``, with
``fused_rounds=False``, after a fused lane's conflict screen fires, and with
``seed_labels``) and the same embeddings through ``submit_embeddings`` must
give every ``JoinSessionResult`` field identical (the wall clock aside).
Also the port's refusal surface: unknown keywords are a ``TypeError``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Crowd as JaxCrowd
from repro.core import NoisyCrowd as JaxNoisyCrowd
from repro.core import PerfectCrowd as JaxPerfectCrowd
from repro.data.entities import make_session_pairsets
from repro.launch.mesh import make_host_mesh
from repro.serve.join_service import JoinService as JaxJoinService
from repro_torch.core.cluster_graph import NEG, POS, UNKNOWN
from repro_torch.core.crowd import Crowd, NoisyCrowd, PerfectCrowd
from repro_torch.core.pairs import PairSet
from repro_torch.serve.join_service import JoinService

ULP_ONE = 2.0 ** -23


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


def _assert_same_results(ref: dict, got: dict, ref_rids, rids) -> None:
    for r_ref, r_got in zip(ref_rids, rids):
        assert _fields(got[r_got]) == _fields(ref[r_ref]), f"rid {r_ref}"


@pytest.mark.parametrize("order", ["expected", "adaptive", "optimal",
                                   "worst"])
def test_submit_matches_reference(order):
    """Five entity-clustered sessions through two lanes: three waves, so
    lane refill and queue provenance are exercised too."""
    pairsets = make_session_pairsets(5, seed=3, n_objects=(20, 40),
                                     n_pairs=(40, 120))
    ref_svc = JaxJoinService(lanes=2, order=order)
    ref_rids = [ref_svc.submit(ps, JaxPerfectCrowd()) for ps in pairsets]
    ref = ref_svc.run()
    svc = JoinService(lanes=2, order=order, device="cpu")
    rids = [svc.submit(_port_pairs(ps), PerfectCrowd()) for ps in pairsets]
    got = svc.run()
    _assert_same_results(ref, got, ref_rids, rids)
    assert any(r.admission_deferred for r in got.values())
    assert sum(r.n_deduced for r in got.values()) > 0


@pytest.mark.parametrize("seed", [3, 4])
def test_submit_embeddings_matches_reference(seed):
    """Machine phase + serving end to end, the reference's kernel in
    interpret mode.  The candidate sets must be identical and the scores
    within 4 ulp of 1.0 (see tests/test_torch_pair_scores.py); no score may
    lie within that tolerance of the threshold or of another score, so the
    labeling order cannot flip and the results must be identical."""
    rng = np.random.default_rng(seed)
    n_ent, tau, tol = 12, 0.8, 4 * ULP_ONE
    cents = rng.normal(size=(n_ent, 16))
    ia = rng.integers(0, n_ent, 40)
    ib = rng.integers(0, n_ent, 35)
    ea = (cents[ia] + 0.15 * rng.normal(size=(40, 16))).astype(np.float32)
    eb = (cents[ib] + 0.15 * rng.normal(size=(35, 16))).astype(np.float32)

    def truth(r, c):
        return ia[r] == ib[c]

    ref_svc = JaxJoinService(lanes=2)
    ref_rid = ref_svc.submit_embeddings(
        jnp.asarray(ea), jnp.asarray(eb), tau, make_host_mesh(1, 1),
        crowd=JaxPerfectCrowd(), truth_fn=truth, impl="interpret",
        total_true_matches=int((ia[:, None] == ib[None, :]).sum()))
    svc = JoinService(lanes=2, device="cpu")
    rid = svc.submit_embeddings(
        torch.from_numpy(ea), torch.from_numpy(eb), tau,
        crowd=PerfectCrowd(), truth_fn=truth,
        total_true_matches=int((ia[:, None] == ib[None, :]).sum()))
    ref_pairs, pairs = ref_svc.queue[0].pairs, svc.queue[0].pairs
    np.testing.assert_array_equal(pairs.u, ref_pairs.u)
    np.testing.assert_array_equal(pairs.v, ref_pairs.v)
    np.testing.assert_array_equal(pairs.truth, ref_pairs.truth)
    ref_scores = 2.0 * ref_pairs.likelihood - 1.0
    np.testing.assert_allclose(2.0 * pairs.likelihood - 1.0, ref_scores,
                               rtol=0, atol=tol + ULP_ONE)
    # no score within 4 ulp of the threshold or of another score, and the
    # labeling orders agree, so the sessions are the same problem
    ranked = np.sort(ref_scores)
    assert (np.abs(ref_scores - tau) > 4 * np.spacing(np.float32(tau))).all()
    assert (np.diff(ranked) > 4 * np.spacing(ranked[1:])).all()
    np.testing.assert_array_equal(
        np.argsort(-pairs.likelihood, kind="stable"),
        np.argsort(-ref_pairs.likelihood, kind="stable"))
    got, ref = svc.run(), ref_svc.run()
    _assert_same_results(ref, got, [ref_rid], [rid])
    assert got[rid].quality.precision == 1.0 and got[rid].n_deduced > 0


def test_zero_pair_request_is_born_done():
    svc = JoinService(device="cpu")
    rid = svc.submit(PairSet(np.zeros(0), np.zeros(0), np.zeros(0),
                             np.zeros(0, bool), n_objects=3))
    res = svc.run()[rid]
    assert res.n_crowdsourced == res.n_deduced == res.n_rounds == 0


def test_duplicate_rid_and_overflow_are_reported():
    svc = JoinService(device="cpu")
    ps = _port_pairs(make_session_pairsets(1, seed=0)[0])
    svc.submit(ps, rid=7)
    with pytest.raises(ValueError, match="duplicate"):
        svc.submit(ps, rid=7)
    emb = torch.eye(8)[:, :4].repeat(2, 1)
    with pytest.raises(RuntimeError, match="capacity=16"):
        svc.submit_embeddings(emb, emb, 0.5, capacity=10,
                              truth_fn=lambda r, c: r == c)


def test_submit_embeddings_unknown_keyword_is_a_type_error():
    """``submit_embeddings`` takes every keyword of the reference's that is
    ported (``streaming`` among them) and no other: a keyword neither
    package has is a ``TypeError`` and queues nothing."""
    svc = JoinService(device="cpu")
    emb = torch.ones(4, 8)
    with pytest.raises(TypeError, match="stream_mode"):
        svc.submit_embeddings(emb, emb, 0.5, stream_mode=True)
    assert not svc.queue


def test_submit_embeddings_refuses_seed_labels():
    """Seeds reach ``submit_embeddings`` only through a cluster cache, as
    in the reference, which has no such keyword."""
    svc = JoinService(device="cpu")
    with pytest.raises(TypeError, match="seed_labels"):
        svc.submit_embeddings(torch.ones(4, 8), torch.ones(4, 8), 0.5,
                              seed_labels=np.zeros(3, np.int32))
    assert not svc.queue


def test_unknown_options_and_stateful_crowds_are_refused():
    """Unknown keywords are a TypeError.  A crowd that cannot answer is
    admitted, as in the reference, and the run raises when it is asked:
    ``NotImplementedError`` from the interface, and for a ``PerfectCrowd``
    without ground truth a ``ValueError`` (the reference's ``assert``)."""
    with pytest.raises(TypeError, match="impl"):
        JoinService(device="cpu", impl="auto")
    svc = JoinService(device="cpu")
    ps = _port_pairs(make_session_pairsets(1, seed=0)[0])
    with pytest.raises(TypeError, match="impl"):
        svc.submit_embeddings(torch.ones(4, 8), torch.ones(4, 8), 0.5,
                              impl="auto")
    ref_ps = make_session_pairsets(1, seed=0)[0]
    for crowd, ref_crowd, port_error, ref_error in (
            (Crowd(), JaxCrowd(), NotImplementedError, NotImplementedError),
            (PerfectCrowd(), JaxPerfectCrowd(), ValueError, AssertionError)):
        truthless = PairSet(ps.u, ps.v, ps.likelihood)
        svc = JoinService(device="cpu")
        svc.submit(truthless, crowd=crowd)
        with pytest.raises(port_error):
            svc.run()
        ref_svc = JaxJoinService()
        ref_svc.submit(type(ref_ps)(ref_ps.u, ref_ps.v, ref_ps.likelihood),
                       crowd=ref_crowd)
        with pytest.raises(ref_error):
            ref_svc.run()


def _noisy(k: int, error_rate: float = 0.35, **kwargs):
    kw = dict(error_rate=error_rate, qualification=False, seed=10 + k,
              **kwargs)
    return JaxNoisyCrowd(**kw), NoisyCrowd(**kw)


def _serve_both(pairsets, crowds, **svc_kwargs):
    """The same sessions through the reference's and the port's service;
    returns (reference results, port results) in submission order."""
    ref_svc = JaxJoinService(**svc_kwargs)
    svc = JoinService(device="cpu", **svc_kwargs)
    ref_rids, rids = [], []
    for ps, (ref_crowd, crowd), extra in crowds(pairsets):
        ref_rids.append(ref_svc.submit(ps, ref_crowd, **extra))
        rids.append(svc.submit(_port_pairs(ps), crowd, **extra))
    ref, got = ref_svc.run(), svc.run()
    _assert_same_results(ref, got, ref_rids, rids)
    return [ref[r] for r in ref_rids], [got[r] for r in rids]


@pytest.mark.parametrize("fused_rounds", [False, True])
@pytest.mark.parametrize("order", ["expected", "adaptive"])
def test_noisy_crowd_matches_reference(conflicting_pairsets, order,
                                       fused_rounds):
    """Three noisy sessions through three lanes, round by round: ballots
    drawn in the same order from the same seeds, the same answers rejected
    by the §9 screen and its exact replay.  A service with fused rounds on
    serves them the same way: their answers depend on the order asked."""
    _, got = _serve_both(
        conflicting_pairsets(),
        lambda pss: [(ps, _noisy(k), {}) for k, ps in enumerate(pss)],
        lanes=3, order=order, fused_rounds=fused_rounds)
    assert sum(r.n_conflicts for r in got) > 0
    assert all(r.n_spent_cents == 3 * 2.0 * r.n_crowdsourced for r in got)


def test_one_noisy_crowd_shared_by_every_lane_matches_reference(
        conflicting_pairsets):
    """One crowd answers all three lanes, so its draws interleave across
    them: each round's ballots must be drawn lane by lane in stage order,
    pair indices ascending, as the reference posts them."""
    shared = _noisy(0)
    _, got = _serve_both(
        conflicting_pairsets(),
        lambda pss: [(ps, shared, {}) for ps in pss], lanes=3)
    assert shared[1].n_asked == sum(r.n_crowdsourced for r in got)
    assert all(r.n_rounds > 1 for r in got)


def test_noisy_worker_pool_beside_a_perfect_crowd_matches_reference(
        conflicting_pairsets):
    """A heterogeneous worker pool (the chip's phase 4e crowd) in two
    lanes beside a ``PerfectCrowd`` lane: no lane can fuse."""
    def crowds(pss):
        out = [(ps, _noisy(k, 0.3, n_workers=25, worker_concentration=3.0),
                {}) for k, ps in enumerate(pss[:2])]
        return out + [(pss[2], (JaxPerfectCrowd(), PerfectCrowd()), {})]

    _, got = _serve_both(conflicting_pairsets(), crowds, lanes=2)
    assert sum(r.n_conflicts for r in got) > 0
    assert got[2].n_conflicts == 0 and got[2].quality.precision == 1.0


def test_fused_lane_whose_screen_fires_is_replayed(monkeypatch):
    """A ``PerfectCrowd`` over truth that contradicts itself: the fused
    wave's §9 screen fires, the lane leaves the fused path and replays the
    round exactly through ``_step``, as the reference does."""
    pairsets = make_session_pairsets(3, seed=5, n_objects=(20, 30),
                                     n_pairs=(80, 140))
    rng = np.random.default_rng(5)
    for ps in pairsets:
        ps.truth = rng.random(len(ps)) < 0.45
    steps = []
    step = JoinService._step
    monkeypatch.setattr(JoinService, "_step",
                        lambda self, *a: steps.append(1) or step(self, *a))
    _, got = _serve_both(
        pairsets, lambda pss: [(ps, (JaxPerfectCrowd(), PerfectCrowd()), {})
                               for ps in pss], lanes=2)
    assert steps and sum(r.n_conflicts for r in got) > 0


@pytest.mark.parametrize("fused_rounds", [True, False])
def test_fused_rounds_false_serves_as_the_fused_path(fused_rounds):
    """``fused_rounds=False`` is served (it was refused before the per-round
    engine): under a ``PerfectCrowd`` every field equals the reference's
    and the fused path's."""
    pairsets = make_session_pairsets(4, seed=3, n_objects=(20, 40),
                                     n_pairs=(40, 120))

    def crowds(pss):
        return [(ps, (JaxPerfectCrowd(), PerfectCrowd()), {}) for ps in pss]

    _, got = _serve_both(pairsets, crowds, lanes=2,
                         fused_rounds=fused_rounds)
    _, fused = _serve_both(pairsets, crowds, lanes=2)
    for a, b in zip(got, fused):
        assert _fields(a) == _fields(b)


@pytest.mark.parametrize("fused_rounds", [True, False])
def test_seed_labels_match_reference(conflicting_pairsets, fused_rounds):
    """Seeds from the truth, a tenth of them flipped so the seed fold's
    screen fires and rejects some: pairs settled at lane open are neither
    posted nor billed, and ``n_cache_hits`` counts the accepted seeds."""
    rng = np.random.default_rng(2)

    def crowds(pss):
        out = []
        for k, ps in enumerate(pss):
            seeds = np.where(ps.truth, POS, NEG).astype(np.int32)
            seeds = np.where(rng.random(len(ps)) < 0.1, 1 - seeds, seeds)
            seeds[rng.random(len(ps)) < 0.6] = UNKNOWN
            crowd = (_noisy(k) if k == 2 else
                     (JaxPerfectCrowd(), PerfectCrowd()))
            out.append((ps, crowd, {"seed_labels": seeds}))
        return out

    _, got = _serve_both(conflicting_pairsets(), crowds, lanes=2,
                         fused_rounds=fused_rounds)
    assert all(r.n_cache_hits > 0 for r in got)
    assert sum(r.n_conflicts for r in got) > 0
    svc = JoinService(device="cpu")
    with pytest.raises(ValueError, match="seed_labels length"):
        svc.submit(_port_pairs(conflicting_pairsets()[0]),
                   seed_labels=np.zeros(3, np.int32))
