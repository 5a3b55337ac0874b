"""The port's ``JoinService`` against the JAX package's, on the CPU: the same
sessions through ``submit`` (the fused round engine under a
``PerfectCrowd``) and the same embeddings through ``submit_embeddings`` must
give every ``JoinSessionResult`` field identical (the wall clock aside).
Also the port's refusal surface: every option it does not implement raises
``NotImplementedError`` naming its ROADMAP item."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PerfectCrowd as JaxPerfectCrowd
from repro.data.entities import make_session_pairsets
from repro.launch.mesh import make_host_mesh
from repro.serve.join_service import JoinService as JaxJoinService
from repro_torch.core.crowd import Crowd, PerfectCrowd
from repro_torch.core.pairs import PairSet
from repro_torch.serve.join_service import (_EMBEDDING_OPTIONS,
                                            _SERVICE_OPTIONS, _SUBMIT_OPTIONS,
                                            JoinService)

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


# a value each unported option could take in the reference
UNPORTED_VALUES = {
    "latency": "lognormal", "async_mode": True, "nf": True,
    "budget_cents": 10.0, "cost_per_assignment": 1.0, "slots_per_round": 4,
    "conflict_policy": "requery", "fused_rounds": False, "aggregation": "em",
    "cluster_tasks": True, "cluster_size": 4, "cluster_assignments": 3,
    "admission": "policy", "checkpoint_dir": "ckpt", "checkpoint_every": 2,
    "checkpoint_keep": 1, "cluster_cache": "cache", "cache_path": "c.json",
    "seed_labels": np.zeros(3, np.int32), "streaming": True}


def _unported(table):
    return [(name, UNPORTED_VALUES[name]) for name in table]


@pytest.mark.parametrize("name,value", _unported(_SERVICE_OPTIONS))
def test_service_options_not_ported_raise(name, value):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        JoinService(device="cpu", **{name: value})
    JoinService(device="cpu", **{name: _SERVICE_OPTIONS[name][0]})


@pytest.mark.parametrize("name,value", _unported(_EMBEDDING_OPTIONS))
def test_submit_options_not_ported_raise(name, value):
    svc = JoinService(device="cpu")
    ps = _port_pairs(make_session_pairsets(1, seed=0)[0])
    emb = torch.ones(4, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        svc.submit_embeddings(emb, emb, 0.5, **{name: value})
    if name in _SUBMIT_OPTIONS:
        with pytest.raises(NotImplementedError, match="ROADMAP A"):
            svc.submit(ps, **{name: value})
    assert not svc.queue


def test_unknown_options_and_stateful_crowds_are_refused():
    with pytest.raises(TypeError, match="impl"):
        JoinService(device="cpu", impl="auto")
    svc = JoinService(device="cpu")
    ps = _port_pairs(make_session_pairsets(1, seed=0)[0])
    with pytest.raises(TypeError, match="impl"):
        svc.submit_embeddings(torch.ones(4, 8), torch.ones(4, 8), 0.5,
                              impl="auto")
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        svc.submit(ps, crowd=Crowd())
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        svc.submit(PairSet(ps.u, ps.v, ps.likelihood), crowd=PerfectCrowd())
