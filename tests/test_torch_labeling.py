"""The port's host oracles (``repro_torch.core.{cluster_graph,deduce,
labeling,parallel,ordering,sorting}``) against the JAX package's, on the CPU.

The port speaks the engine codes ``POS`` / ``NEG`` where the reference's
graph and crowds speak ``"M"`` / ``"N"``; the tests map between the two and
no string enters the port.  Everything here is integer or boolean state and
must match exactly: each graph's forest, sizes, neg-adjacency sets and
conflict count after every label; every deduction; every labeler's labels,
crowdsourced set, rounds, batch sizes and conflicts, under a perfect crowd
and under a noisy one (the port's ``NoisyCrowd`` draws the reference's rng
stream draw for draw, so both sides see the same answers); the adaptive
gains bit for bit (pure f32 mul/add/div).  The one tolerance:
``expected_crowdsourced`` within relative 1e-12, because the reference's
float64 sum rounds to 5.000000000000001 on a 5-pair star (ROADMAP R3) and
the port keeps that arithmetic."""
import itertools

import numpy as np
import pytest

from repro.core import cluster_graph as jcg
from repro.core import crowd as jcrowd
from repro.core import deduce as jded
from repro.core import labeling as jlab
from repro.core import ordering as jord
from repro.core import pairs as jpairs
from repro.core import parallel as jpar
from repro.core import sorting as jsort
from repro.data import entities as jent
from repro_torch.core import crowd as tcrowd
from repro_torch.core import graph as tg
from repro_torch.core import labeling as tlab
from repro_torch.core import ordering as tord
from repro_torch.core import pairs as tpairs
from repro_torch.core import parallel as tpar
from repro_torch.core import sorting as tsort
from repro_torch.core.cluster_graph import NEG, POS, ClusterGraph
from repro_torch.core.deduce import deduce_bruteforce
from repro_torch.data import entities as tent

TO_STR = {POS: jcg.MATCH, NEG: jcg.NON_MATCH, None: None}
TO_INT = {jcg.MATCH: POS, jcg.NON_MATCH: NEG, None: None}


def _same_graph(g: ClusterGraph, ref: jcg.ClusterGraph) -> None:
    assert g.parent == ref.parent
    assert g.size == ref.size
    assert g.neg == ref.neg
    assert g.n_conflicts == ref.n_conflicts


def test_paper_example_1():
    """§2.2 Example 1: the seven labeled pairs of Figure 2."""
    triples = [(0, 1, POS), (2, 3, POS), (3, 4, POS), (0, 5, NEG),
               (1, 2, NEG), (2, 6, NEG), (4, 5, NEG)]
    g, ref = ClusterGraph(7), jcg.ClusterGraph(7)
    g.add_labels(triples)
    ref.add_labels([(a, b, TO_STR[lab]) for a, b, lab in triples])
    assert g.deduce(2, 4) == POS            # (o3,o5): path of matches
    assert g.deduce(4, 6) == NEG            # (o5,o7): one non-matching edge
    assert g.deduce(0, 6) is None           # (o1,o7): every path has >=2 N
    _same_graph(g, ref)
    assert g.clusters() == ref.clusters()
    assert g.n_clusters() == ref.n_clusters() == 4


def test_paper_example_3():
    """§3.2 Example 3: p8 = (o5, o6) deduced non-matching from p1..p7."""
    triples = [(1, 2, POS), (0, 1, POS), (0, 5, NEG), (3, 4, POS),
               (3, 5, NEG), (1, 3, NEG)]
    g, ref = ClusterGraph(6), jcg.ClusterGraph(6)
    g.add_labels(triples)
    ref.add_labels([(a, b, TO_STR[lab]) for a, b, lab in triples])
    assert g.deduce(4, 5) == NEG
    _same_graph(g, ref)


def _world(rng, noise: float):
    """Random labeled pairs over an entity partition; with ``noise`` each
    label flips with that probability (so some contradict)."""
    n = int(rng.integers(3, 14))
    ent = rng.integers(0, 4, n)
    all_e = list(itertools.combinations(range(n), 2))
    m = int(rng.integers(1, min(20, len(all_e)) + 1))
    sel = rng.permutation(len(all_e))[:m]
    triples = []
    for k in sel:
        a, b = all_e[k]
        lab = POS if ent[a] == ent[b] else NEG
        if rng.random() < noise:
            lab = 1 - lab
        triples.append((a, b, lab))
    return n, triples


@pytest.mark.parametrize("noise", [0.0, 0.3])
@pytest.mark.parametrize("seeds", [range(0, 40), range(40, 80)])
def test_cluster_graph_matches_reference(seeds, noise):
    """Label by label: the same accept/reject verdict and the same forest,
    sizes, neg sets and conflict count; then every pair's deduction equals
    the reference graph's, and on consistent worlds the brute-force
    oracles' (the port's and the reference's)."""
    conflicts = 0
    for s in seeds:
        n, triples = _world(np.random.default_rng(s), noise)
        g, ref = ClusterGraph(n), jcg.ClusterGraph(n)
        for a, b, lab in triples:
            assert g.add_label(a, b, lab) == ref.add_label(a, b, TO_STR[lab])
            _same_graph(g, ref)
        conflicts += g.n_conflicts
        str_triples = [(a, b, TO_STR[lab]) for a, b, lab in triples]
        for a in range(n):
            for b in range(a + 1, n):
                d = g.deduce(a, b)
                assert d == TO_INT[ref.deduce(a, b)]
                if noise == 0.0:
                    assert d == deduce_bruteforce(n, triples, a, b) == \
                        TO_INT[jded.deduce_bruteforce(n, str_triples, a, b)]
        _same_graph(g, ref)
    if noise:
        assert conflicts > 0, "no label contradicted: the count is untested"
    else:
        assert conflicts == 0


def test_conflicts_counted_not_applied():
    g = ClusterGraph(3)
    assert g.add_label(0, 1, POS)
    assert not g.add_label(0, 1, NEG)    # contradiction dropped
    assert g.n_conflicts == 1
    assert g.deduce(0, 1) == POS
    assert g.add_label(1, 2, NEG)
    assert not g.add_label(0, 2, POS)
    assert g.n_conflicts == 2
    assert g.deduce(0, 2) == NEG


def test_union_merges_negative_adjacency():
    g = ClusterGraph(6)
    g.add_labels([(0, 1, POS), (2, 3, POS), (1, 2, NEG), (4, 5, NEG)])
    # merge cluster {0,1} with 4: both neg edges must follow the new root
    g.add_label(0, 4, POS)
    assert g.deduce(4, 3) == NEG
    assert g.deduce(1, 5) == NEG
    r = g.find(0)
    assert g.neg[r] == {g.find(2), g.find(5)}
    assert r in g.neg[g.find(3)] and r in g.neg[g.find(5)]


@pytest.mark.parametrize("label", ["M", "N", 2, -1, None])
def test_bad_label_raises(label):
    with pytest.raises(ValueError, match="bad label"):
        ClusterGraph(3).add_label(0, 1, label)


# ---------------------------------------------------------------------------
# The labelers
# ---------------------------------------------------------------------------
def _pairsets(kind: str):
    """Both packages' sessions from the same seed: small entity-clustered
    ones, and ones dense enough that a noisy crowd contradicts itself."""
    kw = dict(n_objects=(12, 24), n_pairs=(20, 60), seed=11) \
        if kind == "small" else \
        dict(n_objects=(25, 35), n_pairs=(120, 200), n_entities=4,
             likelihood=(0.7, 0.4, 0.25), seed=1)
    return jent.make_session_pairsets(3, **kw), \
        tent.make_session_pairsets(3, **kw)


def _crowds(kind: str, seed: int):
    if kind == "perfect":
        return jcrowd.PerfectCrowd(), tcrowd.PerfectCrowd()
    kw = dict(error_rate=0.35, qualification=False, seed=seed)
    return jcrowd.NoisyCrowd(**kw), tcrowd.NoisyCrowd(**kw)


LABELERS = {
    "sequential": (lambda ps, c: jlab.label_sequential(
        ps, jsort.order_expected(ps), c),
        lambda ps, c: tlab.label_sequential(ps, tsort.order_expected(ps),
                                            c)),
    "sequential_adaptive": (jlab.label_sequential_adaptive,
                            tlab.label_sequential_adaptive),
    "parallel": (lambda ps, c: jpar.label_parallel(
        ps, jsort.order_expected(ps), c),
        lambda ps, c: tpar.label_parallel(ps, tsort.order_expected(ps), c)),
    "parallel_random": (lambda ps, c: jpar.label_parallel(
        ps, jsort.order_random(ps, 3), c),
        lambda ps, c: tpar.label_parallel(ps, tsort.order_random(ps, 3), c)),
    "parallel_adaptive": (jpar.label_parallel_adaptive,
                          tpar.label_parallel_adaptive),
    "all": (jlab.label_all_crowdsourced, tlab.label_all_crowdsourced),
}


def _same_result(got, exp, msg: str = "") -> None:
    np.testing.assert_array_equal(got.labels, exp.labels, err_msg=msg)
    np.testing.assert_array_equal(got.crowdsourced, exp.crowdsourced,
                                  err_msg=msg)
    assert (got.n_iterations, got.batch_sizes, got.n_conflicts,
            got.n_crowdsourced, got.n_deduced) == \
        (exp.n_iterations, exp.batch_sizes, exp.n_conflicts,
         exp.n_crowdsourced, exp.n_deduced), msg


@pytest.mark.parametrize("crowd", ["perfect", "noisy"])
@pytest.mark.parametrize("labeler", sorted(LABELERS))
def test_labeler_matches_reference(labeler, crowd):
    """Field for field on three sessions; the noisy crowds err 35% of the
    time on sessions dense enough to contradict transitivity, so the
    "drop" policy runs (asserted where it can: a sequential labeler asks
    only undeducible pairs and the adaptive parallel one scans every
    labeled pair before its batch, whose pairs then form a forest over the
    clusters, so neither can be contradicted)."""
    ref_fn, port_fn = LABELERS[labeler]
    conflicts = 0
    for k, (jps, tps) in enumerate(zip(*_pairsets(
            "small" if crowd == "perfect" else "dense"))):
        jc, tc = _crowds(crowd, seed=30 + k)
        exp, got = ref_fn(jps, jc), port_fn(tps, tc)
        _same_result(got, exp, f"{labeler} {crowd} session {k}")
        assert tc.n_asked == jc.n_asked
        conflicts += got.n_conflicts
        if crowd == "perfect":
            np.testing.assert_array_equal(got.labels, tps.truth)
    if crowd == "noisy" and labeler in ("parallel", "parallel_random"):
        assert conflicts > 0, "no answer was rejected"


def test_algorithm_3_selection_and_sweep_match_reference():
    """``parallel_crowdsourced_pairs`` with ``exclude`` and
    ``deduction_sweep`` with ``skip`` from random partial knowledge."""
    rng = np.random.default_rng(5)
    for jps, tps in zip(*_pairsets("dense")):
        order = jsort.order_expected(jps)
        for _ in range(6):
            m = len(jps)
            lab_idx = rng.permutation(m)[: int(rng.integers(0, m // 2))]
            known = {int(i): (POS if jps.truth[i] else NEG) for i in lab_idx}
            known_s = {i: TO_STR[x] for i, x in known.items()}
            ex = {int(i) for i in rng.permutation(m)[:int(rng.integers(0, 9))]
                  if int(i) not in known}
            assert tpar.parallel_crowdsourced_pairs(tps, order, known, ex) \
                == jpar.parallel_crowdsourced_pairs(jps, order, known_s, ex)
            assert tpar.parallel_crowdsourced_pairs(tps, order, known) \
                == jpar.parallel_crowdsourced_pairs(jps, order, known_s)
            got = tpar.deduction_sweep(tps, order, known, skip=ex)
            exp = jpar.deduction_sweep(jps, order, known_s, skip=ex)
            assert got == exp
            assert {i: TO_STR[x] for i, x in known.items()} == known_s


# ---------------------------------------------------------------------------
# Adaptive gains: host mirror == reference host mirror == engine gains
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_adaptive_gains_host_bitwise(seed):
    """Labels land one at a time in a seeded order (some contradicting, so
    rejected); after each, the port's host gains equal the reference's host
    gains and the port's ``session_gains`` over the accepted labels, bit
    for bit at every pair; the expected rank and the host ranking equal
    the reference's."""
    rng = np.random.default_rng(seed)
    jps = jent.make_session_pairsets(1, seed=seed, n_objects=(25, 35),
                                     n_pairs=(120, 200), n_entities=4,
                                     likelihood=(0.7, 0.4, 0.25))[0]
    ps = tpairs.PairSet(jps.u, jps.v, jps.likelihood, jps.truth,
                        jps.n_objects)
    g, ref = ClusterGraph(ps.n_objects), jcg.ClusterGraph(ps.n_objects)
    accepted = np.full(len(ps), -1, np.int32)
    erank = tord.expected_rank(ps.likelihood)
    np.testing.assert_array_equal(erank, jord.expected_rank(jps.likelihood))
    prior = np.clip(ps.likelihood, np.float32(tord.PRIOR_FLOOR),
                    np.float32(1 - tord.PRIOR_FLOOR))
    damped = False
    for i in rng.permutation(len(ps))[:60]:
        lab = POS if ps.truth[i] else NEG
        if rng.random() < 0.2:
            lab = 1 - lab
        a, b = int(ps.u[i]), int(ps.v[i])
        if g.add_label(a, b, lab):
            accepted[i] = lab
        ref.add_label(a, b, TO_STR[lab])
        host = tord.adaptive_gains_host(g, ps.u, ps.v, ps.likelihood)
        exp = jord.adaptive_gains_host(ref, jps.u, jps.v, jps.likelihood)
        assert host.dtype == exp.dtype == np.float32
        np.testing.assert_array_equal(host.view(np.int32),
                                      exp.view(np.int32))
        state = tg.session_from_labels(ps.u, ps.v, accepted,
                                       np.zeros(len(ps), bool), ps.n_objects,
                                       device="cpu")
        dev = tord.session_gains(state, ps.likelihood).numpy()
        np.testing.assert_array_equal(host.view(np.int32), dev.view(np.int32))
        idx = np.flatnonzero(accepted == -1)
        np.testing.assert_array_equal(
            tord.adaptive_order_host(host, erank, idx),
            jord.adaptive_order_host(exp, erank, idx))
        damped |= bool((host != prior).any())
    assert g.n_conflicts > 0 and damped, \
        "no rejected label or no damping: the test saw too little"


# ---------------------------------------------------------------------------
# E[C] of §4.2 (Example 4)
# ---------------------------------------------------------------------------
def _star(n_leaves: int, p: float):
    u = np.zeros(n_leaves, np.int32)
    v = np.arange(1, n_leaves + 1, dtype=np.int32)
    lik = np.full(n_leaves, p, np.float32)
    return u, v, lik


def _tiny_sets():
    """A 5-pair star (the R3 case), a 4-pair one, §4.2 Example 4's triangle
    and seeded random tiny sessions."""
    out = [_star(5, 0.5), _star(4, 0.9)]
    # §4.2 Example 4's triangle
    out.append((np.array([0, 1, 0], np.int32), np.array([1, 2, 2], np.int32),
                np.array([0.9, 0.4, 0.2], np.float32)))
    rng = np.random.default_rng(9)
    for _ in range(4):
        n = int(rng.integers(4, 8))
        all_e = list(itertools.combinations(range(n), 2))
        m = int(rng.integers(3, min(9, len(all_e)) + 1))
        sel = rng.permutation(len(all_e))[:m]
        out.append((np.array([all_e[k][0] for k in sel], np.int32),
                    np.array([all_e[k][1] for k in sel], np.int32),
                    rng.random(m).astype(np.float32)))
    return out


@pytest.mark.parametrize("case", range(7))
def test_expected_crowdsourced_matches_reference(case):
    """``count_crowdsourced`` exactly on every world of each order, and
    ``_consistent`` on every world; E[C] within relative 1e-12 (R3)."""
    u, v, lik = _tiny_sets()[case]
    tps = tpairs.PairSet(u, v, lik)
    jps = jpairs.PairSet(u, v, lik)
    rng = np.random.default_rng(case)
    for order in (np.argsort(-lik, kind="stable"),
                  rng.permutation(len(u))):
        for world in itertools.product([True, False], repeat=len(u)):
            assert tsort._consistent(tps.n_objects, u, v, world) == \
                jsort._consistent(jps.n_objects, u, v, world)
            assert tsort.count_crowdsourced(tps, order, world) == \
                jsort.count_crowdsourced(jps, order, world)
        got = tsort.expected_crowdsourced(tps, order)
        exp = jsort.expected_crowdsourced(jps, order)
        assert got == pytest.approx(exp, rel=1e-12, abs=0.0)


def test_expected_crowdsourced_refuses_large_instances():
    u, v, lik = _star(17, 0.5)
    with pytest.raises(ValueError, match="exponential"):
        tsort.expected_crowdsourced(tpairs.PairSet(u, v, lik),
                                    np.arange(17))
