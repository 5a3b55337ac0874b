"""The plan layer and the cross-query cluster cache (ROADMAP A11, DESIGN.md
§14): ``tests/test_plan.py``'s cases on the port, each held against the JAX
package on the same worlds — plan rewrites, join orders, ``PlanResult``s
(signature, matches, clusters, candidates, crowdsourced pairs, cache hits,
spend, stages), the service's seeded submissions under both serving
disciplines and its ``cache_path`` wiring.  Fingerprints are the same hex
digests in both packages, and a cache file written by either package seeds
the other identically."""
import os

import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings, strategies as st

import repro.plan as jp
from repro.core import PerfectCrowd as JaxPerfectCrowd
from repro.core.pairs import PairSet as JaxPairSet
from repro.launch.mesh import make_host_mesh
from repro.serve.join_service import JoinService as JaxJoinService
import repro_torch.plan as tp
from repro_torch.core.cluster_graph import NEG, POS, UNKNOWN
from repro_torch.core.crowd import PerfectCrowd
from repro_torch.core.pairs import PairSet
from repro_torch.plan.algebra import conjuncts, leg
from repro_torch.serve.join_service import JoinService

THRESHOLD = 0.8


# ---------------------------------------------------------------------------
# world builders (tests/test_plan.py's), as raw arrays
# ---------------------------------------------------------------------------
def _entities_from_pairs(n, u, v, truth):
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b, t in zip(u, v, truth):
        if t == POS:
            ra, rb = find(int(a)), find(int(b))
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
    return np.array([find(i) for i in range(n)])


def _embed(entities, rng, dim=12, noise=0.03):
    cents = {e: rng.normal(size=dim) for e in np.unique(entities)}
    emb = np.stack([cents[e] for e in entities])
    return emb + noise * rng.normal(size=emb.shape)


def _split(entities, emb, rng, n_colls):
    """Raw collections: (name, embeddings, attrs, entities)."""
    perm = rng.permutation(len(entities))
    out = []
    for i in range(n_colls):
        rows = np.sort(perm[i::n_colls])
        out.append(("abcde"[i], emb[rows],
                    {"oid": rows.astype(np.int64),
                     "g": (rows % 3).astype(np.int64)},
                    entities[rows]))
    return out


def _world(seed, n_colls, make_random_world):
    rng = np.random.default_rng(seed)
    n, u, v, truth = make_random_world(rng)
    entities = _entities_from_pairs(n, u, v, truth)
    return _split(entities, _embed(entities, rng), rng, n_colls)


def _colls(ns, raw):
    return [ns.Collection(name, emb, attrs=dict(attrs), entities=ent)
            for name, emb, attrs, ent in raw]


def _norm(e):
    return e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-30)


def _perfect_recall(raw, threshold):
    for i in range(len(raw)):
        for j in range(i + 1, len(raw)):
            (_, ea, _, na), (_, eb, _, nb) = raw[i], raw[j]
            sims = _norm(np.asarray(ea, np.float32)) @ \
                _norm(np.asarray(eb, np.float32)).T
            if ((na[:, None] == nb[None, :]) & (sims < threshold)).any():
                return False
    return True


def _executor(ns, cache=None, async_mode=False, optimize_plans=True):
    if ns is tp:
        factory = lambda: JoinService(lanes=2, async_mode=async_mode,
                                      device="cpu")
    else:
        factory = lambda: JaxJoinService(lanes=2, async_mode=async_mode)
    return ns.PlanExecutor(service_factory=factory, cache=cache,
                           optimize_plans=optimize_plans)


def _summary(res) -> dict:
    return {"signature": res.signature(), "clusters": res.clusters,
            "matches": res.matches, "n_candidates": res.n_candidates,
            "n_crowdsourced": res.n_crowdsourced,
            "n_cache_hits": res.n_cache_hits,
            "spent_cents": res.spent_cents,
            "stages": [(s.rid, s.leg, s.n_pairs, s.n_new, s.n_cache_hits,
                        s.n_crowdsourced, s.spent_cents) for s in res.stages]}


def _names(ns, plan):
    return [ns.algebra.leg(k)[0].name for k in plan.inputs]


# ---------------------------------------------------------------------------
# algebra
# ---------------------------------------------------------------------------
def test_predicates_and_leg_resolution():
    rng = np.random.default_rng(0)
    coll = tp.Collection("t", rng.normal(size=(6, 4)),
                         attrs={"x": np.arange(6), "y": np.arange(6) % 2})
    plan = tp.Filter(tp.Cmp("t.x", "<", 4),
                     tp.Filter(tp.Or(tp.Cmp("t.y", "==", 0),
                                     tp.Not(tp.Cmp("t.x", ">=", 2))),
                               tp.Scan(coll)))
    got = leg(plan)
    assert got is not None
    _, mask = got
    np.testing.assert_array_equal(
        mask, (np.arange(6) < 4) & ((np.arange(6) % 2 == 0)
                                    | ~(np.arange(6) >= 2)))
    assert plan.ordered_columns() == ("t.x", "t.y")
    with pytest.raises(ValueError, match="unknown columns"):
        tp.Filter(tp.Cmp("t.z", "==", 1), tp.Scan(coll))
    with pytest.raises(ValueError, match="unknown columns"):
        tp.Project(("t.z",), tp.Scan(coll))
    assert tp.IsIn("t.x", (1, 4)).mask(coll.column).tolist() == \
        [False, True, False, False, True, False]


def test_conjuncts_flatten_ands():
    p = tp.And(tp.And(tp.Cmp("a.x", "==", 1), tp.Cmp("b.x", "==", 2)),
               tp.Cmp("a.y", "<", 3))
    assert len(conjuncts(p)) == 3


def test_row_fingerprints_content_keyed_and_shared():
    """Content-keyed, position-free, and the reference's digest for the
    same f32 row — from a numpy array or a tensor alike."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(5, 8)).astype(np.float32)
    fps = tp.row_fingerprints(emb)
    assert len(set(fps)) == 5
    assert tp.row_fingerprints(emb[::-1]) == fps[::-1]
    assert fps == jp.row_fingerprints(emb)
    assert tp.row_fingerprints(torch.from_numpy(emb)) == fps
    assert tp.collection_fingerprint(fps) == jp.collection_fingerprint(fps)


# ---------------------------------------------------------------------------
# optimizer rewrites
# ---------------------------------------------------------------------------
def test_pushdown_moves_single_collection_conjuncts(make_random_world):
    a, b = _colls(tp, _world(0, 2, make_random_world))
    plan = tp.Filter(tp.And(tp.Cmp("a.g", "==", 0), tp.Cmp("b.g", "<", 2)),
                     tp.CrowdJoin(tp.Scan(a), tp.Scan(b), THRESHOLD))
    opt = tp.optimize(plan)
    assert isinstance(opt, tp.CrowdJoin)
    assert all(isinstance(kid, tp.Filter) for kid in opt.children())


def test_pushdown_keeps_cross_collection_residual(make_random_world):
    a, b = _colls(tp, _world(1, 2, make_random_world))
    cross = tp.Cmp("a.g", "==", 0)
    residual = tp.Or(tp.Cmp("a.g", "==", 1), tp.Cmp("b.g", "==", 1))
    plan = tp.Filter(tp.And(cross, residual),
                     tp.CrowdJoin(tp.Scan(a), tp.Scan(b), THRESHOLD))
    opt = tp.optimize(plan)
    assert isinstance(opt, tp.Filter)
    assert opt.pred == residual
    assert isinstance(opt.child, tp.CrowdJoin)


def test_flatten_nested_same_threshold_joins(make_random_world):
    a, b, c = _colls(tp, _world(2, 3, make_random_world))
    nested = tp.CrowdJoin(tp.CrowdJoin(tp.Scan(a), tp.Scan(b), THRESHOLD),
                          tp.Scan(c), THRESHOLD)
    opt = tp.optimize(nested)
    assert isinstance(opt, tp.MultiJoin)
    assert len(opt.inputs) == 3
    mixed = tp.CrowdJoin(tp.CrowdJoin(tp.Scan(a), tp.Scan(b), 0.9),
                         tp.Scan(c), THRESHOLD)
    assert isinstance(tp.optimize(mixed), tp.CrowdJoin)


@pytest.mark.parametrize("seed", [3, 11])
def test_join_order_deterministic_and_the_references(make_random_world,
                                                     seed):
    """The greedy leg order is deterministic in ``seed`` and the
    reference's, and so is its expected-cost proxy."""
    raw = _world(seed, 3, make_random_world)
    order = {}
    for ns in (tp, jp):
        plan = ns.MultiJoin([ns.Scan(c) for c in _colls(ns, raw)], THRESHOLD)
        o1, o2 = ns.optimize(plan, seed=7), ns.optimize(plan, seed=7)
        assert _names(ns, o1) == _names(ns, o2)
        order[ns.__name__] = _names(ns, o1)
    assert order["repro_torch.plan"] == order["repro.plan"]
    sel = np.random.default_rng(seed).random((3, 3))
    for perm in ([0, 1, 2], [2, 0, 1]):
        assert tp.expected_crowd_cost([5, 7, 9], sel, perm) == \
            jp.expected_crowd_cost([5, 7, 9], sel, perm)


# ---------------------------------------------------------------------------
# ClusterCache
# ---------------------------------------------------------------------------
def test_cluster_cache_seed_and_conflict_drop(tmp_path):
    cache = tp.ClusterCache()
    cache.deposit(["f1", "f2", "f4"], ["f2", "f3", "f5"],
                  np.array([POS, POS, NEG], np.int32))
    seeds = cache.seed(["f1", "f4", "f1", "f9"], ["f3", "f5", "f5", "f1"])
    np.testing.assert_array_equal(seeds, [POS, NEG, UNKNOWN, UNKNOWN])
    assert cache.n_hits == 2 and cache.n_misses == 2
    cache.deposit(["f4"], ["f5"], np.array([POS], np.int32))
    np.testing.assert_array_equal(cache.seed(["f4"], ["f5"]), [POS])
    assert cache.n_neg_dropped == 1
    path = tmp_path / "cache.json"
    cache.save(str(path))
    loaded = tp.ClusterCache.load(str(path))
    np.testing.assert_array_equal(
        loaded.seed(["f1", "f4", "f9"], ["f3", "f5", "f1"]),
        cache.seed(["f1", "f4", "f9"], ["f3", "f5", "f1"]))
    assert loaded.n_clusters == cache.n_clusters


def test_cluster_cache_union_order_invariant():
    c1, c2 = tp.ClusterCache(), tp.ClusterCache()
    c1.deposit(["a", "b"], ["b", "c"], np.array([POS, POS], np.int32))
    c2.deposit(["b", "a"], ["c", "b"], np.array([POS, POS], np.int32))
    assert c1._find("c") == c2._find("c") == "a"


def test_cache_files_cross_load_and_seed_identically(tmp_path):
    """The same deposits give byte-identical cache files in both packages;
    a file written by either loads into the other and seeds the same
    verdicts."""
    rng = np.random.default_rng(5)
    fps = [f"{i:032x}" for i in range(40)]
    u = rng.integers(0, 40, 120)
    v = rng.integers(0, 40, 120)
    labels = np.where(rng.random(120) < 0.1, POS, NEG).astype(np.int32)
    port, ref = tp.ClusterCache(), jp.ClusterCache()
    for c in (port, ref):
        c.deposit([fps[i] for i in u[:60]], [fps[i] for i in v[:60]],
                  labels[:60])
        c.deposit([fps[i] for i in u[60:]], [fps[i] for i in v[60:]],
                  labels[60:])
    port.save(str(tmp_path / "port.json"))
    ref.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    qu = [fps[i] for i in rng.integers(0, 40, 200)]
    qv = [fps[i] for i in rng.integers(0, 40, 200)]
    want = ref.seed(qu, qv)
    for path in ("port.json", "ref.json"):
        for ns in (tp, jp):
            got = ns.ClusterCache.load(str(tmp_path / path)).seed(qu, qv)
            np.testing.assert_array_equal(got, want)
    assert (want != UNKNOWN).any() and (want == UNKNOWN).any()


# ---------------------------------------------------------------------------
# the JoinService's seeded submissions
# ---------------------------------------------------------------------------
def _world_pairs(seed):
    rng = np.random.default_rng(seed)
    n = 14
    ent = rng.integers(0, 4, n)
    u, v = np.triu_indices(n, k=1)
    keep = rng.random(len(u)) < 0.5
    u, v = u[keep].astype(np.int32), v[keep].astype(np.int32)
    truth = ent[u] == ent[v]
    lik = np.clip(np.where(truth, 0.8, 0.2)
                  + 0.1 * rng.standard_normal(len(u)), 0.01, 0.99)
    return u, v, lik.astype(np.float32), truth, n


def test_admit_rejects_bad_seed_length():
    svc = JoinService(lanes=1, device="cpu")
    pairs = PairSet(*_world_pairs(0))
    with pytest.raises(ValueError, match="seed_labels length"):
        svc.submit(pairs, seed_labels=np.zeros(len(pairs) + 1, np.int32))


def test_admit_rejects_duplicate_rid_from_embeddings_path():
    svc = JoinService(lanes=1, device="cpu")
    svc.submit(PairSet(*_world_pairs(1)), rid=7)
    with pytest.raises(ValueError, match="duplicate join request rid 7"):
        svc.submit(PairSet(*_world_pairs(2)), rid=7)
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(4, 8)).astype(np.float32)
    rid = svc.submit_embeddings(emb, emb, 0.5)
    assert rid not in (7,)


def _seeded_pair(async_mode, seed, seeds_of):
    """A cold run and a seeded warm run of the same pairs in both packages:
    [(cold, warm) port, (cold, warm) reference]."""
    out = []
    for port in (True, False):
        arrays = _world_pairs(seed)
        if port:
            svc = lambda: JoinService(lanes=2, async_mode=async_mode,
                                      device="cpu")
            pairs, crowd = PairSet(*arrays), PerfectCrowd
        else:
            svc = lambda: JaxJoinService(lanes=2, async_mode=async_mode)
            u, v, lik, truth, n = arrays
            pairs = JaxPairSet(u=u, v=v, likelihood=lik, truth=truth,
                               n_objects=n)
            crowd = JaxPerfectCrowd
        cold = svc()
        rid = cold.submit(pairs, crowd())
        res = cold.run()[rid]
        warm = svc()
        wid = warm.submit(pairs, crowd(), seed_labels=seeds_of(res))
        out.append((res, warm.run()[wid]))
    return out


def _same_result(a, b):
    for f in ("labels", "crowdsourced"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f in ("n_rounds", "round_sizes", "n_spent_cents", "n_cache_hits",
              "n_conflicts", "fold_rounds"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("async_mode", [False, True])
def test_service_warm_start_identical_to_cold(async_mode):
    """A submit seeded with the cold run's verdicts crowdsources nothing,
    bills nothing, gives the same labels — as the reference's does."""
    (cold, warm), (rcold, rwarm) = _seeded_pair(
        async_mode, 3,
        lambda res: np.where(res.labels, POS, NEG).astype(np.int32))
    assert cold.n_crowdsourced > 0 and cold.n_cache_hits == 0
    assert warm.n_crowdsourced == 0 and warm.n_spent_cents == 0.0
    assert warm.n_cache_hits == len(warm.labels)
    np.testing.assert_array_equal(warm.labels, cold.labels)
    _same_result(cold, rcold)
    _same_result(warm, rwarm)


@pytest.mark.parametrize("async_mode", [False, True])
def test_service_partial_seed_crowdsources_only_novel(async_mode):
    def half(res):
        seeds = np.full(len(res.labels), UNKNOWN, np.int32)
        k = len(res.labels) // 2
        seeds[:k] = np.where(res.labels[:k], POS, NEG)
        return seeds

    (cold, warm), (rcold, rwarm) = _seeded_pair(async_mode, 4, half)
    np.testing.assert_array_equal(warm.labels, cold.labels)
    assert warm.n_cache_hits == len(cold.labels) // 2
    assert warm.n_crowdsourced < cold.n_crowdsourced
    assert warm.n_spent_cents == warm.n_crowdsourced * 2.0
    _same_result(cold, rcold)
    _same_result(warm, rwarm)


# ---------------------------------------------------------------------------
# executor + cache warm starts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("async_mode", [False, True])
def test_plan_warm_start_repeat_query(make_random_world, async_mode):
    """The second execution over a shared cache crowdsources nothing and
    reproduces the cold result; both executions are the reference's."""
    raw = _world(5, 3, make_random_world)
    got = {}
    for ns in (tp, jp):
        a, b, c = _colls(ns, raw)
        plan = ns.MultiJoin([ns.Scan(a), ns.Scan(b), ns.Scan(c)], THRESHOLD)
        cache = ns.ClusterCache()
        got[ns] = [_executor(ns, cache, async_mode).execute(plan)
                   for _ in range(2)]
    cold, warm = got[tp]
    assert cold.n_candidates > 0
    assert warm.n_crowdsourced == 0 and warm.spent_cents == 0.0
    assert warm.n_cache_hits > 0
    assert warm.signature() == cold.signature()
    assert warm.matches == cold.matches and warm.clusters == cold.clusters
    for mine, ref in zip(got[tp], got[jp]):
        assert _summary(mine) == _summary(ref)


@pytest.mark.parametrize("async_mode", [False, True])
def test_plan_warm_start_grown_collection(make_random_world, async_mode):
    """A query over a grown collection crowdsources only pairs touching
    the novel rows; every execution is the reference's."""
    rng = np.random.default_rng(6)
    n, u, v, truth = make_random_world(rng)
    entities = _entities_from_pairs(n, u, v, truth)
    emb = _embed(entities, rng)
    raw = _split(entities, emb, rng, 2)
    extra = rng.integers(0, max(entities) + 1, 3)
    emb_extra = _embed(extra, rng)
    name, b_emb, b_attrs, b_ent = raw[1]
    grown = (name, np.concatenate([b_emb, emb_extra]),
             {k: np.concatenate([val, np.arange(len(val), len(val) + 3)])
              for k, val in b_attrs.items()},
             np.concatenate([b_ent, extra]))
    got = {}
    for ns in (tp, jp):
        a, b = _colls(ns, raw)
        (b2,) = _colls(ns, [grown])
        cache = ns.ClusterCache()
        first = _executor(ns, cache, async_mode).execute(
            ns.CrowdJoin(ns.Scan(a), ns.Scan(b), THRESHOLD))
        plan2 = ns.CrowdJoin(ns.Scan(a), ns.Scan(b2), THRESHOLD)
        warm = _executor(ns, cache, async_mode).execute(plan2)
        coldref = _executor(ns, ns.ClusterCache(), async_mode).execute(plan2)
        got[ns] = (first, warm, coldref, a, b, b2)
    first, warm, coldref, a, b, b2 = got[tp]
    assert warm.signature() == coldref.signature()
    assert warm.matches == coldref.matches
    if coldref.n_crowdsourced:
        assert warm.n_crowdsourced < coldref.n_crowdsourced
    old_fps = set(a.fingerprints()) | set(b.fingerprints())
    new_fps = set(b2.fingerprints()) - old_fps
    assert len(new_fps) == 3
    sims = _norm(a.embeddings) @ _norm(b2.embeddings).T
    fa, fb = a.fingerprints(), b2.fingerprints()
    novel = sum(1 for i, j in np.argwhere(sims >= THRESHOLD)
                if fa[i] in new_fps or fb[j] in new_fps)
    assert warm.n_crowdsourced <= novel
    for mine, ref in zip(got[tp][:3], got[jp][:3]):
        assert _summary(mine) == _summary(ref)


def test_plan_spend_excludes_cache_avoided_pairs(make_random_world):
    for seed in range(7, 20):  # the first world whose join does crowd work
        raw = _world(seed, 2, make_random_world)
        a, b = _colls(tp, raw)
        plan = tp.CrowdJoin(tp.Scan(a), tp.Scan(b), THRESHOLD)
        cache = tp.ClusterCache()
        cold = _executor(tp, cache).execute(plan)
        if cold.n_crowdsourced > 0:
            break
    assert cold.n_crowdsourced > 0
    assert cold.spent_cents == cold.n_crowdsourced * 2.0
    warm = _executor(tp, cache).execute(plan)
    assert warm.n_cache_hits > 0 and warm.spent_cents == 0.0
    ra, rb = _colls(jp, raw)
    ref_plan = jp.CrowdJoin(jp.Scan(ra), jp.Scan(rb), THRESHOLD)
    ref_cache = jp.ClusterCache()
    ref = [_executor(jp, ref_cache).execute(ref_plan) for _ in range(2)]
    assert [_summary(cold), _summary(warm)] == [_summary(r) for r in ref]


# ---------------------------------------------------------------------------
# property: optimizer rewrites are result-equivalent, as the reference's
# ---------------------------------------------------------------------------
@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 10 ** 6), n_colls=st.integers(2, 3),
       which=st.integers(0, 2))
def test_optimizer_rewrites_result_equivalent(make_random_world, seed,
                                              n_colls, which):
    """Pushdown + reordering give the unoptimized plan's observable result
    and never more candidates; the optimized result is the reference's."""
    raw = _world(seed, n_colls, make_random_world)
    assume(all(len(r[1]) >= 2 for r in raw))
    assume(_perfect_recall(raw, THRESHOLD))
    got = {}
    for ns in (tp, jp):
        colls = _colls(ns, raw)
        names = [c.name for c in colls]
        preds = [ns.Cmp(f"{names[0]}.g", "==", 0),
                 ns.And(ns.Cmp(f"{names[0]}.g", "<", 2),
                        ns.Cmp(f"{names[-1]}.g", ">=", 1)),
                 ns.Or(ns.Cmp(f"{names[0]}.g", "==", 1),
                       ns.Cmp(f"{names[-1]}.g", "==", 1))]
        join = ns.MultiJoin([ns.Scan(c) for c in colls], THRESHOLD) \
            if n_colls > 2 else ns.CrowdJoin(ns.Scan(colls[0]),
                                             ns.Scan(colls[1]), THRESHOLD)
        plan = ns.Filter(preds[which], join)
        got[ns] = _executor(ns, optimize_plans=True).execute(plan)
        if ns is tp:
            unopt = _executor(tp, optimize_plans=False).execute(plan)
            assert got[tp].signature() == unopt.signature()
            assert got[tp].n_candidates <= unopt.n_candidates
    assert _summary(got[tp]) == _summary(got[jp])


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 10 ** 6))
def test_join_reorder_result_equivalent(make_random_world, seed):
    """Every leg order of a MultiJoin gives the same matches and clusters;
    each order's result is the reference's."""
    raw = _world(seed, 3, make_random_world)
    assume(all(len(r[1]) >= 2 for r in raw))
    base = None
    for order in ([0, 1, 2], [2, 0, 1], [1, 2, 0]):
        res = {}
        for ns in (tp, jp):
            colls = _colls(ns, raw)
            plan = ns.MultiJoin([ns.Scan(colls[i]) for i in order],
                                THRESHOLD)
            res[ns] = _executor(ns, optimize_plans=False).execute(plan)
        assert _summary(res[tp]) == _summary(res[jp])
        sig = (tuple(sorted(res[tp].matches)),
               frozenset(c for c in res[tp].clusters if len(c) > 1))
        if base is None:
            base = sig
        else:
            assert sig == base


# ---------------------------------------------------------------------------
# atomic cache persistence and the service's cache_path wiring
# ---------------------------------------------------------------------------
def test_cluster_cache_save_atomic_on_crash(tmp_path, monkeypatch):
    """``save`` writes ``path.tmp`` and renames: a crash mid-write leaves
    the previous cache intact."""
    import repro_torch.plan.cache as cache_mod
    real_dump = cache_mod.json.dump
    path = str(tmp_path / "cache.json")
    cache = tp.ClusterCache()
    cache.deposit(["a", "b"], ["b", "c"], np.array([POS, POS], np.int32))
    cache.save(path)

    def crash_mid_write(payload, f, **kw):
        f.write('{"clusters": [["a", ')
        raise OSError("power loss (injected)")

    monkeypatch.setattr(cache_mod.json, "dump", crash_mid_write)
    cache.deposit(["c"], ["d"], np.array([POS], np.int32))
    with pytest.raises(OSError, match="power loss"):
        cache.save(path)
    monkeypatch.setattr(cache_mod.json, "dump", real_dump)
    loaded = tp.ClusterCache.load(path)
    np.testing.assert_array_equal(loaded.seed(["a"], ["c"]), [POS])
    assert loaded.n_objects == 3
    cache.save(path)
    assert tp.ClusterCache.load(path).n_objects == 4


def test_service_cache_path_auto_seed_deposit(tmp_path):
    """A service with ``cache_path`` fingerprints ``submit_embeddings``
    candidates, deposits the verdicts and persists them: a second service
    warm-starts fully.  Both runs are the reference's, and both packages
    write the same cache file."""
    import jax.numpy as jnp
    mesh = make_host_mesh(1, 1)
    rng = np.random.default_rng(0)
    base = rng.normal(size=(2, 8)).astype(np.float32)
    emb = base[np.arange(16) % 2] + \
        0.05 * rng.normal(size=(16, 8)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    truth_fn = lambda rows, cols: \
        (np.asarray(rows) % 2) == (np.asarray(cols) % 2)
    paths = {p: str(tmp_path / f"{p}.json") for p in ("port", "ref")}

    def serve(port):
        if port:
            svc = JoinService(lanes=1, cache_path=paths["port"],
                              device="cpu")
            rid = svc.submit_embeddings(torch.from_numpy(emb[:8]),
                                        torch.from_numpy(emb[8:]),
                                        threshold=0.3, truth_fn=truth_fn)
        else:
            svc = JaxJoinService(lanes=1, cache_path=paths["ref"])
            rid = svc.submit_embeddings(jnp.asarray(emb[:8]),
                                        jnp.asarray(emb[8:]), threshold=0.3,
                                        mesh=mesh, truth_fn=truth_fn)
        return svc.run()[rid]

    first = serve(True)
    assert os.path.exists(paths["port"])
    assert first.n_cache_hits == 0 and first.n_crowdsourced > 0
    second = serve(True)
    np.testing.assert_array_equal(first.labels, second.labels)
    assert second.n_crowdsourced == 0
    assert second.n_cache_hits == len(second.labels)
    assert second.n_spent_cents == 0.0
    for mine, ref in ((first, serve(False)), (second, serve(False))):
        _same_result(mine, ref)
    assert open(paths["port"]).read() == open(paths["ref"]).read()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_reference_cache_file_seeds_the_port(tmp_path, writer):
    """A cache file either package's service wrote seeds the port's
    ``submit_embeddings`` as it seeds the reference's: the same seed labels,
    the same warm results."""
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    base = rng.normal(size=(3, 8)).astype(np.float32)
    emb = base[np.arange(24) % 3] + \
        0.05 * rng.normal(size=(24, 8)).astype(np.float32)
    truth_fn = lambda rows, cols: \
        (np.asarray(rows) % 3) == (np.asarray(cols) % 3)
    path = str(tmp_path / "cache.json")
    if writer == "port":
        svc = JoinService(lanes=1, cache_path=path, device="cpu")
        svc.submit_embeddings(emb[:12], emb[12:], 0.3, truth_fn=truth_fn)
    else:
        svc = JaxJoinService(lanes=1, cache_path=path)
        svc.submit_embeddings(jnp.asarray(emb[:12]), jnp.asarray(emb[12:]),
                              0.3, make_host_mesh(1, 1), truth_fn=truth_fn)
    svc.run()
    # a larger query over the same rows and 4 new ones a side
    more = np.concatenate([emb, base[np.arange(8) % 3] + 0.05 * rng.normal(
        size=(8, 8)).astype(np.float32)])
    ea, eb = np.concatenate([more[:12], more[24:28]]), \
        np.concatenate([more[12:24], more[28:32]])
    port = JoinService(lanes=1, cluster_cache=tp.ClusterCache.load(path),
                       device="cpu")
    prid = port.submit_embeddings(ea, eb, 0.3, truth_fn=truth_fn)
    ref = JaxJoinService(lanes=1, cluster_cache=jp.ClusterCache.load(path))
    rrid = ref.submit_embeddings(jnp.asarray(ea), jnp.asarray(eb), 0.3,
                                 make_host_mesh(1, 1), truth_fn=truth_fn)
    np.testing.assert_array_equal(port.queue[-1].seed_labels,
                                  ref.queue[-1].seed_labels)
    mine, theirs = port.run()[prid], ref.run()[rrid]
    assert mine.n_cache_hits > 0
    _same_result(mine, theirs)
