"""Plan executor (DESIGN.md §14): compile a logical plan to JoinService
submissions (the port of ``repro/plan/executor.py``).

A join (``CrowdJoin`` / ``MultiJoin``) over leg inputs (Filter*/Scan
chains) executes as an *accumulated-universe* schedule: legs join in plan
order, and each stage scores the new leg's rows against every row already
in the universe, so the cross-leg candidate set is identical under any leg
order — what ordering changes is crowd cost, not the result.  Each stage is
one ``JoinService.submit`` carrying the accumulated pair set; pairs
resolved by earlier stages (and by earlier *queries*, via the
:class:`ClusterCache`) arrive as ``seed_labels`` and are folded into the
session for free — never posted, never billed.  Completed stages deposit
their verdicts back into the cache.

Output tuples take one row per collection from each resolved entity
cluster (inner-join semantics: clusters missing a leg emit nothing);
residual filters evaluate host-side on the tuples; ``Project`` selects and
dedupes columns.

Each stage's candidates come from the host product ``acc @ embs[k].T`` over
the normalized rows, as in the reference (no kernel is involved there), so
every cross-leg candidate set is the reference's; the crowd stages run
through the port's :class:`JoinService` on its device.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from repro_torch.core.cluster_graph import NEG, POS
from repro_torch.core.crowd import Crowd
from repro_torch.core.pairs import PairSet
from repro_torch.device import DeviceLike
from repro_torch.serve.join_service import JoinService

from .algebra import (Collection, CrowdJoin, Filter, MultiJoin, Plan,
                      Project, leg)
from .cache import ClusterCache
from .optimizer import optimize


@dataclasses.dataclass
class StageStats:
    """Per-stage provenance: one stage = one JoinService submission."""

    rid: int
    leg: str                   # collection the stage added to the universe
    n_pairs: int               # pairs submitted (carried + new)
    n_new: int                 # pairs first seen at this stage
    n_cache_hits: int          # pairs resolved by seeds, not the crowd
    n_crowdsourced: int
    spent_cents: float


@dataclasses.dataclass
class PlanResult:
    columns: Tuple[str, ...]
    tuples: List[Tuple]        # materialized output rows (values)
    clusters: List[FrozenSet[Tuple[str, int]]]   # entity partition
    matches: List[Tuple[Tuple[str, int], Tuple[str, int]]]  # POS pairs
    n_candidates: int          # distinct cross-leg pairs above threshold
    n_crowdsourced: int
    n_cache_hits: int
    spent_cents: float
    stages: List[StageStats]

    def signature(self):
        """The observable result identity — output columns + materialized
        tuples — that every optimizer rewrite must preserve
        (property-tested).  Clusters/matches are provenance, not identity:
        filter pushdown legitimately shrinks the entity universe the
        partition is computed over."""
        return (self.columns, tuple(self.tuples))


class _Rel:
    """Intermediate result: row tuples over named legs, plus join
    provenance.  ``visible`` is the projection applied at materialization."""

    def __init__(self, names: List[str], colls: Dict[str, Collection],
                 row_tuples: List[Tuple[int, ...]]):
        self.names = names
        self.colls = colls
        self.row_tuples = row_tuples
        self.clusters: List[FrozenSet[Tuple[str, int]]] = []
        self.matches: List[Tuple[Tuple[str, int], Tuple[str, int]]] = []
        self.stages: List[StageStats] = []
        self.n_candidates = 0

    def resolve(self, col: str) -> np.ndarray:
        name, attr = col.split(".", 1)
        li = self.names.index(name)
        rows = np.asarray([t[li] for t in self.row_tuples], np.int64)
        return self.colls[name].attrs[attr][rows]


class PlanExecutor:
    """Compiles plans to crowd-join submissions.

    ``service_factory`` builds the JoinService one execution drives (a
    fresh default service on ``device`` per query when omitted) — the knob
    that picks the serving discipline.  ``cache`` is the persistent cross-query
    :class:`ClusterCache`; omitted, each execution still gets an ephemeral
    one (stages of a single query carry verdicts through it).  Simulated
    crowds need ``entities`` on every joined collection (the truth wire)."""

    def __init__(self,
                 service_factory: Optional[Callable[[], JoinService]] = None,
                 cache: Optional[ClusterCache] = None,
                 crowd: Optional[Crowd] = None,
                 optimize_plans: bool = True,
                 sample: int = 64, seed: int = 0,
                 device: DeviceLike = None):
        self.service_factory = service_factory or (
            lambda: JoinService(device=device))
        self.cache = cache
        self.crowd = crowd
        self.optimize_plans = optimize_plans
        self.sample = sample
        self.seed = seed

    def execute(self, plan: Plan) -> PlanResult:
        # output columns come from the LOGICAL plan: rewrites change the
        # execution order, never the result layout
        cols = plan.ordered_columns()
        if self.optimize_plans:
            plan = optimize(plan, sample=self.sample, seed=self.seed)
        service = self.service_factory()
        cache = self.cache if self.cache is not None else ClusterCache()
        rel = self._exec(plan, service, cache)
        tuples = self._materialize(rel, cols)
        return PlanResult(
            columns=cols,
            tuples=tuples,
            clusters=rel.clusters,
            matches=sorted(rel.matches),
            n_candidates=rel.n_candidates,
            n_crowdsourced=sum(s.n_crowdsourced for s in rel.stages),
            n_cache_hits=sum(s.n_cache_hits for s in rel.stages),
            spent_cents=sum(s.spent_cents for s in rel.stages),
            stages=rel.stages,
        )

    @staticmethod
    def _materialize(rel: _Rel, cols: Tuple[str, ...]) -> List[Tuple]:
        out = set()
        for t in rel.row_tuples:
            row = []
            for col in cols:
                name, attr = col.split(".", 1)
                val = rel.colls[name].attrs[attr][t[rel.names.index(name)]]
                row.append(val.item() if hasattr(val, "item") else val)
            out.add(tuple(row))
        return sorted(out, key=lambda r: tuple(map(repr, r)))

    # -- plan walk -----------------------------------------------------------
    def _exec(self, plan: Plan, service: JoinService,
              cache: ClusterCache) -> _Rel:
        got = leg(plan)
        if got is not None:  # Filter*/Scan chain: no crowd involved
            coll, mask = got
            rel = _Rel([coll.name], {coll.name: coll},
                       [(int(r),) for r in np.nonzero(mask)[0]])
            rel.clusters = [frozenset(((coll.name, int(r)),))
                            for r in np.nonzero(mask)[0]]
            return rel
        if isinstance(plan, Project):
            # projection is a materialization concern (execute() already
            # took the column list from the logical plan); nothing to do here
            return self._exec(plan.child, service, cache)
        if isinstance(plan, Filter):
            rel = self._exec(plan.child, service, cache)
            keep = plan.pred.mask(rel.resolve)
            rel.row_tuples = [t for t, k in zip(rel.row_tuples, keep) if k]
            return rel
        if isinstance(plan, (CrowdJoin, MultiJoin)):
            legs = []
            for kid in plan.children():
                got = leg(kid)
                if got is None:
                    raise NotImplementedError(
                        "join inputs must be Filter*/Scan legs — nested "
                        "joins at one threshold flatten via optimize(); "
                        "mixed-threshold join trees are not executable yet")
                legs.append(got)
            return self._run_join(legs, plan.threshold, service, cache)
        raise TypeError(f"unknown plan node {type(plan).__name__}")

    # -- the crowd pipeline --------------------------------------------------
    def _run_join(self, legs: List[Tuple[Collection, np.ndarray]],
                  threshold: float, service: JoinService,
                  cache: ClusterCache) -> _Rel:
        names = [coll.name for coll, _ in legs]
        colls = {coll.name: coll for coll, _ in legs}
        # the shared object universe: filtered rows of every leg, in leg
        # order.  gids are execution-order-local; identity across queries is
        # the row fingerprint.
        objs: List[Tuple[str, int]] = []
        fps: List[str] = []
        embs: List[np.ndarray] = []
        ents: List[Optional[np.ndarray]] = []
        leg_starts: List[int] = []
        for coll, mask in legs:
            rows = np.nonzero(mask)[0]
            leg_starts.append(len(objs))
            objs.extend((coll.name, int(r)) for r in rows)
            cfps = coll.fingerprints()
            fps.extend(cfps[r] for r in rows)
            emb = coll.embeddings[rows]
            norm = np.linalg.norm(emb, axis=1, keepdims=True)
            embs.append(emb / np.maximum(norm, 1e-30))
            ents.append(None if coll.entities is None
                        else coll.entities[rows])
        n_total = len(objs)
        have_truth = all(e is not None for e in ents)
        ent_all = np.concatenate(ents) if have_truth and ents else None

        rel = _Rel(names, colls, [])
        all_u = np.zeros(0, np.int64)
        all_v = np.zeros(0, np.int64)
        all_lik = np.zeros(0, np.float32)
        final_labels = np.zeros(0, bool)
        for k in range(1, len(legs)):
            acc = np.concatenate(embs[:k]) if k > 1 else embs[0]
            sims = acc @ embs[k].T
            ai, bi = np.nonzero(sims >= threshold)
            new_u = ai.astype(np.int64)
            new_v = (leg_starts[k] + bi).astype(np.int64)
            new_lik = ((sims[ai, bi] + 1.0) / 2.0).astype(np.float32)
            rel.n_candidates += len(new_u)
            if len(all_u) + len(new_u) == 0:
                continue
            # the accumulated pair set: carried pairs ride along seeded (the
            # previous stage deposited them), keeping transitive deduction
            # live across stages for free
            all_u = np.concatenate([all_u, new_u])
            all_v = np.concatenate([all_v, new_v])
            all_lik = np.concatenate([all_lik, new_lik])
            truth = (ent_all[all_u] == ent_all[all_v]) if have_truth else None
            seeds = cache.seed([fps[u] for u in all_u],
                               [fps[v] for v in all_v])
            rid = service.submit(
                PairSet(all_u.astype(np.int32), all_v.astype(np.int32),
                        all_lik, truth, n_objects=n_total),
                crowd=self.crowd, seed_labels=seeds)
            res = service.run()[rid]
            final_labels = res.labels
            cache.deposit([fps[u] for u in all_u], [fps[v] for v in all_v],
                          np.where(res.labels, POS, NEG))
            rel.stages.append(StageStats(
                rid=rid, leg=names[k], n_pairs=len(all_u),
                n_new=len(new_u), n_cache_hits=res.n_cache_hits,
                n_crowdsourced=res.n_crowdsourced,
                spent_cents=res.n_spent_cents))
        self._partition(rel, objs, all_u, all_v, final_labels, len(legs))
        return rel

    @staticmethod
    def _partition(rel: _Rel, objs, all_u, all_v, labels,
                   n_legs: int) -> None:
        """Entity partition from the final labels; tuples = per-cluster
        cross product of one row per leg (inner join)."""
        parent = np.arange(len(objs))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for u, v, lab in zip(all_u, all_v, labels):
            if lab:
                ru, rv = find(u), find(v)
                if ru != rv:
                    parent[max(ru, rv)] = min(ru, rv)
                rel.matches.append(tuple(sorted((objs[u], objs[v]))))
        groups: Dict[int, List[int]] = {}
        for gid in range(len(objs)):
            groups.setdefault(find(gid), []).append(gid)
        for members in groups.values():
            rel.clusters.append(frozenset(objs[g] for g in members))
            by_leg: Dict[str, List[int]] = {}
            for g in members:
                name, row = objs[g]
                by_leg.setdefault(name, []).append(row)
            if len(by_leg) == n_legs:
                for combo in itertools.product(
                        *(sorted(by_leg[n]) for n in rel.names)):
                    rel.row_tuples.append(combo)
        rel.clusters.sort(key=lambda c: sorted(c))
        rel.row_tuples.sort()
