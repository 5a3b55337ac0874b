"""Plan optimizer (DESIGN.md §14): filter pushdown + crowd-cost join order
(the port of ``repro/plan/optimizer.py``: the same seeds, subsamples and
greedy leg order).

Two rewrites, both result-equivalent (property-tested against the
unoptimized plan on random worlds):

* **Filter pushdown** — a conjunct referencing only one collection's
  columns is machine-checkable before the crowd ever sees a pair, so it
  moves below the join onto that collection's leg; every filtered-out row
  deletes all its candidate pairs.  Residual conjuncts spanning multiple
  collections stay above the join.
* **Join ordering** — a ``MultiJoin``'s candidate universe (every
  cross-collection pair above threshold) is order-invariant, but the
  *crowd* cost is not: the executor resolves legs incrementally and seeds
  each stage with everything already resolved, so legs that cluster early
  make later stages cheaper.  The optimizer estimates per-stage candidate
  counts from a deterministic embedding subsample and greedily picks the
  cheapest accumulation order.

Nested ``CrowdJoin``s at one threshold flatten into a single ``MultiJoin``
first, so ordering sees the whole leg set.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .algebra import (CrowdJoin, Filter, MultiJoin, Plan, Project, Scan,
                      conjoin, conjuncts, leg)


def _flatten(plan: Plan) -> Plan:
    """Recursively flatten join trees: a CrowdJoin/MultiJoin whose child is
    itself a join at the SAME threshold merges into one MultiJoin (a
    different threshold is a different candidate rule — left alone)."""
    if isinstance(plan, Filter):
        return Filter(plan.pred, _flatten(plan.child))
    if isinstance(plan, Project):
        return Project(plan.cols, _flatten(plan.child))
    if isinstance(plan, (CrowdJoin, MultiJoin)):
        kids = [_flatten(c) for c in plan.children()]
        thr = plan.threshold
        legs: List[Plan] = []
        merged = False
        for kid in kids:
            if isinstance(kid, (CrowdJoin, MultiJoin)) \
                    and kid.threshold == thr:
                legs.extend(kid.children())
                merged = True
            else:
                legs.append(kid)
        if merged or isinstance(plan, MultiJoin):
            return MultiJoin(legs, thr)
        return CrowdJoin(kids[0], kids[1], thr)
    return plan


def _push_filters(plan: Plan) -> Plan:
    if isinstance(plan, Scan):
        return plan
    if isinstance(plan, Project):
        return Project(plan.cols, _push_filters(plan.child))
    if isinstance(plan, (CrowdJoin, MultiJoin)):
        kids = [_push_filters(c) for c in plan.children()]
        if isinstance(plan, CrowdJoin):
            return CrowdJoin(kids[0], kids[1], plan.threshold)
        return MultiJoin(kids, plan.threshold)
    if isinstance(plan, Filter):
        child = _push_filters(plan.child)
        if isinstance(child, Filter):
            # merge stacked filters, then retry as one conjunction
            return _push_filters(
                Filter(conjoin(conjuncts(plan.pred)
                               + conjuncts(child.pred)), child.child))
        if isinstance(child, (CrowdJoin, MultiJoin)):
            kids = list(child.children())
            residual = []
            for term in conjuncts(plan.pred):
                cols = term.columns()
                placed = False
                for i, kid in enumerate(kids):
                    if cols <= kid.columns():
                        kids[i] = _push_filters(Filter(term, kid))
                        placed = True
                        break
                if not placed:
                    residual.append(term)
            if isinstance(child, CrowdJoin):
                joined: Plan = CrowdJoin(kids[0], kids[1], child.threshold)
            else:
                joined = MultiJoin(kids, child.threshold)
            rest = conjoin(residual)
            return joined if rest is None else Filter(rest, joined)
        if isinstance(child, Project):
            # predicates on a projection's output are predicates on its
            # input — swap so the filter keeps sinking
            return Project(child.cols,
                           _push_filters(Filter(plan.pred, child.child)))
        return Filter(plan.pred, child)
    return plan


# -- crowd-cost estimation ---------------------------------------------------

def _sample_rows(coll_emb: np.ndarray, mask: np.ndarray, sample: int,
                 seed: int) -> np.ndarray:
    idx = np.nonzero(mask)[0]
    if len(idx) > sample:
        rng = np.random.default_rng(seed)
        idx = rng.choice(idx, size=sample, replace=False)
    emb = np.asarray(coll_emb, np.float32)[idx]
    norm = np.linalg.norm(emb, axis=1, keepdims=True)
    return emb / np.maximum(norm, 1e-30)


def _pair_selectivity(a: np.ndarray, b: np.ndarray,
                      threshold: float) -> float:
    """Estimated fraction of cross pairs at/above the cosine threshold."""
    if len(a) == 0 or len(b) == 0:
        return 0.0
    return float((a @ b.T >= threshold).mean())


def expected_crowd_cost(sizes: List[int], sel: np.ndarray,
                        order: List[int]) -> float:
    """Expected-cost proxy of executing ``order``: each new leg scores
    against the whole accumulated universe, so a stage's candidate count is
    its new cross pairs.  The total is order-invariant; what ordering buys
    is *when* candidates arrive — stages meeting more already-resolved
    structure deduce more and ask the crowd less — so the proxy weights
    early stages heavier, sorting expensive legs to the back."""
    cost = 0.0
    seen: List[int] = []
    for k, i in enumerate(order):
        stage = sum(sizes[i] * sizes[j] * sel[i, j] for j in seen)
        # later stages deduce against more resolved structure: weight
        # earlier stages heavier so expensive legs sort to the back
        cost += stage * (len(order) - k)
        seen.append(i)
    return cost


def _order_join(plan: MultiJoin, sample: int, seed: int) -> MultiJoin:
    legs_rows = []
    for kid in plan.inputs:
        got = leg(kid)
        if got is None:
            return plan  # nested non-leg input: leave the order alone
        legs_rows.append(got)
    n = len(plan.inputs)
    sampled = [_sample_rows(coll.embeddings, mask, sample, seed + i)
               for i, (coll, mask) in enumerate(legs_rows)]
    sizes = [int(mask.sum()) for _, mask in legs_rows]
    sel = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            sel[i, j] = sel[j, i] = _pair_selectivity(
                sampled[i], sampled[j], plan.threshold)
    # greedy: start from the cheapest pair, then append the leg adding the
    # fewest expected candidates against the accumulated set
    pairs = [(sizes[i] * sizes[j] * sel[i, j], i, j)
             for i in range(n) for j in range(i + 1, n)]
    _, i0, j0 = min(pairs)
    order = [i0, j0]
    remaining = [k for k in range(n) if k not in order]
    while remaining:
        best = min(remaining, key=lambda k: sum(
            sizes[k] * sizes[j] * sel[k, j] for j in order))
        order.append(best)
        remaining.remove(best)
    return MultiJoin([plan.inputs[k] for k in order], plan.threshold)


def _order_joins(plan: Plan, sample: int, seed: int) -> Plan:
    if isinstance(plan, Filter):
        return Filter(plan.pred, _order_joins(plan.child, sample, seed))
    if isinstance(plan, Project):
        return Project(plan.cols, _order_joins(plan.child, sample, seed))
    if isinstance(plan, MultiJoin):
        ordered = MultiJoin([_order_joins(c, sample, seed)
                             for c in plan.inputs], plan.threshold)
        return _order_join(ordered, sample, seed)
    if isinstance(plan, CrowdJoin):
        return CrowdJoin(_order_joins(plan.left, sample, seed),
                         _order_joins(plan.right, sample, seed),
                         plan.threshold)
    return plan


def optimize(plan: Plan, sample: int = 64, seed: int = 0) -> Plan:
    """Flatten nested joins, push machine-checkable filters below the crowd
    join, order multi-way joins by expected crowd cost.  Deterministic in
    ``seed`` (the selectivity estimate subsamples embeddings with it)."""
    return _order_joins(_push_filters(_flatten(plan)), sample, seed)
