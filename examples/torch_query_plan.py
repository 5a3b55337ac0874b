"""The relational plan layer and the cross-query cluster cache on the
PyTorch port (DESIGN.md §14): ``examples/query_plan.py`` with
``repro_torch``.

Three product catalogs share an entity universe.  A filtered three-way
crowd join runs twice through the plan layer: the optimizer pushes
machine-checkable filters below the crowd join and orders the legs by
expected crowd cost; the first execution pays the crowd and deposits the
resolved clusters into a ``ClusterCache``; the repeat query seeds its
sessions from the cache and crowdsources only novel pairs.  The join
services run on the card unless ``--device cpu`` says otherwise.

    PYTHONPATH=src python examples/torch_query_plan.py               # card
    PYTHONPATH=src python examples/torch_query_plan.py --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.plan import (ClusterCache, Cmp, Collection, Filter,
                              MultiJoin, PlanExecutor, Project, Scan,
                              optimize)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the join services run: cuda (the default) "
                         "or cpu")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)

    # three catalogs drawn from one entity universe (entities = truth wire
    # for the simulated crowd; a real deployment would omit them)
    n_ent, dim = 20, 16
    cents = rng.normal(size=(n_ent, dim))

    def catalog(name, n):
        ids = rng.integers(0, n_ent, n)
        emb = (cents[ids] + 0.05 * rng.normal(size=(n, dim))).astype(
            np.float32)
        return Collection(name, emb,
                          attrs={"sku": np.arange(n),
                                 "price": rng.integers(5, 100, n),
                                 "region": ids % 3},
                          entities=ids)

    a, b, c = catalog("a", 40), catalog("b", 36), catalog("c", 30)

    # SELECT a.sku, b.sku, c.sku FROM a ⋈ b ⋈ c
    #   WHERE a.price < 60 AND b.region = 0
    plan = Project(
        ("a.sku", "b.sku", "c.sku"),
        Filter(Cmp("a.price", "<", 60),
               Filter(Cmp("b.region", "==", 0),
                      MultiJoin([Scan(a), Scan(b), Scan(c)],
                                threshold=0.80))))

    print("-- logical plan ------------------------------")
    print(plan.describe())
    print("-- optimized (filters pushed, legs ordered) --")
    print(optimize(plan).describe())

    # -- cold query: the crowd pays for everything --------------------------
    cache = ClusterCache()
    ex = PlanExecutor(cache=cache, device=args.device)
    cold = ex.execute(plan)
    print(f"\ncold:  {len(cold.tuples)} tuples, "
          f"candidates={cold.n_candidates}, "
          f"crowdsourced={cold.n_crowdsourced}, "
          f"cache_hits={cold.n_cache_hits}, spent={cold.spent_cents:.0f}c")

    # unoptimized comparison: how many candidates without filter pushdown?
    raw = PlanExecutor(cache=ClusterCache(), optimize_plans=False,
                       device=args.device).execute(plan)
    if raw.signature() != cold.signature():
        raise AssertionError("a rewrite changed the query's result")
    print(f"       (unoptimized plan: {raw.n_candidates} candidates vs "
          f"{cold.n_candidates} pushed-down — same {len(raw.tuples)} tuples)")

    # -- repeat query over the same collections: novel pairs only -----------
    warm = PlanExecutor(cache=cache, device=args.device).execute(plan)
    if warm.signature() != cold.signature():
        raise AssertionError("the warm query's result differs from the cold")
    saved = 1.0 - warm.n_crowdsourced / max(cold.n_crowdsourced, 1)
    print(f"warm:  crowdsourced={warm.n_crowdsourced}, "
          f"cache_hits={warm.n_cache_hits}, spent={warm.spent_cents:.0f}c "
          f"({saved:.0%} crowd questions saved)")

    # -- a different query over overlapping collections still hits ----------
    q2 = Project(("a.sku", "c.sku"),
                 Filter(Cmp("c.price", ">=", 20),
                        MultiJoin([Scan(a), Scan(c)], threshold=0.80)))
    r2 = PlanExecutor(cache=cache, device=args.device).execute(q2)
    print(f"new query (a⋈c, different filter): "
          f"crowdsourced={r2.n_crowdsourced}, cache_hits={r2.n_cache_hits}, "
          f"spent={r2.spent_cents:.0f}c — overlap pays nothing twice")


if __name__ == "__main__":
    main()
