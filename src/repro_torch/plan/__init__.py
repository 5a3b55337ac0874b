"""Relational plan layer over the join service (DESIGN.md §14).

A small logical algebra — ``Scan`` / ``Filter`` / ``Project`` /
``CrowdJoin`` / ``MultiJoin`` — optimized (machine-checkable filters pushed
below the crowd join, multi-way joins ordered by expected crowd cost) and
compiled to :class:`repro_torch.serve.join_service.JoinService` submissions
(the port of ``repro/plan``), in
the spirit of the raco logical->physical algebra compiler.  Behind it, a
persistent :class:`ClusterCache` keyed by content fingerprints carries the
transitive clusters the crowd already paid for across queries, so a repeat
query over overlapping collections crowdsources only novel pairs.
"""
from .algebra import (And, Cmp, Collection, CrowdJoin, Filter, IsIn,
                      MultiJoin, Not, Or, Plan, Predicate, Project, Scan,
                      collection_fingerprint, row_fingerprints)
from .cache import ClusterCache
from .executor import PlanExecutor, PlanResult, StageStats
from .optimizer import expected_crowd_cost, optimize

__all__ = [
    "Collection", "Predicate", "Cmp", "IsIn", "And", "Or", "Not",
    "Plan", "Scan", "Filter", "Project", "CrowdJoin", "MultiJoin",
    "row_fingerprints", "collection_fingerprint",
    "ClusterCache", "PlanExecutor", "PlanResult", "StageStats",
    "optimize", "expected_crowd_cost",
]
