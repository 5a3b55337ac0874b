"""End-to-end crowdsourced join operator — the port of
``repro/core/join.py``.

Composes the paper's hybrid human-machine pipeline: candidate pairs (from
the machine phase) -> sorting component -> labeling component (sequential,
parallel, the non-transitive baseline, or the array engine on the card) ->
join result with quality and cost accounting.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.device import DeviceLike

from .cluster_graph import POS
from .crowd import CostModel, Crowd, PerfectCrowd
from .graph import label_parallel_torch
from .labeling import (LabelingResult, label_all_crowdsourced,
                       label_sequential, label_sequential_adaptive)
from .metrics import Quality, quality
from .pairs import PairSet
from .parallel import label_parallel, label_parallel_adaptive
from .sorting import get_order

LABELERS = ("sequential", "parallel", "all", "torch")


@dataclasses.dataclass
class JoinResult:
    labels: np.ndarray           # (P,) bool over candidate pairs
    n_crowdsourced: int
    n_deduced: int
    n_iterations: int
    batch_sizes: list
    n_hits: int
    cost_cents: float
    quality: Optional[Quality]
    wall_seconds: float
    clusters: Optional[dict] = None
    n_conflicts: int = 0           # contradictory crowd answers dropped


def crowdsourced_join(
    candidates: PairSet,
    crowd: Optional[Crowd] = None,
    order: str = "expected",
    labeler: str = "parallel",       # sequential | parallel | all | torch
    cost: Optional[CostModel] = None,
    total_true_matches: Optional[int] = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> JoinResult:
    """Label ``candidates`` with ``crowd`` in the labeling ``order``.

    ``labeler="torch"`` (the reference's ``"jax"``) runs the array engine
    (:func:`~repro_torch.core.graph.label_parallel_torch`) on ``device``, the
    card unless the caller asks for the CPU; the other labelers are host
    code and ignore ``device``.  The engine asks the crowd for each frontier
    pair in ascending index order, one ``ask`` at a time, so a
    ``NoisyCrowd`` draws exactly as it does under the reference."""
    if labeler not in LABELERS:
        raise ValueError(f"unknown labeler {labeler!r}: valid labelers are "
                         f"{list(LABELERS)}")
    crowd = crowd or PerfectCrowd()
    cost = cost or CostModel()
    t0 = time.perf_counter()
    perm = get_order(candidates, order, seed=seed)
    adaptive = order == "adaptive"  # live re-ranking (DESIGN.md §10)

    if labeler == "sequential":
        res = (label_sequential_adaptive(candidates, crowd) if adaptive
               else label_sequential(candidates, perm, crowd))
    elif labeler == "parallel":
        res = (label_parallel_adaptive(candidates, crowd) if adaptive
               else label_parallel(candidates, perm, crowd))
    elif labeler == "all":
        res = label_all_crowdsourced(candidates, crowd)
    else:
        ordered = candidates.take(perm)

        def crowd_fn(idx):
            return np.array([crowd.ask(ordered, int(i)) for i in idx],
                            dtype=np.int32)

        labels_e, crowdsourced_e, rounds, n_conf = label_parallel_torch(
            ordered.u, ordered.v, ordered.n_objects, crowd_fn,
            prior=ordered.likelihood if adaptive else None, device=device)
        # map back to the candidates' indexing
        labels = np.zeros(len(candidates), dtype=bool)
        crowdsourced = np.zeros(len(candidates), dtype=bool)
        labels[perm] = labels_e == POS
        crowdsourced[perm] = crowdsourced_e
        res = LabelingResult(labels, crowdsourced, len(rounds), rounds,
                             n_conflicts=n_conf)

    wall = time.perf_counter() - t0
    q = None
    if candidates.truth is not None:
        ttm = total_true_matches
        if ttm is None:
            ttm = int(candidates.truth.sum())
        q = quality(candidates, res.labels, ttm)

    # the reference builds a ClusterGraph of the matching labels here and
    # discards it (its result carries clusters=None), so the port skips it
    return JoinResult(
        n_conflicts=res.n_conflicts,
        labels=res.labels,
        n_crowdsourced=res.n_crowdsourced,
        n_deduced=res.n_deduced,
        n_iterations=res.n_iterations,
        batch_sizes=res.batch_sizes,
        n_hits=cost.n_hits(res.n_crowdsourced),
        cost_cents=cost.cost_cents(res.n_crowdsourced),
        quality=q,
        wall_seconds=wall,
        clusters=None,
    )
