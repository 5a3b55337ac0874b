"""JoinService — join requests served over the on-device round engine (the
port of ``repro/serve/join_service.py``'s round-barrier discipline).

Requests queue up and are packed into up to ``lanes`` session lanes.  Each
lane carries a :class:`~repro_torch.core.graph.SessionState` on the service's
device, packed once at lane open (after folding any ``seed_labels``).  Two
paths advance the lanes, as in the reference:

* **Fused** (DESIGN.md §13): when every lane's crowd answers do not depend on
  the order they are asked in (a :class:`~repro_torch.core.crowd.PerfectCrowd`
  with ground truth), the lanes grow to one shared capacity bucket, stack
  into one batch, and ``session_run_rounds_batch`` advances them
  ``FUSED_ROUNDS_PER_DISPATCH`` rounds per call; the gateway traffic is
  replayed after the device rounds.  A lane whose §9 conflict screen fires
  leaves the fused path for good and replays that round exactly.
* **Per round** (``_step``, and every lane once ``fused_rounds=False``, a
  crowd such as :class:`~repro_torch.core.crowd.NoisyCrowd` or a latency
  model is served): each round refreshes adaptive priorities, selects the
  frontier over bucket-grouped stacked states, posts every lane's frontier
  to the gateway (ballots drawn lane by lane, pair indices ascending),
  drains it (the round barrier: under a latency model the platform clock
  runs until the last answer lands), and folds the answers with the
  conflict-screened fold, replaying exactly only the lanes whose screen
  fired.

Lanes are refilled from the queue as sessions finish.

**Crowd economics** (DESIGN.md §9, §10, §15), all on the per-round path:
a budgeted request (``budget_cents`` / ``cost_per_assignment``) posts only
what its remaining budget affords, highest expected-deduction gain first,
and stops on budget by trusting the graph for the rest; ``slots_per_round``
caps the questions a round across every lane, by gain.
``conflict_policy="requery"`` re-posts a rejected answer with an escalated
ballot (3-way to 5-way) and trusts the graph once the escalation is
exhausted.  ``aggregation="em"`` collapses ballots by the gateway's
reliability model; ``cluster_tasks=True`` posts CrowdER-style cluster tasks
where their expected correct labels a cent beat the pair rate.

**Asynchronous ID/NF** (``async_mode=True``, the paper's §5.2 lifted into
serving): a lane folds answers the moment the gateway delivers them; a
returned non-matching answer, a rejected one or a drained lane triggers
deduce + re-frontier + post at once (instant decision), and with ``nf=True``
the gateway's workers take probable-non-matching pairs first.  With a
:class:`~repro_torch.core.crowd.LatencyModel` attached, ``sim_minutes`` on
the results is the simulated platform clock at completion.  With an
immediate gateway and nothing in flight the discipline degenerates to round
barriers, and the fused path runs them.

:meth:`submit_embeddings` runs the machine phase first, then queues the
candidates as a :class:`~repro_torch.core.pairs.PairSet` like any request.
By default it is dense: the pair-score kernel over the whole (emb_a x emb_b)
grid, thresholded candidates compacted after it.  With ``blocking=`` (a
:class:`~repro_torch.kernels.pair_scores.blocking.BlockingConfig`) LSH
buckets are built on the host and only colliding tile pairs are scored,
through the fused compaction kernel, so the dense grid never exists.

**Streaming ingest** (DESIGN.md §11): a join's candidates may arrive over
epochs while it runs.  :meth:`JoinService.submit_stream` opens a request
with its first epoch and queues the rest (all ingested before labeling
starts, or one an engine round with ``interleave=True``);
:meth:`JoinService.append` queues one more epoch for an open request.
``submit_embeddings(..., streaming=True)`` keeps the scored corpus in a
:class:`~repro_torch.kernels.pair_scores.sharded.StreamingCandidateIndex`
on the service's device (dense, or LSH-blocked with ``blocking=``), and
:meth:`JoinService.append_embeddings` scores only the cells new rows add.
An epoch grows the live lane in place (``session_grow`` then
``session_append_pairs``): existing pair slots never move, so in-flight
crowd work, budgets and requery ladders carry over.

**Durable serving** (DESIGN.md §16): with ``checkpoint_dir`` set, every
``checkpoint_every``-th pass of the run loop commits the whole serving state
(lanes pulled to the host, the queue, results, arrival epochs, the gateway's
tickets and ledgers, the admission envelope) through
:class:`~repro_torch.train.checkpoint.CheckpointManager`;
:meth:`JoinService.restore` rebuilds the service from the latest one on any
device, and its :meth:`run` resumes mid-wave with labels, spend and
``sim_minutes`` identical to an uninterrupted run.  An
:class:`AdmissionPolicy` caps the queue and a service-wide crowd-spend
envelope; a submission it cannot admit is shed with :class:`AdmissionError`.

**Cross-query cache** (DESIGN.md §14): with a ``cluster_cache`` (or a
``cache_path`` it persists to), :meth:`submit_embeddings` fingerprints the
candidate rows, seeds the request from the verdicts the cache already holds,
and deposits the finished session's verdicts back.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cluster_graph import POS, UNKNOWN
from repro_torch.core.crowd import (CostModel, Crowd, CrowdGateway,
                                    LatencyModel, PerfectCrowd)
from repro_torch.core.graph import (ROUNDS_CONFLICT, ROUNDS_EMPTY,
                                    SessionState, index_state,
                                    make_session_state, next_pow2,
                                    pair_keys_fit, session_apply_answers,
                                    session_deduce, session_fold_answers,
                                    session_fold_answers_batch,
                                    session_append_pairs, session_frontier,
                                    session_frontier_batch, session_grow,
                                    session_mark_published,
                                    session_mark_published_batch,
                                    session_run_rounds_batch,
                                    session_seed_labels, session_trust_graph,
                                    session_trust_graph_batch, stack_states)
from repro_torch.core.ordering import (session_gains, session_gains_batch,
                                       session_refresh_priorities,
                                       session_refresh_priorities_batch)
from repro_torch.core.metrics import Quality, quality
from repro_torch.core.pairs import PairSet
from repro_torch.core.sorting import get_order, validate_order
from repro_torch.device import DeviceLike, pick_device
from repro_torch.kernels.pair_scores.blocking import (BlockingConfig,
                                                      blocked_candidates)
from repro_torch.kernels.pair_scores.sharded import (StreamingCandidateIndex,
                                                     sharded_candidates)


@dataclasses.dataclass
class AdmissionPolicy:
    """Global admission envelope for new submissions (DESIGN.md §16).

    ``max_pending`` caps the submit queue: with the lanes busy and the queue
    full, further submits shed with :class:`AdmissionError` instead of
    growing an unbounded backlog.  ``global_budget_cents`` is a service-wide
    crowd-spend envelope: each admitted request reserves its budget against
    it (a request without a budget of its own is clamped to what remains,
    reported as ``JoinSessionResult.envelope_clamped``), and a submission
    the exhausted envelope cannot fund is shed."""

    max_pending: Optional[int] = None
    global_budget_cents: Optional[float] = None


class AdmissionError(RuntimeError):
    """A submission was shed by the admission envelope (DESIGN.md §16): the
    queue is at ``max_pending`` or the crowd-budget envelope has no cents
    left to reserve.  Nothing was enqueued."""


class ServiceKilled(RuntimeError):
    """An injected crash: raised right after a checkpoint commits when
    ``JoinService._crash_after_checkpoints`` is set, so a run dies at a
    known point with a restorable checkpoint on disk."""


@dataclasses.dataclass
class _EmbeddingStream:
    """A streaming request's incremental machine phase (DESIGN.md §11): the
    cached scoring index and the row -> object id maps.  Ids are assigned
    at arrival (the first corpus keeps a-row i -> i, b-row j -> n_a + j), so
    appended rows never collide with ids the live session already uses."""

    index: StreamingCandidateIndex
    truth_fn: Optional[object]     # truth_fn(rows, cols) over global rows
    ids_a: np.ndarray              # (N,) int32 object id per a-row
    ids_b: np.ndarray              # (M,) int32 object id per b-row
    next_id: int                   # first unassigned object id


@dataclasses.dataclass
class JoinRequest:
    """One join submission, resolved to the service defaults at admit."""

    rid: Optional[int]
    pairs: PairSet
    crowd: Optional[Crowd] = None
    order: Optional[str] = None
    total_true_matches: Optional[int] = None
    # budget-aware scheduling (DESIGN.md §10): crowd spend capped at
    # budget_cents, priced per assignment; None -> the service default
    budget_cents: Optional[float] = None
    cost_per_assignment: Optional[float] = None
    # cross-query warm start (DESIGN.md §14): (P,) int32 {UNKNOWN, NEG, POS}
    # in the request's pair order, folded at lane open and never billed
    seed_labels: Optional[np.ndarray] = None
    # admission provenance (DESIGN.md §16), set by the service: whether the
    # request waited behind fully occupied lanes, and whether its budget
    # was clamped to the remaining spend envelope
    admission_deferred: bool = False
    envelope_clamped: bool = False


@dataclasses.dataclass
class JoinSessionResult:
    """Served outcome of one join request — the reference's fields."""

    rid: int
    labels: np.ndarray             # (P,) bool over the request's pairs
    crowdsourced: np.ndarray       # (P,) bool
    n_rounds: int
    round_sizes: List[int]
    n_hits: int
    cost_cents: float
    quality: Optional[Quality]
    wall_seconds: float
    sim_minutes: Optional[float] = None
    fold_rounds: int = 0
    n_conflicts: int = 0
    n_requeried: int = 0
    n_spent_cents: float = 0.0
    stopped_on_budget: bool = False
    n_cache_hits: int = 0
    n_cluster_tasks: int = 0
    n_cluster_pairs: int = 0
    n_cluster_cents: float = 0.0
    admission_deferred: bool = False
    envelope_clamped: bool = False

    @property
    def n_crowdsourced(self) -> int:
        """Pairs answered by the crowd."""
        return int(self.crowdsourced.sum())

    @property
    def n_deduced(self) -> int:
        """Pairs labeled by transitive deduction instead of the crowd."""
        return len(self.labels) - self.n_crowdsourced


@dataclasses.dataclass
class _Lane:
    req: JoinRequest
    perm: np.ndarray               # labeling order over the request's pairs
    ordered: PairSet               # req.pairs.take(perm)
    p: int                         # true pair count (before padding)
    state: SessionState            # on the service's device
    labels_host: np.ndarray        # (p,) int32 host mirror
    crowdsourced: np.ndarray       # (p,) bool, ordered
    round_sizes: List[int]
    t0: float
    prior_host: np.ndarray         # (p_cap,) f32 machine likelihood, padded
    # its device copy, for the asynchronous discipline's single-lane priority
    # refresh and gains (adaptive or budgeted lanes only)
    prior_dev: Optional[torch.Tensor]
    adaptive: bool                 # live posterior re-ranking (DESIGN.md §10)
    rate_cents: float              # per-assignment price
    per_pair_cents: float          # expected price of one crowd question
    budget_cents: Optional[float]  # None = unlimited
    # host mirror of the pair slots with an unanswered gateway task out
    # (pair or cluster): the cluster planner must not cover a pair twice
    inflight_host: np.ndarray
    # the crowd's order-independent answer per ordered pair (None when it
    # depends on the order asked), and whether the fused path is still
    # trusted for this lane: a §9 screen on it drops the lane to the exact
    # per-round path for good
    answers_host: Optional[np.ndarray] = None
    fused_ok: bool = True
    n_cache_hits: int = 0          # pairs settled by seed labels at open
    in_flight: int = 0             # pairs posted to the gateway, unanswered
    n_requeried: int = 0           # escalated re-posts of rejected answers
    budget_stopped: bool = False   # out of budget; the graph resolved the rest
    n_cluster_tasks: int = 0
    n_cluster_cents: float = 0.0

    @property
    def done(self) -> bool:
        if self.budget_stopped:
            return self.in_flight == 0
        return not (self.labels_host == UNKNOWN).any()

    @property
    def bucket(self) -> Tuple[int, int]:
        """(pair capacity, object capacity): lanes stack by bucket."""
        return (int(self.state.u.shape[0]), self.state.n_objects)

    def affordable(self, gateway: CrowdGateway) -> Optional[int]:
        """How many more crowd questions the budget buys (None: unlimited):
        the remaining cents floor-divided by a question's price."""
        if self.budget_cents is None or self.per_pair_cents <= 0:
            return None
        rem = self.budget_cents - gateway.spent_cents(self.req.rid)
        return max(int(rem // self.per_pair_cents), 0)


class JoinService:
    """Accepts join requests; drives frontier -> crowd -> deduce over up to
    ``lanes`` device-resident session states on ``device`` (the card unless
    ``"cpu"`` is asked for).  ``order`` is the default labeling order;
    ``cost`` prices crowd questions; ``fused_rounds=False`` keeps every lane
    on the per-round path.  ``latency`` attaches the simulated asynchronous
    crowd platform; ``async_mode=True`` serves the event-driven ID/NF
    discipline instead of round barriers; ``nf`` steers the platform's
    workers to probable-non-matching pairs first (it needs a latency model).
    ``conflict_policy`` resolves rejected answers (``"drop"`` or
    ``"requery"``); ``budget_cents`` / ``cost_per_assignment`` are request
    defaults; ``slots_per_round`` caps a round's questions across lanes;
    ``aggregation`` (``"majority"`` or ``"em"``) collapses ballots;
    ``cluster_tasks`` posts tasks of up to ``cluster_size`` objects, each
    partitioned by ``cluster_assignments`` workers.  ``admission`` is the
    :class:`AdmissionPolicy`; ``cluster_cache`` (or ``cache_path``, loaded
    when the file exists and saved after every deposit) is the cross-query
    :class:`~repro_torch.plan.cache.ClusterCache`; ``checkpoint_dir``,
    ``checkpoint_every`` and ``checkpoint_keep`` make the serving state
    durable (see :meth:`restore`)."""

    # rounds per round-engine call
    FUSED_ROUNDS_PER_DISPATCH = 8

    def __init__(self, lanes: int = 4, cost: Optional[CostModel] = None,
                 latency: Optional[LatencyModel] = None,
                 async_mode: bool = False, nf: bool = False,
                 conflict_policy: str = "drop", order: str = "expected",
                 budget_cents: Optional[float] = None,
                 cost_per_assignment: Optional[float] = None,
                 slots_per_round: Optional[int] = None,
                 fused_rounds: bool = True, aggregation: str = "majority",
                 cluster_tasks: bool = False, cluster_size: int = 8,
                 cluster_assignments: int = 2,
                 admission: Optional[AdmissionPolicy] = None,
                 cluster_cache=None, cache_path: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1, checkpoint_keep: int = 3,
                 device: DeviceLike = None):
        if conflict_policy not in ("drop", "requery"):
            raise ValueError(
                f"conflict_policy must be 'drop' or 'requery', "
                f"got {conflict_policy!r}")
        if nf and latency is None:
            raise ValueError(
                "nf=True requires a LatencyModel: non-matching-first steers "
                "worker pickup order, which does not exist in immediate mode")
        validate_order(order)
        if slots_per_round is not None and slots_per_round < 1:
            raise ValueError(
                f"slots_per_round must be positive, got {slots_per_round} — "
                "a zero-slot round could never make progress")
        if aggregation not in ("majority", "em"):
            raise ValueError(
                f"aggregation must be 'majority' or 'em', got "
                f"{aggregation!r}")
        if cluster_size < 3:
            raise ValueError(
                f"cluster_size must be at least 3, got {cluster_size} — a "
                "2-object task is just a pair question at cluster pricing")
        if cluster_assignments < 1:
            raise ValueError(
                f"cluster_assignments must be positive, "
                f"got {cluster_assignments}")
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be positive, got {checkpoint_every}"
                " — a non-positive cadence would never checkpoint")
        if lanes < 1:
            raise ValueError(f"lanes must be positive, got {lanes}")
        self.lanes = lanes
        self.cost = cost or CostModel()
        self.latency = latency
        self.async_mode = async_mode
        self.nf = nf
        self.conflict_policy = conflict_policy
        self.order = order
        self.budget_cents = budget_cents
        self.cost_per_assignment = cost_per_assignment
        self.slots_per_round = slots_per_round
        self.aggregation = aggregation
        self.cluster_tasks = cluster_tasks
        self.cluster_size = cluster_size
        self.cluster_assignments = cluster_assignments
        self.fused_rounds = fused_rounds
        self.device = pick_device(device)
        self.queue: Deque[JoinRequest] = collections.deque()
        self.results: Dict[int, JoinSessionResult] = {}
        self._next_rid = 0
        # per-round group caches, keyed by capacity bucket: while a group's
        # membership holds, its stacked state IS its lanes' state (written
        # back when membership changes or a lane finishes), and its stacked
        # machine priors are uploaded once
        self._stacks: Dict[Tuple[int, int],
                           Tuple[Tuple[_Lane, ...], SessionState]] = {}
        self._prior_stacks: Dict[Tuple[int, int],
                                 Tuple[Tuple[_Lane, ...], torch.Tensor]] = {}
        # streaming ingest (DESIGN.md §11): arrival epochs queued per rid,
        # consumed at the lane's next ingest point (one an engine round for
        # an interleaved stream), and the cached index of each
        # submit_embeddings(..., streaming=True) request
        self._pending_arrivals: Dict[int, Deque[PairSet]] = {}
        self._stream_interleave: Dict[int, bool] = {}
        self._streams: Dict[int, _EmbeddingStream] = {}
        # admission control (DESIGN.md §16): the shed counter, and the
        # envelope's finalized spend plus the budgets reserved by admitted
        # requests not yet finished
        self.admission = admission
        self.n_shed = 0
        self._envelope_spent = 0.0
        self._envelope_reserved = 0.0
        # the cross-query cluster cache (DESIGN.md §14): submit_embeddings
        # seeds from it, _finalize deposits into it (and saves to
        # cache_path); the fingerprints of each request's candidate rows
        if cluster_cache is None and cache_path is not None:
            from repro_torch.plan.cache import ClusterCache
            cluster_cache = (ClusterCache.load(cache_path)
                             if os.path.exists(cache_path) else ClusterCache())
        self.cluster_cache = cluster_cache
        self.cache_path = cache_path
        self._cache_fps: Dict[int, Tuple[List[str], List[str]]] = {}
        # durable serving state (DESIGN.md §16): checkpoints of the run
        # loop through train/checkpoint.py; _crash_after_checkpoints is the
        # kill switch of the recovery tests and the chip script
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.checkpoint_keep = checkpoint_keep
        self._ckpt = None
        if checkpoint_dir is not None:
            from repro_torch.train.checkpoint import CheckpointManager
            self._ckpt = CheckpointManager(checkpoint_dir,
                                           keep=checkpoint_keep)
        self._ckpt_step = 0
        self._ckpt_tick = 0
        self._crash_after_checkpoints: Optional[int] = None
        self._resume: Optional[Tuple[List[_Lane], CrowdGateway]] = None
        self.last_recovery: Optional[dict] = None

    # -- request ingestion ---------------------------------------------------
    def _admit(self, req: JoinRequest) -> int:
        """Resolve defaults, validate, assign the rid and enqueue.  Under an
        :class:`AdmissionPolicy` a submit that finds the queue at
        ``max_pending`` or the spend envelope empty is shed (counted in
        ``n_shed``, raised as :class:`AdmissionError`, nothing enqueued);
        an admitted request reserves its budget against the envelope,
        clamped to what remains (``envelope_clamped``)."""
        remaining = None
        if self.admission is not None:
            pol = self.admission
            if pol.max_pending is not None and \
                    len(self.queue) >= pol.max_pending:
                self.n_shed += 1
                raise AdmissionError(
                    f"admission queue full ({len(self.queue)} >= "
                    f"max_pending={pol.max_pending}) — request shed; retry "
                    "after sessions finish")
            if pol.global_budget_cents is not None:
                remaining = (pol.global_budget_cents - self._envelope_spent
                             - self._envelope_reserved)
                if remaining <= 1e-9:
                    self.n_shed += 1
                    raise AdmissionError(
                        "crowd-budget envelope exhausted "
                        f"({pol.global_budget_cents:.2f} cents committed) — "
                        "request shed")
        req.order = validate_order(self.order if req.order is None
                                   else req.order)
        if req.crowd is None:
            req.crowd = PerfectCrowd()
        if req.budget_cents is None:
            req.budget_cents = self.budget_cents
        if req.cost_per_assignment is None:
            req.cost_per_assignment = self.cost_per_assignment
        if req.seed_labels is not None and \
                len(req.seed_labels) != len(req.pairs):
            raise ValueError(
                f"seed_labels length {len(req.seed_labels)} != pair count "
                f"{len(req.pairs)} — seeds are per-pair verdicts in the "
                "request's pair order")
        if req.rid is None:
            req.rid = self._next_rid
        elif req.rid in self.results or \
                any(r.rid == req.rid for r in self.queue):
            raise ValueError(
                f"duplicate join request rid {req.rid}: already "
                f"{'served' if req.rid in self.results else 'queued'}")
        self._next_rid = max(self._next_rid, req.rid) + 1
        if remaining is not None:
            if req.budget_cents is None or req.budget_cents > remaining:
                req.budget_cents = remaining
                req.envelope_clamped = True
            self._envelope_reserved += req.budget_cents
        self.queue.append(req)
        return req.rid

    def submit(self, pairs: PairSet, crowd: Optional[Crowd] = None,
               order: Optional[str] = None, rid: Optional[int] = None,
               total_true_matches: Optional[int] = None,
               budget_cents: Optional[float] = None,
               cost_per_assignment: Optional[float] = None,
               seed_labels: Optional[np.ndarray] = None) -> int:
        """Enqueue a join over pre-scored candidate pairs; returns the rid.
        ``total_true_matches`` is the dataset-wide true-match count for
        recall (default: the candidates' own).  ``order``, ``budget_cents``
        and ``cost_per_assignment`` default to the service's.
        ``seed_labels`` warm-starts the session from cached verdicts
        (DESIGN.md §14)."""
        return self._admit(JoinRequest(
            rid, pairs, crowd, order, total_true_matches,
            budget_cents=budget_cents,
            cost_per_assignment=cost_per_assignment,
            seed_labels=seed_labels))

    @staticmethod
    def _check_candidate_overflow(cand) -> None:
        """Capacity overflow is never silent; the error reports a capacity
        that provably fits."""
        if cand.n_dropped:
            raise RuntimeError(
                f"candidate buffers overflowed: {cand.n_dropped} candidates "
                f"dropped at capacity {cand.capacity} — re-submit with "
                f"capacity={cand.suggested_capacity} or raise the threshold")

    def submit_embeddings(self, emb_a: torch.Tensor, emb_b: torch.Tensor,
                          threshold: float, mesh=None,
                          crowd: Optional[Crowd] = None, truth_fn=None,
                          order: Optional[str] = None,
                          capacity: Optional[int] = None,
                          total_true_matches: Optional[int] = None,
                          blocking: Optional[BlockingConfig] = None,
                          budget_cents: Optional[float] = None,
                          cost_per_assignment: Optional[float] = None,
                          streaming: bool = False) -> int:
        """Machine phase + enqueue: score (emb_a x emb_b) with the pair-score
        kernel, keep pairs at or above ``threshold`` (cosine, mapped to a
        [0, 1] likelihood), and queue the session.  The embeddings move to
        the service's device.  ``mesh`` is ``None`` or ``(1, 1)``.

        ``truth_fn(rows, cols) -> bool array`` attaches ground truth.
        ``capacity`` bounds the candidate buffer (default: lossless).  Object
        ids: a-row i -> i, b-row j -> N + j.

        ``blocking`` (a :class:`BlockingConfig`, DESIGN.md §12) puts the LSH
        blocking stage in front of the scorer: only bucket-colliding pairs
        are scored, through the fused compaction kernel, on the service's
        device (``mesh`` is ignored).  It trades recall at the threshold for
        scored cells; size it with ``BlockingConfig.for_recall``.
        ``budget_cents`` and ``cost_per_assignment`` as for :meth:`submit`.

        ``streaming=True`` keeps the scored corpus in a
        :class:`StreamingCandidateIndex` on the service's device, so later
        :meth:`append_embeddings` calls score only the cells new rows add
        (with ``blocking=``, arrivals hash into the existing buckets);
        ``truth_fn`` is kept and must then take global row and column
        indices into the grown corpora.  A capacity overflow rolls the
        index back before it raises.

        With a ``cluster_cache`` the candidate rows are fingerprinted (their
        f32 bytes, on the host), the request is seeded from the verdicts the
        cache holds, and its verdicts are deposited back when it
        finishes."""
        emb_a = torch.as_tensor(emb_a, device=self.device)
        emb_b = torch.as_tensor(emb_b, device=self.device)
        if streaming:
            index = StreamingCandidateIndex(threshold, mesh,
                                            capacity=capacity,
                                            blocking=blocking,
                                            device=self.device)
            cand = index.append(emb_a, emb_b)
            if cand.n_dropped:
                # reject before the overflow surfaces: a retry at the
                # suggested capacity must not find the corpus "already seen"
                index.rollback_append()
        elif blocking is not None:
            cand = blocked_candidates(emb_a, emb_b, threshold,
                                      config=blocking, capacity=capacity)
        else:
            cand = sharded_candidates(emb_a, emb_b, threshold, mesh,
                                      capacity=capacity)
        self._check_candidate_overflow(cand)
        n_a = int(emb_a.shape[0])
        n_b = int(emb_b.shape[0])
        truth = None
        if truth_fn is not None:
            truth = np.asarray(truth_fn(cand.rows, cand.cols), bool)
        pairs = PairSet(u=cand.rows, v=cand.cols + n_a,
                        likelihood=(cand.scores + 1.0) / 2.0, truth=truth,
                        n_objects=n_a + n_b)
        seed_labels = None
        fps = None
        if self.cluster_cache is not None:
            # warm-start from the cached verdicts, and keep the fingerprints
            # for _finalize's deposit (an all-UNKNOWN seed folds nothing)
            from repro_torch.plan.algebra import row_fingerprints
            fa = row_fingerprints(emb_a)
            fb = row_fingerprints(emb_b)
            fps = ([fa[int(i)] for i in np.asarray(cand.rows)],
                   [fb[int(j)] for j in np.asarray(cand.cols)])
            seed_labels = self.cluster_cache.seed(fps[0], fps[1])
        rid = self._admit(JoinRequest(
            None, pairs, crowd, order, total_true_matches,
            budget_cents=budget_cents,
            cost_per_assignment=cost_per_assignment,
            seed_labels=seed_labels))
        if fps is not None:
            self._cache_fps[rid] = fps
        if streaming:
            self._streams[rid] = _EmbeddingStream(
                index=index, truth_fn=truth_fn,
                ids_a=np.arange(n_a, dtype=np.int32),
                ids_b=np.arange(n_a, n_a + n_b, dtype=np.int32),
                next_id=n_a + n_b)
        return rid

    # -- streaming ingest (DESIGN.md §11) ------------------------------------
    def append(self, rid: int, pairs: PairSet) -> None:
        """Queue an arrival epoch for an open streaming request: the pairs
        (ids in the request's object universe; new ids allowed) are folded
        into the live lane at its next ingest point.  The session grows in
        place; in-flight crowd work and budget accounting carry over.  An
        empty epoch is a no-op."""
        if rid in self.results:
            raise ValueError(
                f"cannot append to rid {rid}: the request already finished "
                "— submit the new pairs as a fresh request")
        if not any(r.rid == rid for r in self.queue) and \
                rid not in self._pending_arrivals:
            raise ValueError(f"cannot append to unknown rid {rid}")
        if len(pairs) == 0:
            return
        self._pending_arrivals.setdefault(rid,
                                          collections.deque()).append(pairs)

    def submit_stream(self, epochs, crowd: Optional[Crowd] = None,
                      order: Optional[str] = None, rid: Optional[int] = None,
                      total_true_matches: Optional[int] = None,
                      budget_cents: Optional[float] = None,
                      cost_per_assignment: Optional[float] = None,
                      interleave: bool = False) -> int:
        """Enqueue a join whose candidate pairs arrive over k epochs.  The
        first epoch opens the request; the rest are queued as arrivals.
        Under the default up-front schedule every epoch is ingested before
        labeling begins and the grown state equals one built from the
        concatenated pairs, so the run matches a single :meth:`submit` of
        the concatenation label for label, root for root and crowdsourced
        pair for pair.  ``interleave=True`` releases one epoch an engine
        round instead, so arrivals land while earlier answers are in flight
        (the schedule, and so the counts, differ from the batch run; labels
        stay exact and budgets and tickets carry over)."""
        epochs = list(epochs)
        if not epochs:
            raise ValueError("submit_stream needs at least one epoch")
        rid = self.submit(epochs[0], crowd, order, rid, total_true_matches,
                          budget_cents=budget_cents,
                          cost_per_assignment=cost_per_assignment)
        self._stream_interleave[rid] = interleave
        for epoch in epochs[1:]:
            self.append(rid, epoch)
        return rid

    def append_embeddings(self, rid: int, new_a=None, new_b=None) -> None:
        """Incremental machine phase + append: score the arriving rows
        against the cached corpus (the new cells only), give the new rows
        fresh object ids, and queue the candidates as an arrival epoch for
        ``rid``, which must have been submitted with ``streaming=True``.
        An overflowing epoch is rolled back before the error surfaces, so
        the stream stays usable."""
        stream = self._streams.get(rid)
        if stream is None:
            raise ValueError(
                f"rid {rid} has no cached embedding index — submit it with "
                "submit_embeddings(..., streaming=True)")
        cand = stream.index.append(new_a, new_b)
        if cand.n_dropped:
            # the index must forget rows whose candidates were never
            # ingested, or the row -> id maps desync and every later epoch
            # skips the ghost rows
            stream.index.rollback_append()
            raise RuntimeError(
                f"candidate buffers overflowed: {cand.n_dropped} candidates "
                f"dropped at capacity {cand.capacity} — the epoch was rolled "
                "back (the stream stays usable); re-submit the request with "
                f"capacity={cand.suggested_capacity} or split the arrival "
                "into smaller epochs")
        for side, new in (("a", new_a), ("b", new_b)):
            if new is not None and len(new):
                fresh = np.arange(stream.next_id, stream.next_id + len(new),
                                  dtype=np.int32)
                ids = getattr(stream, f"ids_{side}")
                setattr(stream, f"ids_{side}", np.concatenate([ids, fresh]))
                stream.next_id += len(new)
        truth = None
        if stream.truth_fn is not None:
            truth = np.asarray(stream.truth_fn(cand.rows, cand.cols), bool)
        self.append(rid, PairSet(
            u=stream.ids_a[cand.rows], v=stream.ids_b[cand.cols],
            likelihood=(cand.scores + 1.0) / 2.0, truth=truth,
            n_objects=stream.next_id))

    # -- lane lifecycle ------------------------------------------------------
    def _open_lane(self, req: JoinRequest) -> _Lane:
        perm = get_order(req.pairs, req.order)
        ordered = req.pairs.take(perm)
        P = len(ordered)
        # capacity buckets: powers of two, at least 8
        p_cap = next_pow2(P, 8)
        n_cap = next_pow2(ordered.n_objects, 8)
        # keys are lo * n + hi, int64 past 46340 objects, as the reference's
        # under x64: bucketing must not push n past the 63-bit range when
        # the raw size still fits
        if not pair_keys_fit(n_cap):
            n_cap = ordered.n_objects
        state = make_session_state(ordered.u, ordered.v, ordered.n_objects,
                                   pair_capacity=p_cap, object_capacity=n_cap,
                                   device=self.device)
        labels_host = np.full(P, UNKNOWN, np.int32)
        n_cache_hits = 0
        if req.seed_labels is not None:
            # fold the seeds before the first frontier: seeded pairs, and
            # what deduction reaches from them, are never posted or billed
            seeds = np.full(p_cap, UNKNOWN, np.int32)
            seeds[:P] = np.asarray(req.seed_labels, np.int32)[perm]
            if (seeds != UNKNOWN).any():
                state, cmask = session_seed_labels(state, seeds)
                n_cache_hits = int(((seeds[:P] != UNKNOWN)
                                    & ~cmask[:P].cpu().numpy()).sum())
                labels_host = state.labels[:P].cpu().numpy()
        prior_host = np.zeros(p_cap, np.float32)
        prior_host[:P] = ordered.likelihood
        adaptive = req.order == "adaptive"
        rate = (req.cost_per_assignment if req.cost_per_assignment is not None
                else self.cost.cents_per_assignment)
        return _Lane(
            req=req, perm=perm, ordered=ordered, p=P, state=state,
            labels_host=labels_host, crowdsourced=np.zeros(P, bool),
            round_sizes=[], t0=time.perf_counter(), prior_host=prior_host,
            prior_dev=(torch.from_numpy(prior_host).to(self.device)
                       if self.async_mode and (
                           adaptive or req.budget_cents is not None)
                       else None),
            adaptive=adaptive, rate_cents=float(rate),
            per_pair_cents=float(rate)
            * getattr(req.crowd, "n_assignments", 1),
            budget_cents=req.budget_cents,
            inflight_host=np.zeros(p_cap, bool),
            answers_host=req.crowd.precomputed_answers(ordered),
            n_cache_hits=n_cache_hits)

    def _finalize(self, lane: _Lane, gateway: CrowdGateway) -> None:
        req = lane.req
        P = len(req.pairs)
        labels = np.zeros(P, bool)
        crowdsourced = np.zeros(P, bool)
        labels[lane.perm] = lane.labels_host == POS
        crowdsourced[lane.perm] = lane.crowdsourced
        q = None
        if req.pairs.truth is not None:
            ttm = req.total_true_matches
            if ttm is None:
                ttm = int(req.pairs.truth.sum())
            q = quality(req.pairs, labels, ttm)
        n_crowd = int(crowdsourced.sum())
        self.results[req.rid] = res = JoinSessionResult(
            rid=req.rid,
            labels=labels,
            crowdsourced=crowdsourced,
            n_rounds=len(lane.round_sizes),
            round_sizes=lane.round_sizes,
            n_hits=self.cost.n_hits(n_crowd),
            cost_cents=self.cost.cost_cents(n_crowd),
            quality=q,
            wall_seconds=time.perf_counter() - lane.t0,
            sim_minutes=(gateway.now_minutes if self.latency is not None
                         else None),
            fold_rounds=int(lane.state.rounds),
            n_conflicts=int(lane.state.conflicts[:lane.p].sum()),
            n_requeried=lane.n_requeried,
            n_spent_cents=gateway.spent_cents(req.rid),
            stopped_on_budget=lane.budget_stopped,
            n_cache_hits=lane.n_cache_hits,
            n_cluster_tasks=lane.n_cluster_tasks,
            n_cluster_pairs=gateway.cluster_pairs(req.rid),
            n_cluster_cents=lane.n_cluster_cents,
            admission_deferred=req.admission_deferred,
            envelope_clamped=req.envelope_clamped,
        )
        # cross-query deposit (DESIGN.md §14): the verdicts under the
        # fingerprints recorded at submit (UNKNOWN ones deposit nothing;
        # pairs appended after submit have none and are sliced off)
        fps = self._cache_fps.pop(req.rid, None)
        if fps is not None and self.cluster_cache is not None:
            verdicts = np.full(P, UNKNOWN, np.int32)
            verdicts[lane.perm] = lane.labels_host
            self.cluster_cache.deposit(fps[0], fps[1],
                                       verdicts[: len(fps[0])])
            if self.cache_path is not None:
                self.cluster_cache.save(self.cache_path)
        # the envelope's reservation turns into realized spend: the rest
        # returns to the pool
        if self.admission is not None and \
                self.admission.global_budget_cents is not None:
            self._envelope_reserved = max(
                0.0, self._envelope_reserved - (req.budget_cents or 0.0))
            self._envelope_spent += res.n_spent_cents
        self._streams.pop(req.rid, None)
        self._stream_interleave.pop(req.rid, None)

    def _retire_done(self, active: List[_Lane],
                     gateway: CrowdGateway) -> List[_Lane]:
        still: List[_Lane] = []
        for lane in active:
            # a lane with arrival epochs still queued is not finished, even
            # when every pair it has seen so far is labeled
            if lane.done and not self._pending_arrivals.get(lane.req.rid):
                self._finalize(lane, gateway)
            else:
                still.append(lane)
        return still

    # -- lane growth (DESIGN.md §11) -----------------------------------------
    def _ingest(self, lane: _Lane, new_pairs: PairSet) -> None:
        """Fold an arrival epoch into a live lane: order it, grow the state
        to the new capacity bucket (bucketing clamped so it never pushes the
        universe past the key range; ``session_grow`` raises if even the raw
        size does not fit, and widens the keys to int64 past 46340 objects),
        claim padded slots for the new pairs, and re-upload the priorities
        and priors.  Published bits, gateway tickets, spend and every
        labeled pair carry over: existing pair slots never move."""
        req = lane.req
        offset = lane.p
        perm_new = get_order(new_pairs, req.order)
        ordered_new = new_pairs.take(perm_new)
        req.pairs = req.pairs.concat(new_pairs)
        lane.perm = np.concatenate([lane.perm, offset + perm_new])
        lane.ordered = lane.ordered.concat(ordered_new)
        new_p = offset + len(new_pairs)
        p_cap = max(int(lane.state.u.shape[0]), next_pow2(new_p, 8))
        n_cap = lane.state.n_objects
        if lane.ordered.n_objects > n_cap:
            n_cap = next_pow2(lane.ordered.n_objects, 8)
            if not pair_keys_fit(n_cap):
                n_cap = lane.ordered.n_objects
        if (p_cap, n_cap) != lane.bucket:
            lane.state = session_grow(lane.state, p_cap, n_cap)
        new_u = np.zeros(p_cap, np.int32)
        new_v = np.zeros(p_cap, np.int32)
        mask = np.zeros(p_cap, bool)
        new_u[offset:new_p] = ordered_new.u
        new_v[offset:new_p] = ordered_new.v
        mask[offset:new_p] = True
        lane.state = session_append_pairs(lane.state, new_u, new_v, mask)
        if req.order in ("expected", "adaptive"):
            # selection keys on a pair's rank in the whole accumulated
            # candidate set, not its arrival position: this is what makes
            # the up-front schedule reproduce the batch run's frontier
            # (padded slots rank after every real pair)
            lik = lane.ordered.likelihood
            rank = np.empty(new_p, np.float32)
            rank[np.argsort(-lik, kind="stable")] = np.arange(
                new_p, dtype=np.float32)
            prio = np.concatenate(
                [rank, np.arange(new_p, p_cap, dtype=np.float32)])
            lane.state = dataclasses.replace(
                lane.state, priority=torch.from_numpy(prio).to(self.device))
        prior_host = np.zeros(p_cap, np.float32)
        prior_host[:new_p] = lane.ordered.likelihood
        lane.prior_host = prior_host
        if lane.prior_dev is not None:
            lane.prior_dev = torch.from_numpy(prior_host).to(self.device)
        lane.labels_host = np.concatenate(
            [lane.labels_host, np.full(len(new_pairs), UNKNOWN, np.int32)])
        lane.crowdsourced = np.concatenate(
            [lane.crowdsourced, np.zeros(len(new_pairs), bool)])
        inflight = np.zeros(p_cap, bool)
        inflight[:len(lane.inflight_host)] = lane.inflight_host
        lane.inflight_host = inflight
        lane.p = new_p
        lane.answers_host = req.crowd.precomputed_answers(lane.ordered)

    def _ingest_pending(self, lane: _Lane) -> bool:
        """Consume the lane's queued arrival epochs: all of them under the
        up-front schedule, one a call for an interleaved stream.  Ends with
        a deduce sweep, so arrivals the evidence already pins down never
        wedge a round with an empty frontier (a budget-stopped lane still
        ingests; the graph resolves its arrivals as it did the rest)."""
        pending = self._pending_arrivals.get(lane.req.rid)
        if not pending:
            return False
        n = 1 if self._stream_interleave.get(lane.req.rid) else len(pending)
        for _ in range(n):
            self._ingest(lane, pending.popleft())
        if not pending:
            del self._pending_arrivals[lane.req.rid]
        self._sweep_lane(lane)
        return True

    # -- per-round group caches ----------------------------------------------
    def _writeback(self, entry: Tuple[Tuple[_Lane, ...], SessionState]
                   ) -> None:
        """Materialize a cached group's stacked state back into its lanes."""
        lanes, stacked = entry
        for b, lane in enumerate(lanes):
            lane.state = index_state(stacked, b)

    def _flush_stacks(self) -> None:
        """Write every cached group stack back into its lanes and drop the
        caches: lane states must be authoritative before a fused wave
        regroups them."""
        for entry in self._stacks.values():
            self._writeback(entry)
        self._stacks.clear()
        self._prior_stacks.clear()

    def _group_stack(self, key: Tuple[int, int],
                     lanes: List[_Lane]) -> SessionState:
        """The group's stacked state, reused while its membership holds
        (compared by identity: lanes hold arrays)."""
        entry = self._stacks.get(key)
        if entry is not None:
            if len(entry[0]) == len(lanes) and \
                    all(a is b for a, b in zip(entry[0], lanes)):
                return entry[1]
            self._writeback(entry)  # membership changed: sync old members
            del self._stacks[key]
        return stack_states([lane.state for lane in lanes])

    def _group_priors(self, key: Tuple[int, int],
                      lanes: List[_Lane]) -> torch.Tensor:
        """The group's stacked (B, P) machine priors, uploaded once per
        membership."""
        entry = self._prior_stacks.get(key)
        if entry is not None and len(entry[0]) == len(lanes) and \
                all(a is b for a, b in zip(entry[0], lanes)):
            return entry[1]
        priors = torch.from_numpy(
            np.stack([lane.prior_host for lane in lanes])).to(self.device)
        self._prior_stacks[key] = (tuple(lanes), priors)
        return priors

    # -- budgets and the slot allocator (DESIGN.md §10) ----------------------
    def _allocate(self, staged, gateway: CrowdGateway) -> List[_Lane]:
        """Decide which frontier pairs post this round.  With no budgeted
        lane and no ``slots_per_round`` cap the whole frontier posts.
        Otherwise every frontier pair is scored by its expected-deduction
        gain (one gains call a group; adaptive groups read ``-priority``
        back), each budgeted lane keeps the highest-gain questions its
        budget affords (a stable sort), and the slot cap keeps the
        highest-gain pairs across every lane, ranked on (-gain, stage,
        lane, pair).  Rewrites each stage's mask to the posted set; returns
        the lanes whose budget affords nothing more."""
        stops: List[_Lane] = []
        constrained = self.slots_per_round is not None or any(
            lane.budget_cents is not None
            for _, lanes, _, _ in staged for lane in lanes)
        if not constrained:
            return stops
        cands = []  # (-gain, stage index, lane index, pair index)
        for si, (key, lanes, stacked, frontier) in enumerate(staged):
            if not frontier.any():
                continue
            if all(lane.adaptive for lane in lanes):
                # the refresh wrote -gain into every pending pair's priority
                # and the frontier selects only pending pairs
                gains = -stacked.priority.cpu().numpy()
            else:
                gains = session_gains_batch(
                    stacked, self._group_priors(key, lanes)).cpu().numpy()
            for b, lane in enumerate(lanes):
                idx = np.nonzero(frontier[b])[0]
                if len(idx) == 0:
                    continue
                afford = lane.affordable(gateway)
                if afford == 0:
                    stops.append(lane)
                    continue
                if afford is not None and afford < len(idx):
                    idx = idx[np.argsort(-gains[b, idx],
                                         kind="stable")][:afford]
                cands.extend((-float(gains[b, i]), si, b, int(i))
                             for i in idx)
        cands.sort()
        if self.slots_per_round is not None:
            cands = cands[:self.slots_per_round]
        for stage in staged:
            stage[3] = np.zeros_like(stage[3])
        for _, si, b, i in cands:
            staged[si][3][b, i] = True
        return stops

    def _budget_stop(self, lane: _Lane) -> None:
        """Out of budget: pull every unlabeled, unpublished pair out of
        contention and let the graph label what it pins down
        (``session_trust_graph``); the rest finalize as non-matching."""
        st = lane.state
        lane.state = session_trust_graph(
            st, (st.labels == UNKNOWN) & ~st.published)
        lane.labels_host = lane.state.labels[:lane.p].cpu().numpy()
        lane.budget_stopped = True

    # -- cluster tasks (DESIGN.md §15) ---------------------------------------
    def _task_info(self, lane: _Lane,
                   gateway: CrowdGateway) -> Tuple[float, float]:
        """The information-per-cent rule's inputs: the expected accuracy of
        an agreed cluster verdict (the best-known worker's error under EM
        with history, else the crowd's base rate, to the power
        ``cluster_assignments``) and the expected correct labels a cent of
        a pair question (majority-vote accuracy over its assignments)."""
        crowd = lane.req.crowd
        k = getattr(crowd, "n_assignments", 1)
        pair_cents = max(lane.rate_cents * k, 1e-9)
        try:
            acc_pair = 1.0 - crowd.pair_error_rate()
        except AttributeError:
            acc_pair = 1.0
        wm = gateway.worker_model
        best = wm.best_workers(limit=1) if wm is not None else []
        if best:
            err_one = wm.error_rate(best[0])
        else:
            err_one = min(getattr(crowd, "error_rate", 0.0), 0.5)
        acc_task = 1.0 - err_one ** self.cluster_assignments
        return acc_task, acc_pair / pair_cents

    def _plan_tasks(self, lane: _Lane, idx: np.ndarray,
                    gateway: CrowdGateway):
        """Split a lane's allocated frontier into cluster tasks and leftover
        pair questions.  Around each frontier pair an object set grows
        greedily (up to ``cluster_size``) by the frontier pairs, then the
        pending pairs, an object adds (ties to the lower object id); every
        pending pair inside the set rides along.  A task posts iff its
        expected correct frontier labels a cent beat the pair rate (and a
        budgeted lane affords it).  Returns ``(clusters, pair_idx)``,
        clusters as ``(n_objects, covered indices)``."""
        idx = np.asarray(idx, int)
        if not self.cluster_tasks or len(idx) == 0:
            return [], idx
        p = lane.p
        pending = lane.labels_host == UNKNOWN
        pending &= ~lane.inflight_host[:p]
        u = np.asarray(lane.ordered.u)
        v = np.asarray(lane.ordered.v)
        acc_one, pair_info = self._task_info(lane, gateway)
        is_frontier = np.zeros(p, bool)
        is_frontier[idx] = True
        nbr: Dict[int, List[int]] = {}
        for j in np.nonzero(pending)[0]:
            nbr.setdefault(int(u[j]), []).append(int(j))
            nbr.setdefault(int(v[j]), []).append(int(j))
        taken = np.zeros(p, bool)
        budget = lane.budget_cents
        spent = gateway.spent_cents(lane.req.rid) if budget is not None \
            else 0.0
        planned = 0.0
        clusters: List[Tuple[int, np.ndarray]] = []
        pair_idx: List[int] = []
        for j in (int(i) for i in idx):
            if taken[j]:
                continue  # harvested by an earlier cluster this round
            objs = {int(u[j]), int(v[j])}
            while len(objs) < self.cluster_size:
                # gain = (frontier pairs, pending pairs) object o would add
                gain: Dict[int, List[int]] = {}
                for o in objs:
                    for q in nbr.get(o, ()):
                        if taken[q]:
                            continue
                        other = int(v[q]) if int(u[q]) == o else int(u[q])
                        if other not in objs:
                            g = gain.setdefault(other, [0, 0])
                            g[0] += int(is_frontier[q])
                            g[1] += 1
                if not gain:
                    break
                best = max(gain.items(),
                           key=lambda kv: (kv[1][0], kv[1][1], -kv[0]))
                if best[1][0] == 0 and len(objs) >= 3:
                    break  # no scheduled question left to batch
                objs.add(best[0])
            cov = sorted({q for o in objs for q in nbr.get(o, ())
                          if not taken[q]
                          and int(u[q]) in objs and int(v[q]) in objs})
            fcov = int(sum(is_frontier[q] for q in cov))
            cents = (self.cost.cluster_task_cents(len(objs), lane.rate_cents)
                     * self.cluster_assignments)
            ok = (acc_one * fcov / max(cents, 1e-9) >= pair_info
                  and (budget is None
                       or spent + planned + cents <= budget + 1e-9))
            if ok:
                cov = np.asarray(cov, int)
                taken[cov] = True
                planned += cents
                clusters.append((len(objs), cov))
            else:
                pair_idx.append(j)
        return clusters, np.asarray(pair_idx, int)

    # -- per-round engine ----------------------------------------------------
    def _post_lane(self, lane: _Lane, clusters, pair_idx: np.ndarray,
                   gateway: CrowdGateway) -> int:
        """Post one lane's planned round: every cluster task at its §15
        price, then the leftover pair questions in index order.  Marks the
        pairs crowdsourced and in flight.  Returns the pairs posted."""
        total = 0
        for n_objects, cov in clusters:
            lane.crowdsourced[cov] = True
            lane.inflight_host[cov] = True
            cents = (self.cost.cluster_task_cents(n_objects, lane.rate_cents)
                     * self.cluster_assignments)
            gateway.post_cluster(
                lane.req.rid, lane.ordered, cov, lane.req.crowd,
                cents=cents, n_assignments=self.cluster_assignments,
                pair_cents_per_assignment=lane.rate_cents)
            lane.n_cluster_tasks += 1
            lane.n_cluster_cents += cents
            total += len(cov)
        if len(pair_idx):
            lane.crowdsourced[pair_idx] = True
            lane.inflight_host[pair_idx] = True
            gateway.post(lane.req.rid, lane.ordered, pair_idx,
                         lane.req.crowd, cents_per_assignment=lane.rate_cents)
            total += len(pair_idx)
        return total

    def _step(self, active: List[_Lane], gateway: CrowdGateway) -> bool:
        """One round over the occupied lanes: a batched priority refresh for
        groups with adaptive lanes, the batched frontier over bucket-grouped
        stacked states, the budget and slot allocation, cluster planning,
        one gateway post per lane, a full drain (the round barrier), and one
        screened fold a group.  Under ``conflict_policy="requery"`` the
        round drains and folds until every rejected answer is resolved:
        re-answered, or exhausted and trusted to the graph.  Returns True
        iff any lane made progress (crowdsourced, deduced or stopped on
        budget)."""
        requery = self.conflict_policy == "requery"
        groups: Dict[Tuple[int, int], List[_Lane]] = {}
        for lane in active:
            groups.setdefault(lane.bucket, []).append(lane)
        staged = []
        for key, lanes in groups.items():
            stacked = self._group_stack(key, lanes)
            if any(lane.adaptive for lane in lanes):
                stacked = session_refresh_priorities_batch(
                    stacked, self._group_priors(key, lanes),
                    [lane.adaptive for lane in lanes])
            frontier = session_frontier_batch(stacked).cpu().numpy()
            staged.append([key, lanes, stacked, frontier])
        budget_stops = self._allocate(staged, gateway)
        # cluster planning widens the posted mask with the harvested pairs,
        # so the publish below holds deduction off every pair answered next
        plans: Dict[Tuple[int, int], Tuple[list, np.ndarray]] = {}
        for si, (_, lanes, _, posted) in enumerate(staged):
            for b, lane in enumerate(lanes):
                idx = np.nonzero(posted[b])[0]
                if len(idx) == 0:
                    continue
                clusters, pair_idx = self._plan_tasks(lane, idx, gateway)
                plans[si, b] = (clusters, pair_idx)
                for _, cov in clusters:
                    posted[b, cov] = True
        if requery:
            # published bits hold deduction off contested pairs, so a
            # rejected answer can wait for its escalation
            for stage in staged:
                if stage[3].any():
                    stage[2] = session_mark_published_batch(stage[2],
                                                            stage[3])
        # post every lane, then drain: the barrier spans lanes, and ballots
        # are drawn in this order
        for si, (_, lanes, _, _) in enumerate(staged):
            for b, lane in enumerate(lanes):
                plan = plans.get((si, b))
                if plan is None:
                    continue
                n = self._post_lane(lane, plan[0], plan[1], gateway)
                if n:
                    lane.round_sizes.append(n)
        pending = True
        while pending:
            pending = False
            answers: Dict[int, List] = {}
            for ans in gateway.drain():
                answers.setdefault(ans.rid, []).append(ans)
            for stage in staged:
                _, lanes, stacked, posted = stage
                updates = np.full(posted.shape, UNKNOWN, np.int32)
                landed = False
                for b, lane in enumerate(lanes):
                    for ans in answers.get(lane.req.rid, ()):
                        updates[b, ans.index] = ans.label
                        lane.inflight_host[ans.index] = False
                        landed = True
                if not landed:
                    continue
                stacked, cmask = session_fold_answers_batch(
                    stacked, updates, keep_conflicts_published=requery)
                if requery:
                    cmask = cmask.cpu().numpy()
                    exhausted_mask = np.zeros(cmask.shape, bool)
                    for b, lane in enumerate(lanes):
                        cidx = np.nonzero(cmask[b, :lane.p])[0]
                        if len(cidx) == 0:
                            continue
                        ticket, exhausted = gateway.requery(
                            lane.req.rid, lane.ordered, cidx, lane.req.crowd,
                            cents_per_assignment=lane.rate_cents,
                            budget_cents=lane.budget_cents)
                        lane.n_requeried += len(ticket.indices)
                        if ticket.indices:
                            lane.inflight_host[list(ticket.indices)] = True
                            pending = True
                        exhausted_mask[b, exhausted] = True
                    if exhausted_mask.any():
                        # the escalation is exhausted: the graph outvotes
                        # the crowd (un-publish and deduce)
                        stacked = session_trust_graph_batch(stacked,
                                                            exhausted_mask)
                stage[2] = stacked
        progress = False
        stop_set = {id(lane) for lane in budget_stops}
        for key, lanes, stacked, _ in staged:
            self._stacks[key] = (tuple(lanes), stacked)
            labels = stacked.labels.cpu().numpy()
            for b, lane in enumerate(lanes):
                new = labels[b, :lane.p]
                progress |= bool((new != lane.labels_host).any())
                lane.labels_host = new
                if id(lane) in stop_set and (new == UNKNOWN).any():
                    # out of budget with pairs still open: trust the graph
                    # for the rest (DESIGN.md §10) and finalize
                    lane.state = index_state(stacked, b)
                    self._budget_stop(lane)
                    progress = True
                elif lane.done:  # leaving the group: materialize its state
                    lane.state = index_state(stacked, b)
        return progress

    # -- on-device round engine ----------------------------------------------
    def _fused_eligible(self, lane: _Lane) -> bool:
        """True when the lane's next crowd wave can run on the device: fused
        rounds are on, cluster tasks are off (a task's harvest depends on
        live host-side coverage), the transport is immediate (a latency
        model makes answer arrival part of the semantics), no budget or
        slot cap re-decides each round on the host, the crowd's answers are
        order-independent, no §9 screen has fired on the lane, and no
        arrival epoch is queued for it (it would grow the state mid-wave)."""
        return (self.fused_rounds
                and not self.cluster_tasks
                and self.latency is None
                and self.slots_per_round is None
                and lane.budget_cents is None
                and not lane.budget_stopped
                and lane.fused_ok
                and lane.answers_host is not None
                and not self._pending_arrivals.get(lane.req.rid))

    def _drive_fused(self, active: List[_Lane],
                     gateway: CrowdGateway) -> bool:
        """Advance every active lane a whole crowd wave: grow the lanes to
        one shared capacity bucket, stack them, and call the round engine
        (k rounds per call) until no lane is mid-stream.  The wave's gateway
        traffic is replayed after each call: answers are order-independent,
        so posting the crowdsourced pairs late gives the ledger the
        per-round path would.  A lane whose §9 screen fires exits pre-fold
        with ``fused_ok`` cleared, nothing posted for that round, and
        replays it through :meth:`_step`.  Returns True iff any lane made
        progress."""
        self._flush_stacks()
        p_cap = max(int(lane.state.u.shape[0]) for lane in active)
        n_cap = max(lane.state.n_objects for lane in active)
        for lane in active:
            if (int(lane.state.u.shape[0]),
                    lane.state.n_objects) != (p_cap, n_cap):
                lane.state = session_grow(lane.state, p_cap, n_cap)
        B = len(active)
        stacked = stack_states([lane.state for lane in active])
        answers = np.full((B, p_cap), UNKNOWN, np.int32)
        priors = np.zeros((B, p_cap), np.float32)
        for b, lane in enumerate(active):
            answers[b, :lane.p] = lane.answers_host[:lane.p]
            priors[b, :len(lane.prior_host)] = lane.prior_host
        answers_dev = torch.from_numpy(answers).to(self.device)
        priors_dev = torch.from_numpy(priors).to(self.device)
        adaptive = torch.tensor([lane.adaptive for lane in active],
                                device=self.device)
        progress = False
        running = True
        while running:
            stacked, crowd_new, sizes, rdone, codes = \
                session_run_rounds_batch(stacked, answers_dev,
                                         self.FUSED_ROUNDS_PER_DISPATCH,
                                         prior=priors_dev, adaptive=adaptive)
            crowd_new, sizes, rdone, codes, labels = (
                x.cpu().numpy() for x in (crowd_new, sizes, rdone, codes,
                                          stacked.labels))
            running = False
            stuck: List[int] = []
            for b, lane in enumerate(active):
                lane.round_sizes.extend(int(s) for s in sizes[b, :rdone[b]])
                idx = np.nonzero(crowd_new[b, :lane.p])[0]
                if len(idx):
                    lane.crowdsourced[idx] = True
                    gateway.post(lane.req.rid, lane.ordered, idx,
                                 lane.req.crowd,
                                 cents_per_assignment=lane.rate_cents)
                    progress = True
                new = labels[b, :lane.p]
                progress |= bool((new != lane.labels_host).any())
                lane.labels_host = new
                if int(codes[b]) == ROUNDS_CONFLICT:
                    lane.fused_ok = False
                elif (new == UNKNOWN).any():
                    if int(codes[b]) == ROUNDS_EMPTY:
                        stuck.append(lane.req.rid)
                    else:  # ROUNDS_RUNNING: the wave continues
                        running = True
            gateway.drain()  # consume the replayed posts (immediate mode)
            if stuck:
                raise RuntimeError(
                    "join engine stuck: no frontier and nothing deducible "
                    f"for rids {stuck}")
        for b, lane in enumerate(active):
            lane.state = index_state(stacked, b)
        return progress

    # -- asynchronous ID/NF engine -------------------------------------------
    def _publish(self, lane: _Lane, gateway: CrowdGateway) -> int:
        """Select the lane's current frontier and post it (instant decision:
        in-flight pairs are assumed matching but never re-posted).  Adaptive
        lanes refresh priorities from the live posterior first; a budgeted
        lane posts only what its budget affords (highest gain first) and
        stops on budget when it affords nothing; cluster planning publishes
        its harvested pairs beside the frontier.  Returns the pairs
        posted."""
        if lane.budget_stopped:
            return 0
        if lane.adaptive:
            lane.state = session_refresh_priorities(lane.state,
                                                    lane.prior_dev)
        frontier = session_frontier(lane.state)
        idx = np.nonzero(frontier.cpu().numpy())[0]
        if len(idx) == 0:
            return 0
        afford = lane.affordable(gateway)
        if afford == 0:
            self._budget_stop(lane)
            return 0
        cut = afford is not None and afford < len(idx)
        if cut:
            if lane.adaptive:
                # the refresh above wrote -gain into every pending pair
                gains = -lane.state.priority.cpu().numpy()
            else:
                gains = session_gains(lane.state,
                                      lane.prior_dev).cpu().numpy()
            idx = idx[np.argsort(-gains[idx], kind="stable")][:afford]
        clusters, pair_idx = self._plan_tasks(lane, idx, gateway)
        if cut or clusters:
            # publish what posts: the budget's cut and the harvested pairs
            frontier = np.zeros(frontier.shape[0], bool)
            frontier[idx] = True
            for _, cov in clusters:
                frontier[cov] = True
        lane.state = session_mark_published(lane.state, frontier)
        n = self._post_lane(lane, clusters, pair_idx, gateway)
        lane.round_sizes.append(n)
        lane.in_flight += n
        return n

    def _sweep_lane(self, lane: _Lane) -> None:
        """Deduce everything the lane's evidence pins down (skipping pairs
        whose answers are still in flight) and refresh the host mirror."""
        lane.state = session_deduce(lane.state)
        lane.labels_host = lane.state.labels[:lane.p].cpu().numpy()

    def _handle_conflicts(self, lane: _Lane, cidx: np.ndarray,
                          gateway: CrowdGateway) -> None:
        """Requery escalation of rejected answers: re-post them (they stay
        published, so deduction holds off) and let the graph label the
        exhausted ones (DESIGN.md §9).  Under the drop policy the fold has
        already settled them: nothing to do."""
        if self.conflict_policy != "requery":
            return
        ticket, exhausted = gateway.requery(
            lane.req.rid, lane.ordered, cidx, lane.req.crowd,
            cents_per_assignment=lane.rate_cents,
            budget_cents=lane.budget_cents)
        lane.n_requeried += len(ticket.indices)
        lane.in_flight += len(ticket.indices)
        if ticket.indices:
            lane.inflight_host[list(ticket.indices)] = True
        if exhausted:
            mask = np.zeros(lane.state.u.shape[0], bool)
            mask[exhausted] = True
            lane.state = session_trust_graph(lane.state, mask)

    def _fold_event(self, lane: _Lane, got: List, gateway: CrowdGateway
                    ) -> None:
        """Fold one lane's answers of one platform event.  A returned match
        agrees with the optimistic assumption, so the selection can change
        only on a non-match, a rejected answer or a drained lane (§5.2):
        then fold + deduce + re-select at once; otherwise apply alone.
        Under the requery policy a rejected answer stays published and is
        escalated."""
        updates = np.full(lane.state.u.shape[0], UNKNOWN, np.int32)
        for ans in got:
            updates[ans.index] = ans.label
            lane.inflight_host[ans.index] = False
        lane.in_flight -= len(got)
        requery = self.conflict_policy == "requery"
        fold_now = any(ans.label != POS for ans in got) or lane.in_flight == 0
        if fold_now:
            lane.state, cmask = session_fold_answers(
                lane.state, updates, keep_conflicts_published=requery)
        else:
            lane.state, cmask = session_apply_answers(
                lane.state, updates, keep_conflicts_published=requery)
        # under the drop policy a fold has settled its rejected answers, so
        # the mask is read (a host sync) only where it still decides
        cidx = (np.nonzero(cmask[:lane.p].cpu().numpy())[0]
                if requery or not fold_now else ())
        if len(cidx):
            self._handle_conflicts(lane, cidx, gateway)
            if not fold_now:
                # a rejected answer is a non-match-grade event: the
                # optimistic assumption broke though every returned label
                # read match
                self._sweep_lane(lane)
                fold_now = True
        lane.labels_host = lane.state.labels[:lane.p].cpu().numpy()
        if fold_now and not lane.done:
            self._publish(lane, gateway)

    def _run_async(self) -> Dict[int, JoinSessionResult]:
        """Event-driven serving (§5.2 lifted into the service): lanes fold
        answers as the gateway delivers them; a non-matching answer or a
        drained lane triggers deduce + re-frontier + post immediately."""
        gateway, active = self._resume_run_state()
        while self.queue or active or gateway.in_flight:
            self._checkpoint_tick(active, gateway)
            refilled = False
            while self.queue and len(active) < self.lanes:
                active.append(self._open_lane(self.queue.popleft()))
                refilled = True
            for r in self.queue:  # still queued behind fully-occupied lanes
                r.admission_deferred = True
            if any(self._pending_arrivals.get(l.req.rid) for l in active):
                # arrivals are ingested before a fresh lane's first publish
                # (up-front streams) and once an event-loop pass for
                # interleaved streams; a lane that went idle waiting on its
                # next epoch publishes again at once
                for lane in active:
                    if self._ingest_pending(lane) and lane.in_flight == 0 \
                            and lane.round_sizes and not lane.done:
                        self._publish(lane, gateway)
            if refilled:
                # zero-pair sessions are born done: finalize without posting
                active = self._retire_done(active, gateway)
            if active and gateway.in_flight == 0 and \
                    all(self._fused_eligible(lane) and lane.in_flight == 0
                        for lane in active):
                # an immediate gateway with nothing in flight degenerates to
                # per-lane round barriers: the wave the fused engine runs.  A
                # conflicted lane drops back to the event loop below
                if self._drive_fused(active, gateway):
                    active = self._retire_done(active, gateway)
                    continue
            if refilled:
                for lane in active:
                    if lane.in_flight == 0 and not lane.round_sizes:
                        self._publish(lane, gateway)
            answers = gateway.poll()
            if not answers:
                if not active and not gateway.in_flight:
                    continue  # the queue may still refill
                # platform drained: sweep + republish every idle lane
                posted = 0
                for lane in list(active):
                    if lane.in_flight:
                        continue
                    self._sweep_lane(lane)
                    if not lane.done:
                        posted += self._publish(lane, gateway)
                active = self._retire_done(active, gateway)
                if not posted and not gateway.in_flight and active:
                    if any(self._pending_arrivals.get(l.req.rid)
                           for l in active):
                        continue  # queued arrival epochs ingest next pass
                    raise RuntimeError(
                        "join engine stuck: no frontier and nothing "
                        f"deducible for rids {[l.req.rid for l in active]}")
                continue
            by_rid: Dict[int, List] = {}
            for ans in answers:
                by_rid.setdefault(ans.rid, []).append(ans)
            lanes_by_rid = {lane.req.rid: lane for lane in active}
            for rid, got in by_rid.items():
                lane = lanes_by_rid.get(rid)
                if lane is not None:  # else finalized before its answer
                    self._fold_event(lane, got, gateway)
            active = self._retire_done(active, gateway)
        return dict(self.results)

    # -- durable serving state (DESIGN.md §16) -------------------------------
    def _resume_run_state(self) -> Tuple[CrowdGateway, List[_Lane]]:
        """A run's starting state: a fresh gateway and no lanes, or the
        lanes and gateway :meth:`restore` rebuilt (the run resumes mid-wave
        with its tickets in flight)."""
        if self._resume is not None:
            active, gateway = self._resume
            self._resume = None
            return gateway, list(active)
        return CrowdGateway(latency=self.latency, nf=self.nf,
                            aggregation=self.aggregation), []

    def _checkpoint_tick(self, active: List[_Lane],
                         gateway: CrowdGateway) -> None:
        """The checkpoint hook at the top of every run-loop pass: every
        ``checkpoint_every``-th pass commits one (the first always does)."""
        if self._ckpt is None:
            return
        tick = self._ckpt_tick
        self._ckpt_tick += 1
        if tick % self.checkpoint_every:
            return
        self._checkpoint_now(active, gateway)

    def _checkpoint_now(self, active: List[_Lane],
                        gateway: CrowdGateway) -> None:
        """Commit one checkpoint of the whole serving state through the
        atomic ``CheckpointManager`` path.  Group stacks are written back
        first so the lane states are authoritative (a pure writeback: the
        run's semantics do not move)."""
        from repro_torch.serve import recovery
        self._flush_stacks()
        tree, side = recovery.capture_service(self, active, gateway)
        self._ckpt.save(self._ckpt_step, tree, sidecar=side)
        self._ckpt_step += 1
        if self._crash_after_checkpoints is not None and \
                self._ckpt_step >= self._crash_after_checkpoints:
            raise ServiceKilled(
                f"injected crash after checkpoint {self._ckpt_step - 1} "
                f"(step dir committed under {self.checkpoint_dir})")

    @classmethod
    def restore(cls, checkpoint_dir: str, step: Optional[int] = None,
                cluster_cache=None,
                device: DeviceLike = None) -> "JoinService":
        """Rebuild a service from the latest (or given) checkpoint under
        ``checkpoint_dir``, on ``device`` (the card unless ``"cpu"`` is
        asked for; a checkpoint written on either restores on the other):
        configuration, queued and open requests, finished results, ledgers
        and the gateway's tickets come back, and :meth:`run` resumes
        mid-wave with labels identical to an uninterrupted run, billing no
        answered pair twice.  ``cluster_cache`` overrides the cache (by
        default the saved ``cache_path`` is reloaded);
        ``service.last_recovery`` reports what came back."""
        from repro_torch.serve import recovery
        return recovery.restore_service(cls, checkpoint_dir, step=step,
                                        cluster_cache=cluster_cache,
                                        device=device)

    # -- entry point ---------------------------------------------------------
    def run(self) -> Dict[int, JoinSessionResult]:
        """Drain the queue: lanes refill as sessions finish.  Under
        ``async_mode`` the event-driven discipline; otherwise whole crowd
        waves run fused while every active lane is eligible, or, when not
        or when a fused wave made no progress (every lane's screen fired),
        one exact per-round step.  Returns {rid: result} for everything
        served."""
        if self.async_mode:
            return self._run_async()
        gateway, active = self._resume_run_state()
        self._stacks.clear()
        self._prior_stacks.clear()
        while self.queue or active:
            self._checkpoint_tick(active, gateway)
            while self.queue and len(active) < self.lanes:
                active.append(self._open_lane(self.queue.popleft()))
            for r in self.queue:  # still queued behind fully-occupied lanes
                r.admission_deferred = True
            if any(self._pending_arrivals.get(l.req.rid) for l in active):
                # arrival epochs land before the round's frontier: lane
                # states must be authoritative (not cached in a group stack,
                # whose key is the bucket that growth changes) while they
                # grow
                self._flush_stacks()
                for lane in active:
                    self._ingest_pending(lane)
            # zero-pair (or fully seeded) sessions are born done
            active = self._retire_done(active, gateway)
            if not active:
                continue
            if all(lane.done for lane in active):
                # every open lane waits on a queued arrival epoch (an
                # interleaved stream): it ingests next iteration
                continue
            if all(self._fused_eligible(lane) for lane in active):
                if self._drive_fused(active, gateway):
                    active = self._retire_done(active, gateway)
                    continue
            if not self._step(active, gateway):
                raise RuntimeError(
                    "join engine stuck: no frontier and nothing deducible "
                    f"for rids {[lane.req.rid for lane in active]}")
            active = self._retire_done(active, gateway)
        self._stacks.clear()
        self._prior_stacks.clear()
        return dict(self.results)
