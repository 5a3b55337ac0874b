"""The paper's primary contribution on PyTorch: hybrid transitive-relations +
crowdsourcing labeling framework (ClusterGraph deduction, labeling orders,
parallel labeling, the asynchronous platform's simulators) — the exact
sequential oracle plus the round engine on the card.

The names are the JAX package's ``repro.core``, for what is ported; the
engine labelers are ``label_parallel_torch(_batch)`` where the reference
has ``label_parallel_jax(_batch)``.  Labels are the engine codes
``POS`` / ``NEG`` / ``UNKNOWN`` (the reference's paper strings ``MATCH`` /
``NON_MATCH`` have no counterpart here).
"""
from .cluster_graph import NEG, POS, UNKNOWN, ClusterGraph
from .crowd import (Ballot, ClusterTask, CostModel, Crowd, CrowdAnswer,
                    CrowdGateway, CrowdTicket, LatencyModel, NoisyCrowd,
                    PerfectCrowd, WorkerModel)
from .deduce import deduce_bruteforce
from .graph import (ROUNDS_CONFLICT, ROUNDS_DONE, ROUNDS_EMPTY,
                    ROUNDS_RUNNING, SessionState, boruvka_frontier,
                    boruvka_frontier_batch, connected_components,
                    connected_components_batch, deduce_batch,
                    deduce_sessions, label_parallel_torch,
                    label_parallel_torch_batch, make_session_state,
                    make_session_state_batch, neg_keys, next_pow2,
                    pack_sessions, pair_key_bits, pair_keys_fit,
                    session_append_pairs, session_append_pairs_batch,
                    session_apply_answers, session_apply_answers_batch,
                    session_deduce, session_deduce_batch,
                    session_fold_answers, session_fold_answers_batch,
                    session_from_labels, session_frontier,
                    session_frontier_batch, session_grow,
                    session_grow_batch, session_mark_published,
                    session_mark_published_batch,
                    session_run_rounds, session_run_rounds_batch,
                    session_seed_labels, session_seed_labels_batch,
                    session_trust_graph, session_trust_graph_batch)
from .join import JoinResult, crowdsourced_join
from .labeling import (LabelingResult, label_all_crowdsourced,
                       label_sequential, label_sequential_adaptive)
from .metrics import Quality, quality, transitively_consistent
from .ordering import (adaptive_gains_host, adaptive_order_host,
                       expected_rank, session_gains, session_gains_batch,
                       session_refresh_priorities,
                       session_refresh_priorities_batch)
from .pairs import PairSet
from .parallel import (StreamTrace, WallClock, deduction_sweep,
                       label_parallel, label_parallel_adaptive,
                       parallel_crowdsourced_pairs, simulate_stream,
                       simulate_wallclock_parallel_id,
                       simulate_wallclock_sequential)
from .sorting import (ORDERS, count_crowdsourced, expected_crowdsourced,
                      get_order, order_adaptive, order_expected,
                      order_optimal, order_random, order_worst,
                      validate_order)

__all__ = [
    "ClusterGraph", "PairSet",
    "Crowd", "PerfectCrowd", "NoisyCrowd", "CostModel", "LatencyModel",
    "Ballot", "WorkerModel", "ClusterTask",
    "deduce_bruteforce",
    "label_sequential", "label_all_crowdsourced", "label_parallel",
    "LabelingResult", "parallel_crowdsourced_pairs", "deduction_sweep",
    "simulate_stream", "simulate_wallclock_parallel_id",
    "simulate_wallclock_sequential", "StreamTrace", "WallClock",
    "order_expected", "order_optimal", "order_random", "order_worst",
    "order_adaptive", "get_order", "validate_order", "ORDERS",
    "count_crowdsourced", "expected_crowdsourced",
    "label_sequential_adaptive", "label_parallel_adaptive",
    "adaptive_gains_host", "adaptive_order_host", "expected_rank",
    "session_gains", "session_gains_batch", "session_refresh_priorities",
    "session_refresh_priorities_batch",
    "connected_components", "deduce_batch", "neg_keys", "boruvka_frontier",
    "label_parallel_torch", "UNKNOWN", "NEG", "POS",
    "connected_components_batch", "boruvka_frontier_batch", "deduce_sessions",
    "pack_sessions", "label_parallel_torch_batch",
    "SessionState", "make_session_state", "make_session_state_batch",
    "session_from_labels", "session_frontier", "session_frontier_batch",
    "session_apply_answers", "session_apply_answers_batch",
    "session_deduce", "session_deduce_batch",
    "session_fold_answers", "session_fold_answers_batch",
    "session_seed_labels", "session_seed_labels_batch",
    "session_mark_published", "session_mark_published_batch",
    "session_trust_graph", "session_trust_graph_batch",
    "session_run_rounds", "session_run_rounds_batch",
    "ROUNDS_RUNNING", "ROUNDS_DONE", "ROUNDS_EMPTY", "ROUNDS_CONFLICT",
    "session_grow", "session_grow_batch",
    "session_append_pairs", "session_append_pairs_batch",
    "pair_key_bits", "pair_keys_fit", "next_pow2",
    "CrowdGateway", "CrowdTicket", "CrowdAnswer",
    "crowdsourced_join", "JoinResult", "quality", "Quality",
    "transitively_consistent",
]
