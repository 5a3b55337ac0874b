"""Adaptive labeling order (DESIGN.md §10): posterior-refreshed priorities
— ``repro/core/ordering.py``'s device path (gains and refresh, unbatched
and stacked) and its host mirror over a :class:`ClusterGraph`
(:func:`adaptive_gains_host`, the ranking the host adaptive labelers
share).

Per pending pair with machine prior ``p`` the gain is
``p / (1 + NEG_DAMP * (du + dv))``, ``du``/``dv`` being the distinct
negative degrees of the pair's two clusters.  The arithmetic is pure f32
mul/add/div, so it matches the reference bit for bit, and
``priority = -gain`` on pending pairs (the frontier selects the minimum).
"""
from __future__ import annotations

import numpy as np
import torch

from .cluster_graph import UNKNOWN, ClusterGraph
from .graph import (SessionState, _decompose_keys, _take, index_state,
                    stack_states)

# Damping per unit of negative degree; a power of two keeps 1 + NEG_DAMP * k
# exact in f32.
NEG_DAMP = 0.25
# Priors are clipped away from {0, 1} so every pending pair keeps a rank.
PRIOR_FLOOR = 1e-4


def _neg_degree_impl(state: SessionState) -> torch.Tensor:
    """Distinct negative degree per root, f32 ``(B, n)``: the index is
    sorted, so duplicate keys (deduced NEGs) are adjacent and count once."""
    keys = state.neg_keys
    lo, hi, is_pad = _decompose_keys(keys, state.n_objects)
    first = torch.ones_like(is_pad)
    first[..., 1:] = keys[..., 1:] != keys[..., :-1]
    w = torch.where(is_pad | ~first, 0.0, 1.0).to(torch.float32)
    deg = torch.zeros(keys.shape[:-1] + (state.n_objects,),
                      dtype=torch.float32, device=keys.device)
    return deg.scatter_add(-1, lo.long(), w).scatter_add(-1, hi.long(), w)


def _gains_impl(state: SessionState, prior: torch.Tensor) -> torch.Tensor:
    """Posterior match probability per pair, f32 (callers mask)."""
    negdeg = _neg_degree_impl(state)
    ru, rv = _take(state.roots, state.u), _take(state.roots, state.v)
    p = torch.clamp(prior.to(torch.float32), PRIOR_FLOOR, 1.0 - PRIOR_FLOOR)
    damp = 1.0 + NEG_DAMP * (_take(negdeg, ru) + _take(negdeg, rv))
    return p / damp


def _refresh_impl(state: SessionState, prior: torch.Tensor) -> SessionState:
    """Pending pairs (UNKNOWN, not in flight) get ``-gain``; published and
    labeled pairs keep their priority, out of the frontier's reach either
    way."""
    pending = (state.labels == UNKNOWN) & ~state.published
    return state.replace(priority=torch.where(
        pending, -_gains_impl(state, prior), state.priority))


def _refresh_masked_impl(state: SessionState, prior: torch.Tensor,
                         enable: torch.Tensor) -> SessionState:
    """:func:`_refresh_impl` on the lanes where the (B,) ``enable`` mask
    holds; lanes serving a static order keep their priorities."""
    refreshed = _refresh_impl(state, prior)
    return state.replace(priority=torch.where(
        enable[:, None], refreshed.priority, state.priority))


def session_gains(state: SessionState, prior) -> torch.Tensor:
    """(P,) f32 expected-deduction gains of one session."""
    return session_gains_batch(stack_states([state]),
                               torch.as_tensor(prior)[None])[0]


def session_gains_batch(state: SessionState, prior) -> torch.Tensor:
    """(B, P) f32 gains of stacked sessions."""
    return _gains_impl(state, torch.as_tensor(prior, dtype=torch.float32,
                                              device=state.u.device))


def session_refresh_priorities(state: SessionState, prior) -> SessionState:
    """Refresh one session's pending-pair priorities from the live
    posterior (DESIGN.md §10)."""
    return index_state(_refresh_impl(
        stack_states([state]), torch.as_tensor(
            prior, dtype=torch.float32, device=state.u.device)[None]), 0)


def session_refresh_priorities_batch(state: SessionState, prior,
                                     enable) -> SessionState:
    """Refresh stacked sessions; ``enable`` (B,) bool marks the lanes whose
    order is adaptive."""
    dev = state.u.device
    return _refresh_masked_impl(
        state, torch.as_tensor(prior, dtype=torch.float32, device=dev),
        torch.as_tensor(enable, dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------
# Host mirror (ClusterGraph): the same scores from the pointer-chasing graph
# ---------------------------------------------------------------------------
def adaptive_gains_host(graph: ClusterGraph, u: np.ndarray, v: np.ndarray,
                        likelihood: np.ndarray) -> np.ndarray:
    """Expected-deduction gains from a live :class:`ClusterGraph` — the host
    mirror of :func:`session_gains`, op for op in f32 so rankings agree with
    the engine's bit for bit.  O(n + P) a call: roots materialize once, the
    per-pair math is vectorized."""
    n = len(graph.parent)
    roots_all = np.fromiter((graph.find(i) for i in range(n)), np.int64, n)
    negdeg = np.zeros(n, np.float32)
    for r, enemies in graph.neg.items():
        negdeg[r] = len(enemies)  # keys are live roots (maintained on union)
    ru = roots_all[np.asarray(u, np.int64)]
    rv = roots_all[np.asarray(v, np.int64)]
    p = np.clip(np.asarray(likelihood, np.float32),
                np.float32(PRIOR_FLOOR), np.float32(1.0 - PRIOR_FLOOR))
    damp = np.float32(1.0) + np.float32(NEG_DAMP) * (negdeg[ru] + negdeg[rv])
    return p / damp


def expected_rank(likelihood: np.ndarray) -> np.ndarray:
    """Each pair's position in the static expected (likelihood-descending)
    order — the adaptive ranking's tie-break, mirroring the engine's stable
    rank tie-break over pairs stored in expected order."""
    n = len(likelihood)
    rank = np.empty(n, np.int64)
    rank[np.argsort(-np.asarray(likelihood), kind="stable")] = np.arange(n)
    return rank


def adaptive_order_host(gains: np.ndarray, erank: np.ndarray,
                        idx: np.ndarray) -> np.ndarray:
    """Order the pair indices ``idx`` by descending live gain, ties broken
    by the static expected rank — the one ranking both host adaptive
    labelers share."""
    return idx[np.lexsort((erank[idx], -gains[idx]))]
