"""Adaptive labeling order (DESIGN.md §10): posterior-refreshed priorities
— the device path of ``repro/core/ordering.py`` (gains and refresh,
unbatched and stacked).

Per pending pair with machine prior ``p`` the gain is
``p / (1 + NEG_DAMP * (du + dv))``, ``du``/``dv`` being the distinct
negative degrees of the pair's two clusters.  The arithmetic is pure f32
mul/add/div, so it matches the reference bit for bit, and
``priority = -gain`` on pending pairs (the frontier selects the minimum).
"""
from __future__ import annotations

import torch

from .cluster_graph import UNKNOWN
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
