"""Transitive-relations round engine on PyTorch — the port of
``repro/core/jax_graph.py`` (DESIGN.md §8, §13), limited to what the fused
serving path runs.

A join session's engine state is a :class:`SessionState` of tensors:
pair endpoints ``u``/``v`` in labeling order, ``labels``, in-flight
``published`` bits, the union-find forest ``roots`` over POS edges, the
sorted canonical neg-key index ``neg_keys``, the answer-fold counter
``rounds``, per-pair ``conflicts`` and the live ``priority``.  The engine
functions take a *stacked* state with an explicit leading lane dimension
``(B, ...)`` where the JAX package used ``vmap``, and loop on the host where
it used ``lax.while_loop``; a lane that has finished is held fixed exactly as
a vmapped ``while_loop`` holds it.

Pair keys are ``lo * n + hi`` in int32, padded with ``INT32_MAX`` — the
values the JAX reference stores under its default 32-bit configuration — so
every stored key matches the reference value for value.  The round engine's
union + conflict screen and its deduce sweep go through the ``union_deduce``
kernel wrapper on every device: the CUDA kernel for a CUDA state, its plain
PyTorch version for a CPU state.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.device import DeviceLike, pick_device
from repro_torch.kernels.union_deduce.ops import union_deduce

from .cluster_graph import NEG, POS, UNKNOWN

KEY_DTYPE = torch.int32
KEY_SENTINEL = 2 ** 31 - 1   # padding of the neg-key index, above any key

# exit codes reported by `session_run_rounds_batch`:
ROUNDS_RUNNING = 0   # rounds budget exhausted mid-stream — more remain
ROUNDS_DONE = 1      # no UNKNOWN labels left on entry to a round
ROUNDS_EMPTY = 2     # empty frontier with UNKNOWNs left
ROUNDS_CONFLICT = 3  # §9 screen fired — the state is pre-fold


# ---------------------------------------------------------------------------
# Canonical pair keys + representable-range guard
# ---------------------------------------------------------------------------
def next_pow2(n: int, floor: int = 1) -> int:
    """Next power of two >= max(n, floor) — the capacity bucket policy."""
    b = floor
    while b < n:
        b *= 2
    return b


def pair_key_bits() -> int:
    """Usable bits for canonical ``lo * n + hi`` keys: the port stores them
    in int32, as the reference does under its default configuration."""
    return 31


def pair_keys_fit(n_objects: int) -> bool:
    """True iff an ``n_objects`` universe's pair keys fit the key dtype."""
    return n_objects * n_objects < 2 ** pair_key_bits()


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` along the last axis, lane by lane."""
    return torch.gather(x, -1, idx.long())


def canonical_keys(roots_u: torch.Tensor, roots_v: torch.Tensor,
                   n_objects: int) -> torch.Tensor:
    """Canonical ``lo * n + hi`` cluster-pair keys, range-guarded."""
    if not pair_keys_fit(n_objects):
        raise ValueError(
            f"n_objects={n_objects} overflows {pair_key_bits() + 1}-bit pair "
            "keys")
    lo = torch.minimum(roots_u, roots_v).to(KEY_DTYPE)
    hi = torch.maximum(roots_u, roots_v).to(KEY_DTYPE)
    return lo * n_objects + hi


# ---------------------------------------------------------------------------
# Union-find over matching edges: hook-to-min + pointer jumping
# ---------------------------------------------------------------------------
def _union_impl(parent0: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor, n_objects: int) -> torch.Tensor:
    """Unite every ``mask`` edge into the compressed forest ``parent0``
    (``(..., n)``; ``u``/``v``/``mask`` are ``(..., P)``).  Returns the
    fully compressed forest: each object points at the least id of its
    component — a unique fixed point, so extra trips on a converged lane
    change nothing."""
    big = n_objects
    uu = torch.where(mask, u, 0)
    vv = torch.where(mask, v, 0)
    parent = parent0
    while True:
        ru = _take(parent, uu)
        rv = _take(parent, vv)
        hi = torch.where(mask, torch.maximum(ru, rv), big)
        tgt = torch.where(mask, torch.minimum(ru, rv), big)
        parent = parent.scatter_reduce(
            -1, hi.clamp(max=n_objects - 1).long(),
            torch.where(hi < big, tgt, big), "amin", include_self=True)
        parent = torch.minimum(parent, parent0)
        parent = _take(parent, parent)
        parent = _take(parent, parent)
        if not bool((_take(parent, uu) != _take(parent, vv)).any()):
            break
    while True:
        nxt = _take(parent, parent)
        if torch.equal(nxt, parent):
            return parent
        parent = nxt


# ---------------------------------------------------------------------------
# Sorted negative-key index
# ---------------------------------------------------------------------------
def _in_sorted(sorted_keys: torch.Tensor, queries: torch.Tensor
               ) -> torch.Tensor:
    idx = torch.searchsorted(sorted_keys, queries)
    idx = idx.clamp(max=sorted_keys.shape[-1] - 1)
    return _take(sorted_keys, idx) == queries


def _decompose_keys(keys: torch.Tensor, n_objects: int):
    """Split canonical keys back into endpoint ids.  Returns
    ``(lo, hi, is_pad)``; pad slots decompose to ``(0, 0)``."""
    is_pad = keys == KEY_SENTINEL
    lo = torch.where(is_pad, 0, torch.div(keys, n_objects,
                                          rounding_mode="floor"))
    hi = torch.where(is_pad, 0, torch.remainder(keys, n_objects))
    return (lo.clamp(0, n_objects - 1).to(torch.int32),
            hi.clamp(0, n_objects - 1).to(torch.int32), is_pad)


def _rekey_impl(sorted_keys: torch.Tensor, roots: torch.Tensor,
                n_objects: int) -> torch.Tensor:
    """Re-canonicalize a sorted neg-key index under a new forest: decompose,
    remap both endpoints, re-sort.  Under the forest the keys were built for
    this is the identity, so the reference's cond-gated re-key and this
    unconditional one store the same values."""
    lo, hi, is_pad = _decompose_keys(sorted_keys, n_objects)
    new = canonical_keys(_take(roots, lo), _take(roots, hi), n_objects)
    new = torch.where(is_pad, KEY_SENTINEL, new)
    return torch.sort(new, dim=-1).values


def _merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """First P slots of the sorted union of two sorted ``(..., P)`` key
    arrays (each pair contributes at most one real key, so they hold every
    real key) — the same multiset the reference's searchsorted merge
    builds."""
    P = a.shape[-1]
    return torch.sort(torch.cat([a, b], dim=-1), dim=-1).values[..., :P]


def _deduce_lookup_impl(roots, sorted_neg, qu, qv, n_objects: int
                        ) -> torch.Tensor:
    """Algorithm 1 batched: POS / NEG / UNKNOWN per query pair."""
    ru, rv = _take(roots, qu), _take(roots, qv)
    same = ru == rv
    neg = _in_sorted(sorted_neg, canonical_keys(ru, rv, n_objects)) & ~same
    return torch.where(same, POS, torch.where(neg, NEG, UNKNOWN)).to(
        torch.int32)


# ---------------------------------------------------------------------------
# SessionState
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SessionState:
    """One join session's engine state (or ``B`` of them stacked along a
    leading lane axis).  ``roots`` are the canonical (least-id) components
    of the POS-labeled edges and ``neg_keys`` the sorted multiset of
    canonical root-pair keys of the NEG-labeled edges under them, padded
    with ``KEY_SENTINEL``.  Padded pair slots hold the inert pre-labeled POS
    self-loop (0, 0); padded objects are singletons."""

    u: torch.Tensor          # (P,) int32 pair endpoints, labeling order
    v: torch.Tensor          # (P,) int32
    labels: torch.Tensor     # (P,) int32 {UNKNOWN, NEG, POS}
    published: torch.Tensor  # (P,) bool — in-flight pairs
    roots: torch.Tensor      # (n_objects,) int32 forest over POS edges
    neg_keys: torch.Tensor   # (P,) int32 sorted canonical NEG keys
    rounds: torch.Tensor     # () int32 answer-fold counter
    conflicts: torch.Tensor  # (P,) int32 rejected answers per pair
    priority: torch.Tensor   # (P,) f32 live labeling priority
    n_objects: int

    TENSOR_FIELDS = ("u", "v", "labels", "published", "roots", "neg_keys",
                     "rounds", "conflicts", "priority")

    def replace(self, **fields) -> "SessionState":
        return dataclasses.replace(self, **fields)


def make_session_state(u, v, n_objects: int, pair_capacity: int = 0,
                       object_capacity: int = 0,
                       device: DeviceLike = None) -> SessionState:
    """Fresh (all-UNKNOWN) session state, padded to the given capacities."""
    dev = pick_device(device)
    u = np.asarray(u, np.int32)
    v = np.asarray(v, np.int32)
    P = len(u)
    p_cap = max(pair_capacity, P)
    n_cap = max(object_capacity, int(n_objects))
    U = np.zeros(p_cap, np.int32)
    V = np.zeros(p_cap, np.int32)
    U[:P] = u
    V[:P] = v
    labels = np.full(p_cap, POS, np.int32)
    labels[:P] = UNKNOWN
    return SessionState(
        u=torch.from_numpy(U).to(dev),
        v=torch.from_numpy(V).to(dev),
        labels=torch.from_numpy(labels).to(dev),
        published=torch.zeros(p_cap, dtype=torch.bool, device=dev),
        roots=torch.arange(n_cap, dtype=torch.int32, device=dev),
        neg_keys=torch.full((p_cap,), KEY_SENTINEL, dtype=KEY_DTYPE,
                            device=dev),
        rounds=torch.zeros((), dtype=torch.int32, device=dev),
        conflicts=torch.zeros(p_cap, dtype=torch.int32, device=dev),
        priority=torch.arange(p_cap, dtype=torch.float32, device=dev),
        n_objects=n_cap,
    )


def session_grow(state: SessionState, pair_capacity: int,
                 object_capacity: int) -> SessionState:
    """Extend one lane's state to larger pair/object capacities.  Every live
    field keeps its prefix; new pair slots are the inert POS self-loop, new
    objects are singletons, and the neg-key index is re-encoded under the
    larger universe (a strictly monotone map, so it stays sorted)."""
    P_old = state.u.shape[-1]
    n_old = state.n_objects
    if pair_capacity < P_old or object_capacity < n_old:
        raise ValueError(
            f"session_grow cannot shrink capacities ({P_old}, {n_old}) -> "
            f"({pair_capacity}, {object_capacity})")
    if not pair_keys_fit(object_capacity):
        raise ValueError(
            f"growing to n_objects={object_capacity} overflows "
            f"{pair_key_bits() + 1}-bit pair keys")
    dev = state.u.device
    pad_p = pair_capacity - P_old
    lo, hi, is_pad = _decompose_keys(state.neg_keys, n_old)
    rekeyed = torch.where(is_pad, KEY_SENTINEL,
                          canonical_keys(lo, hi, object_capacity))

    def pad(x, value, dtype):
        return torch.cat([x, torch.full((pad_p,), value, dtype=dtype,
                                        device=dev)])

    return SessionState(
        u=pad(state.u, 0, torch.int32),
        v=pad(state.v, 0, torch.int32),
        labels=pad(state.labels, POS, torch.int32),
        published=pad(state.published, False, torch.bool),
        roots=torch.cat([state.roots, torch.arange(
            n_old, object_capacity, dtype=torch.int32, device=dev)]),
        neg_keys=pad(rekeyed, KEY_SENTINEL, KEY_DTYPE),
        rounds=state.rounds,
        conflicts=pad(state.conflicts, 0, torch.int32),
        priority=torch.cat([state.priority, torch.arange(
            P_old, pair_capacity, dtype=torch.float32, device=dev)]),
        n_objects=object_capacity,
    )


def stack_states(states: List[SessionState]) -> SessionState:
    """Stack same-capacity lane states along a new leading lane axis."""
    return SessionState(
        **{f: torch.stack([getattr(s, f) for s in states])
           for f in SessionState.TENSOR_FIELDS},
        n_objects=states[0].n_objects)


def index_state(stacked: SessionState, b: int) -> SessionState:
    """Lane ``b`` of a stacked state."""
    return SessionState(
        **{f: getattr(stacked, f)[b] for f in SessionState.TENSOR_FIELDS},
        n_objects=stacked.n_objects)


def _select_state(pred: torch.Tensor, a: SessionState, b: SessionState
                  ) -> SessionState:
    """Per-lane ``where(pred, a, b)`` over every field; ``pred`` is (B,)."""
    def sel(x, y):
        return torch.where(pred.view(-1, *([1] * (x.dim() - 1))), x, y)
    return SessionState(
        **{f: sel(getattr(a, f), getattr(b, f))
           for f in SessionState.TENSOR_FIELDS},
        n_objects=a.n_objects)


# ---------------------------------------------------------------------------
# State transformations (stacked lanes)
# ---------------------------------------------------------------------------
def _apply_fast(state: SessionState, updates, new, pos_new, neg_new, roots):
    """The conflict-free fold: every answer accepted, fully parallel.
    ``roots`` is the already-computed union over every incoming POS edge."""
    n = state.n_objects
    labels = torch.where(new, updates, state.labels)
    negk = _rekey_impl(state.neg_keys, roots, n)
    fresh = torch.where(
        neg_new, canonical_keys(_take(roots, state.u), _take(roots, state.v),
                                n), KEY_SENTINEL)
    negk = _merge_sorted(negk, torch.sort(fresh, dim=-1).values)
    return labels, roots, negk, torch.zeros_like(new)


def _finish_apply(state: SessionState, labels, roots, negk, cmask, new
                  ) -> SessionState:
    """Bookkeeping tail of a counted answer fold: answered pairs leave
    flight, the round counter advances on any new label, and rejected
    answers count in ``conflicts``."""
    return state.replace(
        labels=labels, published=state.published & ~new, roots=roots,
        neg_keys=negk, rounds=state.rounds + new.any(-1).to(torch.int32),
        conflicts=state.conflicts + cmask.to(torch.int32))


def _deduce_from_impl(state: SessionState, ded: torch.Tensor
                      ) -> SessionState:
    """Fold a per-pair deduction sweep ``ded`` into the state: in-flight
    pairs are skipped, and each deduced NEG merges its (duplicate) key into
    the index, as a from-scratch rebuild would hold it."""
    n = state.n_objects
    new = (ded != UNKNOWN) & (state.labels == UNKNOWN) & ~state.published
    neg_new = new & (ded == NEG)
    fresh = torch.where(
        neg_new, canonical_keys(_take(state.roots, state.u),
                                _take(state.roots, state.v), n), KEY_SENTINEL)
    negk = _merge_sorted(state.neg_keys, torch.sort(fresh, dim=-1).values)
    return state.replace(labels=torch.where(new, ded, state.labels),
                         neg_keys=negk)


def _screen_fused(state: SessionState, updates: torch.Tensor):
    """The §9 conflict screen through the union_deduce kernel: the
    optimistic union of every incoming POS edge, the old-key self-key scan,
    and the self-key check of the incoming NEG answers."""
    new = (updates != UNKNOWN) & (state.labels == UNKNOWN)
    pos_new = new & (updates == POS)
    neg_new = new & (updates == NEG)
    roots_opt, _, old_conflict = union_deduce(
        state.roots, state.u, state.v, pos_new, state.neg_keys,
        state.n_objects)
    fresh_self = neg_new & (_take(roots_opt, state.u)
                            == _take(roots_opt, state.v))
    return new, pos_new, neg_new, roots_opt, old_conflict | fresh_self.any(-1)


def _deduce_fused(state: SessionState) -> SessionState:
    """One deduction sweep through the union_deduce kernel: with no edge to
    unite, its union is a no-op on the compressed forest and its re-key the
    identity, leaving the plain deduce lookup."""
    _, ded, _ = union_deduce(
        state.roots, state.u, state.v, torch.zeros_like(state.published),
        state.neg_keys, state.n_objects)
    return _deduce_from_impl(state, ded)


def _frontier_impl(state: SessionState) -> torch.Tensor:
    """Priority-Borůvka frontier over the live forest (parallel Algorithm 3),
    ``(B, P)`` bool.  Published pairs the graph does not contradict are
    hooked in as assumed-matching; each Borůvka round every cluster's
    minimum-priority candidate edge wins, and winners are united before the
    next round.  Ranks come from a stable argsort of the f32 priorities, so
    ties break by pair index."""
    u, v, n = state.u, state.v, state.n_objects
    B, P = u.shape
    dev = u.device
    order = torch.argsort(state.priority, dim=-1, stable=True)
    prio = torch.empty((B, P), dtype=torch.int32, device=dev).scatter_(
        -1, order, torch.arange(P, dtype=torch.int32, device=dev).expand(B, P))
    unknown = state.labels == UNKNOWN
    ded_now = _deduce_lookup_impl(state.roots, state.neg_keys, u, v, n)
    pub = state.published & unknown & (ded_now != NEG)
    roots = _union_impl(state.roots, u, v, pub, n)
    negk = _rekey_impl(state.neg_keys, roots, n)
    frontier = torch.zeros((B, P), dtype=torch.bool, device=dev)
    undecided = unknown & ~state.published
    inf = torch.full((B, n), P, dtype=torch.int32, device=dev)
    # a lane whose round made no progress is done; further rounds change
    # nothing for it (same roots, same candidates), as in the vmapped loop
    while True:
        ru, rv = _take(roots, u), _take(roots, v)
        neg_hit = _in_sorted(negk, canonical_keys(ru, rv, n))
        cand = undecided & (ru != rv) & ~neg_hit
        undecided = undecided & cand
        p = torch.where(cand, prio, P)
        best = inf.scatter_reduce(-1, ru.long(), p, "amin") \
            .scatter_reduce(-1, rv.long(), p, "amin")
        win = cand & ((_take(best, ru) == prio) | (_take(best, rv) == prio))
        if not bool(win.any()):
            return frontier
        frontier = frontier | win
        undecided = undecided & ~win
        roots = _union_impl(roots, u, v, win, n)
        negk = _rekey_impl(negk, roots, n)


def session_run_rounds_batch(state: SessionState, answers, max_rounds: int,
                             prior=None, adaptive=None, rounds_allowed=None):
    """Advance B stacked sessions up to ``max_rounds`` labeling rounds each:
    refresh -> frontier -> screened fold -> deduce, with the crowd's
    order-independent ``answers`` (B, P) folded one frontier slice per
    round.  A lane stops on completion (``ROUNDS_DONE``), an empty frontier
    (``ROUNDS_EMPTY``), a §9 screen (``ROUNDS_CONFLICT``, state left
    pre-fold) or its ``rounds_allowed``; stopped lanes are held fixed while
    the others run on.  The input state is not modified.

    Returns ``(state, crowdsourced (B, P), round_sizes (B, max_rounds),
    rounds_done (B,), code (B,))``."""
    from .ordering import _refresh_masked_impl

    B, P = state.u.shape
    dev = state.u.device
    answers = torch.as_tensor(answers, dtype=torch.int32, device=dev)
    prior = (torch.zeros((B, P), dtype=torch.float32, device=dev)
             if prior is None else
             torch.as_tensor(prior, dtype=torch.float32, device=dev))
    adaptive = (torch.zeros(B, dtype=torch.bool, device=dev)
                if adaptive is None else
                torch.as_tensor(adaptive, dtype=torch.bool, device=dev))
    ra = (torch.full((B,), max_rounds, dtype=torch.int32, device=dev)
          if rounds_allowed is None else
          torch.as_tensor(rounds_allowed, dtype=torch.int32, device=dev))
    ra = ra.clamp(max=max_rounds)
    crowd = torch.zeros((B, P), dtype=torch.bool, device=dev)
    sizes = torch.zeros((B, max_rounds), dtype=torch.int32, device=dev)
    r = torch.zeros(B, dtype=torch.int32, device=dev)
    code = torch.full((B,), ROUNDS_RUNNING, dtype=torch.int32, device=dev)
    while True:
        act = (code == ROUNDS_RUNNING) & (r < ra)
        if not bool(act.any()):
            return state, crowd, sizes, r, code
        done0 = ~(state.labels == UNKNOWN).any(-1)
        st = _refresh_masked_impl(state, prior, adaptive)
        frontier = _frontier_impl(st)
        updates = torch.where(frontier, answers, UNKNOWN).to(torch.int32)
        new, pos_new, neg_new, roots_opt, has_conflict = _screen_fused(
            st, updates)
        labels, roots, negk, cmask = _apply_fast(st, updates, new, pos_new,
                                                 neg_new, roots_opt)
        folded = _deduce_fused(
            _finish_apply(st, labels, roots, negk, cmask, new))
        empty = ~frontier.any(-1)
        conflict = has_conflict & ~done0
        advanced = ~done0 & ~conflict & ~empty & act
        nxt = _select_state(done0, state, _select_state(conflict, st, folded))
        state = _select_state(act, nxt, state)
        crowd = torch.where(advanced[:, None], crowd | frontier, crowd)
        cnt = frontier.sum(-1, dtype=torch.int32)
        slot = r.clamp(max=max_rounds - 1).long()[:, None]
        sizes = torch.where(advanced[:, None],
                            sizes.scatter(1, slot, cnt[:, None]), sizes)
        step_code = torch.where(
            done0, ROUNDS_DONE, torch.where(
                conflict, ROUNDS_CONFLICT, torch.where(
                    empty, ROUNDS_EMPTY, ROUNDS_RUNNING))).to(torch.int32)
        code = torch.where(act, step_code, code)
        r = r + advanced.to(torch.int32)
