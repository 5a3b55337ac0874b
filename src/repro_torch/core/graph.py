"""Transitive-relations round engine on PyTorch — the port of
``repro/core/jax_graph.py`` (DESIGN.md §8, §9, §13) that the serving paths
run: the fused round engine (``session_run_rounds(_batch)``) and the
per-round transformations (frontier, the conflict-screened answer fold with
its exact sequential replay, deduce, seed, mark-published, trust-graph),
each unbatched and stacked.

A join session's engine state is a :class:`SessionState` of tensors:
pair endpoints ``u``/``v`` in labeling order, ``labels``, in-flight
``published`` bits, the union-find forest ``roots`` over POS edges, the
sorted canonical neg-key index ``neg_keys``, the answer-fold counter
``rounds``, per-pair ``conflicts`` and the live ``priority``.  The engine
functions take a *stacked* state with an explicit leading lane dimension
``(B, ...)`` where the JAX package used ``vmap``, and loop on the host where
it used ``lax.while_loop``; a lane that has finished is held fixed exactly as
a vmapped ``while_loop`` holds it.

Pair keys are ``lo * n + hi``, padded with the key dtype's max — the values
the JAX reference stores under ``jax_enable_x64``, its production
configuration, so every stored key matches the reference value for value.
They are int32 while ``n * n < 2**31`` for the state's object capacity n
(where the reference's default 32-bit configuration stores the same values)
and int64 from there on (:func:`key_dtype`); a state's key dtype is its
``neg_keys``' own.  The round engine's
union + conflict screen and its deduce sweep go through the ``union_deduce``
kernel wrapper on every device: the CUDA kernel for a CUDA state, its plain
PyTorch version for a CPU state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Set

import numpy as np
import torch

from repro_torch.device import DeviceLike, pick_device
from repro_torch.kernels.union_deduce.ops import union_deduce

from .cluster_graph import NEG, POS, UNKNOWN


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
    """Usable bits for canonical ``lo * n + hi`` keys: 63, as the reference
    has under ``jax_enable_x64`` (keys widen to int64 past 46340 objects)."""
    return 63


def pair_keys_fit(n_objects: int) -> bool:
    """True iff an ``n_objects`` universe's pair keys are representable."""
    return n_objects * n_objects < 2 ** pair_key_bits()


def key_dtype(n_objects: int) -> torch.dtype:
    """The neg-key dtype of an ``n_objects`` universe: int32 while every key
    ``lo * n + hi`` and the sentinel above them fit it, else int64."""
    return torch.int32 if n_objects * n_objects < 2 ** 31 else torch.int64


def key_sentinel(dtype: torch.dtype) -> int:
    """Padding of a neg-key index: the key dtype's max, above any key."""
    return torch.iinfo(dtype).max


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` along the last axis, lane by lane."""
    return torch.gather(x, -1, idx.long())


def canonical_keys(roots_u: torch.Tensor, roots_v: torch.Tensor,
                   n_objects: int, dtype: torch.dtype = None) -> torch.Tensor:
    """Canonical ``lo * n + hi`` cluster-pair keys in ``dtype`` (default:
    :func:`key_dtype` of ``n_objects``), range-guarded."""
    if not pair_keys_fit(n_objects):
        raise ValueError(
            f"n_objects={n_objects} overflows {pair_key_bits() + 1}-bit pair "
            "keys")
    dtype = key_dtype(n_objects) if dtype is None else dtype
    if dtype == torch.int32 and key_dtype(n_objects) != torch.int32:
        raise ValueError(f"n_objects={n_objects} overflows int32 pair keys")
    lo = torch.minimum(roots_u, roots_v).to(dtype)
    hi = torch.maximum(roots_u, roots_v).to(dtype)
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
    is_pad = keys == key_sentinel(keys.dtype)
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
    kdt = sorted_keys.dtype
    new = canonical_keys(_take(roots, lo), _take(roots, hi), n_objects, kdt)
    new = torch.where(is_pad, key_sentinel(kdt), new)
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
    neg = _in_sorted(sorted_neg, canonical_keys(ru, rv, n_objects,
                                                sorted_neg.dtype)) & ~same
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
    with their dtype's :func:`key_sentinel`.  Padded pair slots hold the
    inert pre-labeled POS self-loop (0, 0); padded objects are
    singletons."""

    u: torch.Tensor          # (P,) int32 pair endpoints, labeling order
    v: torch.Tensor          # (P,) int32
    labels: torch.Tensor     # (P,) int32 {UNKNOWN, NEG, POS}
    published: torch.Tensor  # (P,) bool — in-flight pairs
    roots: torch.Tensor      # (n_objects,) int32 forest over POS edges
    neg_keys: torch.Tensor   # (P,) int32 / int64 sorted canonical NEG keys
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
        neg_keys=torch.full((p_cap,), key_sentinel(key_dtype(n_cap)),
                            dtype=key_dtype(n_cap), device=dev),
        rounds=torch.zeros((), dtype=torch.int32, device=dev),
        conflicts=torch.zeros(p_cap, dtype=torch.int32, device=dev),
        priority=torch.arange(p_cap, dtype=torch.float32, device=dev),
        n_objects=n_cap,
    )


def session_grow(state: SessionState, pair_capacity: int,
                 object_capacity: int) -> SessionState:
    """Extend a state with any leading lane axes to larger pair/object
    capacities (DESIGN.md §11).  Every live field keeps its prefix, so
    existing pair slots (labels, published bits, conflicts, priorities,
    in-flight positions) are untouched and gateway tickets into the old
    layout stay valid; new pair slots are the inert POS self-loop, new
    objects are singletons, and the neg-key index is re-encoded under the
    larger universe (a strictly monotone map, so it stays sorted), widened
    to int64 when the larger universe's keys need it, its sentinel the wider
    dtype's max.  A fresh state grown this way equals ``make_session_state``
    built at the larger capacities."""
    if pair_capacity < state.u.shape[-1]:
        raise ValueError(
            f"session_grow cannot shrink pair capacity "
            f"{state.u.shape[-1]} -> {pair_capacity}")
    if object_capacity < state.n_objects:
        raise ValueError(
            f"session_grow cannot shrink object capacity "
            f"{state.n_objects} -> {object_capacity}")
    if not pair_keys_fit(object_capacity):
        raise ValueError(
            f"growing to n_objects={object_capacity} overflows "
            f"{pair_key_bits() + 1}-bit pair keys")
    P_old = state.u.shape[-1]
    n_old = state.n_objects
    lead = tuple(state.u.shape[:-1])
    dev = state.u.device
    pad_p = pair_capacity - P_old
    lo, hi, is_pad = _decompose_keys(state.neg_keys, n_old)
    kdt = torch.promote_types(state.neg_keys.dtype,
                              key_dtype(object_capacity))
    rekeyed = torch.where(is_pad, key_sentinel(kdt),
                          canonical_keys(lo, hi, object_capacity, kdt))

    def pad(x, value, dtype):
        return torch.cat([x, torch.full(lead + (pad_p,), value, dtype=dtype,
                                        device=dev)], dim=-1)

    def tail(start, stop, dtype):
        return torch.arange(start, stop, dtype=dtype,
                            device=dev).expand(lead + (stop - start,))

    return SessionState(
        u=pad(state.u, 0, torch.int32),
        v=pad(state.v, 0, torch.int32),
        labels=pad(state.labels, POS, torch.int32),
        published=pad(state.published, False, torch.bool),
        roots=torch.cat([state.roots, tail(n_old, object_capacity,
                                           torch.int32)], dim=-1),
        neg_keys=pad(rekeyed, key_sentinel(kdt), kdt),
        rounds=state.rounds,
        conflicts=pad(state.conflicts, 0, torch.int32),
        priority=torch.cat([state.priority, tail(P_old, pair_capacity,
                                                 torch.float32)], dim=-1),
        n_objects=object_capacity,
    )


# The stacked ``(B, P)`` / ``(B, n)`` form pads the same last axis.
session_grow_batch = session_grow


def _append_pairs_impl(state: SessionState, new_u: torch.Tensor,
                       new_v: torch.Tensor, mask: torch.Tensor
                       ) -> SessionState:
    """Claim padded pair slots for newly arrived candidate pairs: ``mask``
    marks the slots to fill with ``new_u``/``new_v``.  Arrivals enter
    UNKNOWN and unpublished; no union has happened and no neg key exists for
    them, so roots and the sorted neg-key index carry over bit for bit, as
    ``make_session_state`` on the concatenated pairs would build them (the
    appended slots keep their positional priority)."""
    return dataclasses.replace(
        state,
        u=torch.where(mask, new_u, state.u),
        v=torch.where(mask, new_v, state.v),
        labels=torch.where(mask, UNKNOWN, state.labels),
    )


def session_append_pairs(state: SessionState, new_u, new_v, mask
                         ) -> SessionState:
    """Fold newly arrived pairs into padded slots.  The mask must claim only
    padded slots (past the live pair count, which the serving layer
    tracks); claimed slots become UNKNOWN candidates that the next frontier
    or deduce sweep treats like any other pending pair."""
    dev = state.u.device
    return _append_pairs_impl(
        state, torch.as_tensor(new_u, dtype=torch.int32, device=dev),
        torch.as_tensor(new_v, dtype=torch.int32, device=dev),
        torch.as_tensor(mask, dtype=torch.bool, device=dev))


def session_append_pairs_batch(state: SessionState, new_u, new_v, mask
                               ) -> SessionState:
    """(B, P) stacked :func:`session_append_pairs`."""
    return _append_pairs_impl(
        state, _stacked(new_u, torch.int32, state),
        _stacked(new_v, torch.int32, state),
        _stacked(mask, torch.bool, state))


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
    kdt = state.neg_keys.dtype
    negk = _rekey_impl(state.neg_keys, roots, n)
    fresh = torch.where(
        neg_new, canonical_keys(_take(roots, state.u), _take(roots, state.v),
                                n, kdt), key_sentinel(kdt))
    negk = _merge_sorted(negk, torch.sort(fresh, dim=-1).values)
    return labels, roots, negk, torch.zeros_like(new)


def _finish_apply(state: SessionState, labels, roots, negk, cmask, new,
                  count_round: bool, keep_conflicts_published: bool
                  ) -> SessionState:
    """Bookkeeping tail of every apply variant: answered pairs leave flight
    (rejected ones stay in flight only under ``keep_conflicts_published``,
    the requery policy), the round counter advances on any new label when
    ``count_round``, and rejected answers count in ``conflicts``."""
    answered = new & ~cmask if keep_conflicts_published else new
    rounds = state.rounds
    if count_round:
        rounds = rounds + new.any(-1).to(torch.int32)
    return state.replace(
        labels=labels, published=state.published & ~answered, roots=roots,
        neg_keys=negk, rounds=rounds,
        conflicts=state.conflicts + cmask.to(torch.int32))


def _deduce_from_impl(state: SessionState, ded: torch.Tensor
                      ) -> SessionState:
    """Fold a per-pair deduction sweep ``ded`` into the state: in-flight
    pairs are skipped, and each deduced NEG merges its (duplicate) key into
    the index, as a from-scratch rebuild would hold it."""
    n = state.n_objects
    new = (ded != UNKNOWN) & (state.labels == UNKNOWN) & ~state.published
    neg_new = new & (ded == NEG)
    kdt = state.neg_keys.dtype
    fresh = torch.where(
        neg_new, canonical_keys(_take(state.roots, state.u),
                                _take(state.roots, state.v), n, kdt),
        key_sentinel(kdt))
    negk = _merge_sorted(state.neg_keys, torch.sort(fresh, dim=-1).values)
    return state.replace(labels=torch.where(new, ded, state.labels),
                         neg_keys=negk)


def _screen_impl(state: SessionState, updates: torch.Tensor):
    """The §9 conflict screen through the union_deduce kernel: the
    optimistic union of every incoming POS edge, the old-key self-key scan,
    and the self-key check of the incoming NEG answers.  Any contradiction
    in the batch, against the state or inside the batch, leaves a self-key
    under that union, so a clean screen proves the batch conflict-free.
    Returns ``(new, pos_new, neg_new, roots_opt, has_conflict (B,))``."""
    new = (updates != UNKNOWN) & (state.labels == UNKNOWN)
    pos_new = new & (updates == POS)
    neg_new = new & (updates == NEG)
    roots_opt, _, old_conflict = union_deduce(
        state.roots, state.u, state.v, pos_new, state.neg_keys,
        state.n_objects)
    fresh_self = neg_new & (_take(roots_opt, state.u)
                            == _take(roots_opt, state.v))
    return new, pos_new, neg_new, roots_opt, old_conflict | fresh_self.any(-1)


def _deduce_impl(state: SessionState) -> SessionState:
    """One deduction sweep through the union_deduce kernel: with no edge to
    unite, its union is a no-op on the compressed forest and its re-key the
    identity, leaving the plain deduce lookup.  In-flight pairs are
    skipped."""
    _, ded, _ = union_deduce(
        state.roots, state.u, state.v, torch.zeros_like(state.published),
        state.neg_keys, state.n_objects)
    return _deduce_from_impl(state, ded)


def _sequential_conflicts(u, v, updates, new, roots, neg_keys,
                          n_objects: int) -> np.ndarray:
    """Which of one lane's answers ``ClusterGraph.add_label`` would reject,
    taken one at a time in pair-index order (numpy inputs of one lane; the
    forest ``roots`` compressed and ``neg_keys`` canonical under it).  A NEG
    answer is rejected inside one cluster, a POS answer between clusters
    with a neg edge; only accepted answers change the clusters.  Union-find
    over the state's roots, each cluster's set of neg-adjacent clusters
    built from the neg-key index the first time the cluster is touched and
    merged small into large on a union.  Returns the (P,) conflict mask."""
    keys = neg_keys[neg_keys != np.iinfo(neg_keys.dtype).max].astype(
        np.int64)
    ends = np.concatenate([keys // n_objects, keys % n_objects])
    others = np.concatenate([keys % n_objects, keys // n_objects])
    order = np.argsort(ends, kind="stable")
    ends, others = ends[order], others[order].tolist()
    link: Dict[int, int] = {}       # merged cluster -> the one it joined
    enemies: Dict[int, Set[int]] = {}

    def find(r: int) -> int:
        top = r
        while top in link:
            top = link[top]
        while r != top:
            link[r], r = top, link[r]
        return top

    def enemy_set(r: int) -> Set[int]:
        s = enemies.get(r)
        if s is None:
            a = int(np.searchsorted(ends, r, "left"))
            b = int(np.searchsorted(ends, r, "right"))
            s = enemies[r] = {find(x) for x in others[a:b]}
        return s

    u, v, updates, roots = u.tolist(), v.tolist(), updates.tolist(), \
        roots.tolist()
    cmask = np.zeros(len(u), bool)
    for i in np.flatnonzero(new).tolist():
        a, b = find(roots[u[i]]), find(roots[v[i]])
        if updates[i] == NEG:
            if a == b:
                cmask[i] = True
            else:
                enemy_set(a).add(b)
                enemy_set(b).add(a)
        elif a != b:
            ea, eb = enemy_set(a), enemy_set(b)
            if b in ea:
                cmask[i] = True
                continue
            if len(ea) < len(eb):
                a, b, ea, eb = b, a, eb, ea
            link[b] = a
            del enemies[b]
            for e in eb:
                se = enemy_set(e)
                se.discard(b)
                se.add(a)
            ea |= eb
    return cmask


def _apply_sequential(state: SessionState, updates: torch.Tensor,
                      new: torch.Tensor, lanes: np.ndarray):
    """Exact sequential replay of a conflicting fold (DESIGN.md §9) on the
    lanes where the host mask ``lanes`` (B,) holds: the reference's
    answer-at-a-time semantics in pair-index order, bit for bit.

    The design, the same code for a CPU and a CUDA state: whether an answer
    is accepted depends only on cluster membership and cluster-level neg
    adjacency, so a host pass over each replayed lane's new answers decides
    accept or reject (:func:`_sequential_conflicts`); then a vectorized
    tail on the state's device rebuilds what the serial replay would end
    with.  Its roots are the least-id components of the old forest plus the
    accepted POS edges (the union's unique fixed point, through the
    union_deduce kernel); its neg keys are the first P of the sorted
    canonical keys, under those roots, of the old keys and the accepted NEG
    pairs (each pair holds at most one key, so they are all there).  Lanes
    not replayed take every answer.  Returns ``(labels, roots, neg_keys,
    conflict_mask)``."""
    cmask = np.zeros(tuple(new.shape), bool)
    idx = np.flatnonzero(lanes)
    sel = torch.from_numpy(idx).to(new.device)
    host = [x.index_select(0, sel).cpu().numpy()
            for x in (state.u, state.v, updates, new, state.roots,
                      state.neg_keys)]
    for j, b in enumerate(idx.tolist()):
        cmask[b] = _sequential_conflicts(*(x[j] for x in host),
                                         state.n_objects)
    cmask = torch.from_numpy(cmask).to(new.device)
    acc = new & ~cmask
    acc_pos = acc & (updates == POS)
    roots, _, _ = union_deduce(state.roots, state.u, state.v, acc_pos,
                               state.neg_keys, state.n_objects)
    labels, roots, negk, _ = _apply_fast(state, updates, acc, acc_pos,
                                         acc & (updates == NEG), roots)
    return labels, roots, negk, cmask


def _apply_fast_flagged_impl(state: SessionState, updates: torch.Tensor,
                             count_round: bool,
                             keep_conflicts_published: bool):
    """Speculative conflict-free apply: always the parallel path, returning
    the per-lane screen flags beside ``(state, conflict_mask)``.  A lane
    whose flag fired must be folded exactly instead."""
    new, pos_new, neg_new, roots_opt, flags = _screen_impl(state, updates)
    labels, roots, negk, cmask = _apply_fast(state, updates, new, pos_new,
                                             neg_new, roots_opt)
    return _finish_apply(state, labels, roots, negk, cmask, new, count_round,
                         keep_conflicts_published), cmask, flags


def _apply_impl(state: SessionState, updates: torch.Tensor,
                count_round: bool, keep_conflicts_published: bool):
    """Fold new labels (``updates`` (B, P), UNKNOWN where nothing landed)
    into the state, screening conflicts.  The speculative parallel pass
    runs on every lane; one host sync reads its flags, and only the lanes
    whose screen fired are replayed exactly (:func:`_apply_sequential`) —
    lane by lane what the reference's per-session ``lax.cond`` gives.
    Returns ``(state, conflict_mask)``."""
    fast, cmask, flags = _apply_fast_flagged_impl(state, updates, count_round,
                                                  keep_conflicts_published)
    flags = flags.cpu().numpy()
    if not flags.any():
        return fast, cmask
    new = (updates != UNKNOWN) & (state.labels == UNKNOWN)
    labels, roots, negk, cmask = _apply_sequential(state, updates, new, flags)
    exact = _finish_apply(state, labels, roots, negk, cmask, new, count_round,
                          keep_conflicts_published)
    pick = torch.from_numpy(flags).to(cmask.device)
    return _select_state(pick, exact, fast), cmask


def _fold_impl(state: SessionState, updates: torch.Tensor,
               keep_conflicts_published: bool):
    """Apply (counted) + one deduce sweep: ``(state, conflict_mask)``."""
    state, cmask = _apply_impl(state, updates, True, keep_conflicts_published)
    return _deduce_impl(state), cmask


def _fold_fast_flagged_impl(state: SessionState, updates: torch.Tensor,
                            keep_conflicts_published: bool):
    """The speculative fold: ``(state, conflict_mask, flags)``."""
    state, cmask, flags = _apply_fast_flagged_impl(
        state, updates, True, keep_conflicts_published)
    return _deduce_impl(state), cmask, flags


def _seed_labels_impl(state: SessionState, seeds: torch.Tensor):
    """Warm-start fold of cached cluster verdicts (DESIGN.md §14): an answer
    fold that does not advance ``rounds``.  ``(state, conflict_mask)``."""
    state, cmask = _apply_impl(state, seeds, False, False)
    return _deduce_impl(state), cmask


def _seed_labels_fast_flagged_impl(state: SessionState, seeds: torch.Tensor):
    """The speculative seed fold: ``(state, conflict_mask, flags)``."""
    state, cmask, flags = _apply_fast_flagged_impl(state, seeds, False, False)
    return _deduce_impl(state), cmask, flags


def _trust_graph_impl(state: SessionState, mask: torch.Tensor
                      ) -> SessionState:
    """Un-publish ``mask`` and let deduction label those pairs from the
    graph (the requery ladder's end, DESIGN.md §9)."""
    return _deduce_impl(state.replace(published=state.published & ~mask))


def _mark_published_impl(state: SessionState, mask: torch.Tensor
                         ) -> SessionState:
    """Record pairs as posted to the crowd (in flight)."""
    return state.replace(published=state.published | mask)


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
        neg_hit = _in_sorted(negk, canonical_keys(ru, rv, n, negk.dtype))
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
        new, pos_new, neg_new, roots_opt, has_conflict = _screen_impl(
            st, updates)
        labels, roots, negk, cmask = _apply_fast(st, updates, new, pos_new,
                                                 neg_new, roots_opt)
        folded = _deduce_impl(_finish_apply(st, labels, roots, negk, cmask,
                                            new, True, False))
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


def session_run_rounds(state: SessionState, answers, max_rounds: int,
                       prior=None, adaptive: bool = False,
                       rounds_allowed=None):
    """One unbatched session through :func:`session_run_rounds_batch`.
    Returns ``(state, crowdsourced (P,), round_sizes (max_rounds,),
    rounds_done (), code ())``."""
    dev = state.u.device
    out = session_run_rounds_batch(
        stack_states([state]), _lane(answers, torch.int32, dev), max_rounds,
        prior=None if prior is None else _lane(prior, torch.float32, dev),
        adaptive=[bool(adaptive)],
        rounds_allowed=None if rounds_allowed is None
        else [int(rounds_allowed)])
    return (index_state(out[0], 0),) + tuple(x[0] for x in out[1:])


# ---------------------------------------------------------------------------
# Public per-round transformations.  Each comes unbatched (one session) and
# as ``*_batch`` over a stacked ``(B, ...)`` state; the unbatched form runs
# the stacked one on a lane axis of one.  None modifies its input state.
# ---------------------------------------------------------------------------
def _lane(x, dtype, dev) -> torch.Tensor:
    """A per-pair array as a lane axis of one on ``dev``."""
    return torch.as_tensor(x, dtype=dtype, device=dev)[None]


def _stacked(x, dtype, state: SessionState) -> torch.Tensor:
    """A stacked (B, P) array on the state's device."""
    return torch.as_tensor(x, dtype=dtype, device=state.u.device)


def session_frontier(state: SessionState) -> torch.Tensor:
    """(P,) bool mask of pairs to crowdsource now, from the live state."""
    return _frontier_impl(stack_states([state]))[0]


def session_frontier_batch(state: SessionState) -> torch.Tensor:
    """(B, P) stacked frontier masks."""
    return _frontier_impl(state)


def session_apply_answers(state: SessionState, updates,
                          keep_conflicts_published: bool = False):
    """Fold crowd answers (UNKNOWN = nothing landed) into the state, without
    the deduce sweep.  Returns ``(state, conflict_mask)``: rejected
    contradictory answers are flagged and counted in ``conflicts``."""
    st, cmask = _apply_impl(stack_states([state]),
                            _lane(updates, torch.int32, state.u.device),
                            True, keep_conflicts_published)
    return index_state(st, 0), cmask[0]


def session_apply_answers_batch(state: SessionState, updates,
                                keep_conflicts_published: bool = False):
    """Stacked :func:`session_apply_answers`: one speculative pass, the exact
    replay only on the lanes whose screen fired."""
    return _apply_impl(state, _stacked(updates, torch.int32, state), True,
                       keep_conflicts_published)


def session_deduce(state: SessionState) -> SessionState:
    """One deduction sweep; skips in-flight (published) pairs."""
    return index_state(_deduce_impl(stack_states([state])), 0)


def session_deduce_batch(state: SessionState) -> SessionState:
    """Stacked :func:`session_deduce`."""
    return _deduce_impl(state)


def session_fold_answers(state: SessionState, updates,
                         keep_conflicts_published: bool = False):
    """Apply + deduce: ``(state, conflict_mask)``."""
    st, cmask = _fold_impl(stack_states([state]),
                           _lane(updates, torch.int32, state.u.device),
                           keep_conflicts_published)
    return index_state(st, 0), cmask[0]


def session_fold_answers_batch(state: SessionState, updates,
                               keep_conflicts_published: bool = False):
    """Stacked :func:`session_fold_answers`: the conflict-free common case
    is one parallel pass and one host sync; the exact replay runs only on
    the lanes whose screen fired."""
    return _fold_impl(state, _stacked(updates, torch.int32, state),
                      keep_conflicts_published)


def session_seed_labels(state: SessionState, seeds):
    """Warm-start fold of cached verdicts (DESIGN.md §14): like
    :func:`session_fold_answers` but ``rounds`` does not advance.  Returns
    ``(state, conflict_mask)``; contradictory seeds are rejected."""
    st, cmask = _seed_labels_impl(stack_states([state]),
                                  _lane(seeds, torch.int32, state.u.device))
    return index_state(st, 0), cmask[0]


def session_seed_labels_batch(state: SessionState, seeds):
    """Stacked :func:`session_seed_labels`."""
    return _seed_labels_impl(state, _stacked(seeds, torch.int32, state))


def session_mark_published(state: SessionState, mask) -> SessionState:
    """Record pairs as posted to the crowd (in flight)."""
    return index_state(_mark_published_impl(
        stack_states([state]), _lane(mask, torch.bool, state.u.device)), 0)


def session_mark_published_batch(state: SessionState, mask) -> SessionState:
    """Stacked :func:`session_mark_published`."""
    return _mark_published_impl(state, _stacked(mask, torch.bool, state))


def session_trust_graph(state: SessionState, mask) -> SessionState:
    """Resolve requery-exhausted pairs: un-publish ``mask`` and deduce
    their labels from the graph."""
    return index_state(_trust_graph_impl(
        stack_states([state]), _lane(mask, torch.bool, state.u.device)), 0)


def session_trust_graph_batch(state: SessionState, mask) -> SessionState:
    """Stacked :func:`session_trust_graph`."""
    return _trust_graph_impl(state, _stacked(mask, torch.bool, state))


def make_session_state_batch(U, V, labels0, n_objects: int,
                             device: DeviceLike = None) -> SessionState:
    """Stacked fresh state over (B, P) packed sessions: the given labels,
    singleton forests, an empty neg-key index, positional priorities."""
    dev = pick_device(device)
    U, V, labels0 = (torch.as_tensor(np.asarray(x), dtype=torch.int32,
                                     device=dev) for x in (U, V, labels0))
    B, P = U.shape
    return SessionState(
        u=U, v=V, labels=labels0,
        published=torch.zeros((B, P), dtype=torch.bool, device=dev),
        roots=torch.arange(n_objects, dtype=torch.int32,
                           device=dev).repeat(B, 1),
        neg_keys=torch.full((B, P), key_sentinel(key_dtype(n_objects)),
                            dtype=key_dtype(n_objects), device=dev),
        rounds=torch.zeros(B, dtype=torch.int32, device=dev),
        conflicts=torch.zeros((B, P), dtype=torch.int32, device=dev),
        priority=torch.arange(P, dtype=torch.float32,
                              device=dev).repeat(B, 1),
        n_objects=int(n_objects))


def session_from_labels(u, v, labels, published, n_objects: int,
                        device: DeviceLike = None) -> SessionState:
    """Rebuild one session's state from plain label arrays: components of
    the POS edges from singletons, the sorted canonical keys of the NEG
    edges under them.  The from-scratch state the incremental one must
    equal."""
    dev = pick_device(device)
    u, v, labels = (_lane(x, torch.int32, dev) for x in (u, v, labels))
    return index_state(_state_from_labels_impl(
        u, v, labels, _lane(published, torch.bool, dev), n_objects), 0)


# ---------------------------------------------------------------------------
# From-scratch wrappers (``jax_graph.py``'s thin oracle-parity wrappers, with
# the reference's historical signatures).  Each takes array-likes, moves them
# to ``device`` (the card unless the caller asks for the CPU) and returns
# tensors there.
# ---------------------------------------------------------------------------
def _cc_impl(u: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
             n_objects: int) -> torch.Tensor:
    """Least-id components of the ``mask`` edges of stacked ``(B, P)``
    lanes, from singleton forests: the union half of the union_deduce kernel
    (every neg key a sentinel, so its screen and deduce are idle)."""
    B = u.shape[0]
    kdt = key_dtype(n_objects)
    roots, _, _ = union_deduce(
        torch.arange(n_objects, dtype=torch.int32,
                     device=u.device).repeat(B, 1), u, v, mask,
        torch.full_like(u, key_sentinel(kdt), dtype=kdt), n_objects)
    return roots


def _neg_keys_impl(roots: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   neg_mask: torch.Tensor, n_objects: int) -> torch.Tensor:
    """Sorted canonical root-pair keys of the ``neg_mask`` edges, the other
    slots the key dtype's sentinel."""
    keys = canonical_keys(_take(roots, u), _take(roots, v), n_objects)
    return torch.sort(torch.where(neg_mask, keys, key_sentinel(keys.dtype)),
                      dim=-1).values


def _state_from_labels_impl(u: torch.Tensor, v: torch.Tensor,
                            labels: torch.Tensor, published: torch.Tensor,
                            n_objects: int) -> SessionState:
    """Stacked from-scratch state over ``(B, P)`` label arrays (the
    reference's ``_state_from_labels_impl`` under ``vmap``): components from
    ``arange(n)`` and a full neg-key sort; zero rounds and conflicts,
    positional priorities."""
    B, P = u.shape
    dev = u.device
    roots = _cc_impl(u, v, labels == POS, n_objects)
    return SessionState(
        u=u, v=v, labels=labels, published=published, roots=roots,
        neg_keys=_neg_keys_impl(roots, u, v, labels == NEG, n_objects),
        rounds=torch.zeros(B, dtype=torch.int32, device=dev),
        conflicts=torch.zeros((B, P), dtype=torch.int32, device=dev),
        priority=torch.arange(P, dtype=torch.float32,
                              device=dev).repeat(B, 1),
        n_objects=int(n_objects))


def _on(dev: torch.device, *arrays_and_dtypes):
    """Each ``(array, dtype)`` as a tensor of that dtype on ``dev``."""
    return tuple(torch.as_tensor(x, dtype=dt, device=dev)
                 for x, dt in arrays_and_dtypes)


def connected_components(u, v, mask, n_objects: int,
                         device: DeviceLike = None) -> torch.Tensor:
    """Roots (least vertex id of each component) over the edges where
    ``mask`` holds: ``(n_objects,)`` int32."""
    u, v, mask = _on(pick_device(device), (u, torch.int32),
                     (v, torch.int32), (mask, torch.bool))
    return _cc_impl(u[None], v[None], mask[None], n_objects)[0]


def connected_components_batch(u, v, mask, n_objects: int,
                               device: DeviceLike = None) -> torch.Tensor:
    """(B, P) edge lists -> (B, n_objects) roots, one union_deduce launch
    for the B sessions."""
    u, v, mask = _on(pick_device(device), (u, torch.int32),
                     (v, torch.int32), (mask, torch.bool))
    return _cc_impl(u, v, mask, n_objects)


def neg_keys(roots, u, v, neg_mask, n_objects: int,
             device: DeviceLike = None) -> torch.Tensor:
    """Sorted canonical keys of cluster pairs joined by a labeled neg edge;
    the other slots are the key dtype's sentinel, at the end."""
    roots, u, v, neg_mask = _on(pick_device(device), (roots, torch.int32),
                                (u, torch.int32), (v, torch.int32),
                                (neg_mask, torch.bool))
    return _neg_keys_impl(roots, u, v, neg_mask, n_objects)


def deduce_batch(roots, sorted_neg, qu, qv, n_objects: int,
                 device: DeviceLike = None) -> torch.Tensor:
    """Algorithm 1 vectorized: POS / NEG / UNKNOWN per query pair, a lookup
    against the forest and the sorted neg-key index (int32 or int64, kept;
    any other integer dtype takes :func:`key_dtype`)."""
    dev = pick_device(device)
    sorted_neg = torch.as_tensor(sorted_neg, device=dev)
    if sorted_neg.dtype not in (torch.int32, torch.int64):
        sorted_neg = sorted_neg.to(key_dtype(n_objects))
    roots, qu, qv = _on(dev, (roots, torch.int32), (qu, torch.int32),
                        (qv, torch.int32))
    return _deduce_lookup_impl(roots, sorted_neg, qu, qv, n_objects)


def boruvka_frontier(u, v, labels, published, n_objects: int,
                     device: DeviceLike = None) -> torch.Tensor:
    """Bool mask of the pairs to crowdsource now, from scratch: the state
    rebuilt from the label arrays with positional priorities (pairs come in
    labeling order), then the state frontier."""
    u, v, labels, published = _on(
        pick_device(device), (u, torch.int32), (v, torch.int32),
        (labels, torch.int32), (published, torch.bool))
    return _frontier_impl(_state_from_labels_impl(
        u[None], v[None], labels[None], published[None], n_objects))[0]


def boruvka_frontier_batch(u, v, labels, published, n_objects: int,
                           device: DeviceLike = None) -> torch.Tensor:
    """(B, P) stacked sessions -> (B, P) bool frontier masks, from scratch;
    each lane's equals its unbatched :func:`boruvka_frontier`."""
    u, v, labels, published = _on(
        pick_device(device), (u, torch.int32), (v, torch.int32),
        (labels, torch.int32), (published, torch.bool))
    return _frontier_impl(_state_from_labels_impl(u, v, labels, published,
                                                  n_objects))


def deduce_sessions(u, v, labels, n_objects: int,
                    device: DeviceLike = None) -> torch.Tensor:
    """One deduction sweep over B stacked sessions, from scratch: every
    UNKNOWN pair whose label follows from the POS/NEG evidence is filled
    in.  Returns the updated (B, P) labels."""
    u, v, labels = _on(pick_device(device), (u, torch.int32),
                       (v, torch.int32), (labels, torch.int32))
    return _deduce_impl(_state_from_labels_impl(
        u, v, labels, torch.zeros_like(labels, dtype=torch.bool),
        n_objects)).labels


def pack_sessions(sessions, pair_capacity: int = 0, object_capacity: int = 0):
    """Pack ragged sessions ``[(u, v, n_objects), ...]`` into stacked numpy
    arrays.  Returns ``(U, V, labels0, valid, n_cap)``, the first four
    ``(B, P_cap)``; padded slots hold the inert pre-labeled POS self-loop
    (0, 0)."""
    B = len(sessions)
    p_cap = max(pair_capacity, max(len(u) for u, _, _ in sessions))
    U = np.zeros((B, p_cap), np.int32)
    V = np.zeros((B, p_cap), np.int32)
    labels0 = np.full((B, p_cap), POS, np.int32)
    valid = np.zeros((B, p_cap), bool)
    for b, (u, v, _) in enumerate(sessions):
        p = len(u)
        U[b, :p] = u
        V[b, :p] = v
        labels0[b, :p] = UNKNOWN
        valid[b, :p] = True
    n_cap = max(object_capacity, max(n for _, _, n in sessions))
    return U, V, labels0, valid, n_cap


# ---------------------------------------------------------------------------
# Whole labeling loops (host-driven, the engine's transforms inside)
# ---------------------------------------------------------------------------
def label_parallel_torch(u, v, n_objects: int, crowd_fn, prior=None,
                         device: DeviceLike = None):
    """The port of ``jax_graph.label_parallel_jax``: iterate frontier ->
    crowd -> fold (apply + deduce), with a from-scratch rebuild of the state
    from the labels every round.

    ``crowd_fn(idx_array) -> int32 array of {NEG, POS}`` labels the frontier
    (``idx`` ascending).  Answers contradicting the evidence are dropped at
    the conflict-aware fold (the pair takes its deduced label) and counted.
    With ``prior`` (the per-pair machine likelihoods) the order is adaptive
    (DESIGN.md §10): priorities are refreshed from the live posterior before
    every frontier.  The reference rebuilds the state a second time for the
    fold; from the same labels that rebuild is the frontier's, so the port
    folds into the one rebuild.  Returns ``(labels, crowdsourced_mask,
    per-round frontier sizes, n_conflicts)``, numpy and ints."""
    from .ordering import _refresh_impl

    dev = pick_device(device)
    P = len(u)
    uj, vj = (x[None] for x in _on(dev, (u, torch.int32), (v, torch.int32)))
    prior_j = None if prior is None else \
        _on(dev, (prior, torch.float32))[0][None]
    labels = torch.full((1, P), UNKNOWN, dtype=torch.int32, device=dev)
    published = torch.zeros((1, P), dtype=torch.bool, device=dev)
    crowdsourced = np.zeros(P, dtype=bool)
    rounds: List[int] = []
    n_conflicts = torch.zeros((), dtype=torch.int64, device=dev)
    labels_host = np.full(P, UNKNOWN, np.int32)
    while (labels_host == UNKNOWN).any():
        state = _state_from_labels_impl(uj, vj, labels, published,
                                        n_objects)
        ranked = state if prior_j is None else _refresh_impl(state, prior_j)
        idx = np.flatnonzero(_frontier_impl(ranked)[0].cpu().numpy())
        if len(idx) == 0:
            # everything left is deducible
            labels_host = _deduce_impl(state).labels.cpu().numpy()[0]
            assert not (labels_host == UNKNOWN).any(), "engine stuck"
            break
        rounds.append(len(idx))
        crowdsourced[idx] = True
        updates = np.full((1, P), UNKNOWN, np.int32)
        updates[0, idx] = np.asarray(crowd_fn(idx), np.int32)
        state, cmask = _fold_impl(state, _on(dev, (updates, torch.int32))[0],
                                  False)
        labels = state.labels
        n_conflicts += cmask.sum()
        labels_host = labels.cpu().numpy()[0]
    return labels_host, crowdsourced, rounds, int(n_conflicts)


def label_parallel_torch_batch(sessions, crowd_fn, pair_capacity: int = 0,
                               object_capacity: int = 0,
                               device: DeviceLike = None) -> list:
    """The port of ``jax_graph.label_parallel_jax_batch``: B independent
    sessions ``[(u, v, n_objects), ...]`` (pairs in labeling order) packed
    once into one stacked state, then every round one frontier and one
    fold (apply + deduce) over the persistent state.
    ``crowd_fn(b, idx_array) -> int32 array of {NEG, POS}`` labels session
    ``b``'s frontier.  Contradictory answers are dropped at the fold and
    counted.  Returns ``[(labels, crowdsourced_mask, round_sizes,
    n_conflicts), ...]`` a session, each equal to
    :func:`label_parallel_torch` on that session alone."""
    B = len(sessions)
    U, V, labels0, valid, n_cap = pack_sessions(
        sessions, pair_capacity, object_capacity)
    state = make_session_state_batch(U, V, labels0, n_cap, device)
    crowdsourced = np.zeros(labels0.shape, dtype=bool)
    rounds: List[List[int]] = [[] for _ in range(B)]
    labels_host = labels0.copy()
    while (labels_host == UNKNOWN).any():
        frontier = _frontier_impl(state).cpu().numpy()
        if not frontier.any():
            # everything left (in every session) is deducible
            labels_host = _deduce_impl(state).labels.cpu().numpy()
            assert not (labels_host == UNKNOWN).any(), "engine stuck"
            break
        updates = np.full(labels0.shape, UNKNOWN, np.int32)
        for b in range(B):
            idx = np.flatnonzero(frontier[b])
            if len(idx) == 0:
                continue
            rounds[b].append(len(idx))
            crowdsourced[b, idx] = True
            updates[b, idx] = crowd_fn(b, idx)
        state, _ = _fold_impl(state, _stacked(updates, torch.int32, state),
                              False)
        labels_host = state.labels.cpu().numpy()
    conflicts = state.conflicts.cpu().numpy()
    return [
        (labels_host[b, valid[b]], crowdsourced[b, valid[b]], rounds[b],
         int(conflicts[b, valid[b]].sum()))
        for b in range(B)
    ]
