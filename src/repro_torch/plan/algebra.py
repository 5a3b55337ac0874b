"""Logical relational algebra over crowdsourced entity joins (DESIGN.md §14;
the port of ``repro/plan/algebra.py``).

Collections carry embeddings (the machine phase scores them), plain
machine-readable attribute columns (filters evaluate host-side for free),
and optionally ground-truth entity ids for simulated crowds.  Plans are
immutable trees; the optimizer (``plan/optimizer.py``) rewrites them and the
executor (``plan/executor.py``) compiles them to ``JoinService``
submissions.

Columns are qualified ``"collection.attr"`` names, so predicates are
attributable to one collection — the property filter pushdown keys on.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch


def _host_f32(embeddings) -> np.ndarray:
    """Embeddings as a contiguous host f32 array (a tensor on any device
    is copied to the host first)."""
    if isinstance(embeddings, torch.Tensor):
        embeddings = embeddings.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(np.asarray(embeddings, np.float32))


def row_fingerprints(embeddings) -> List[str]:
    """Content fingerprint per row — the cross-query identity of an object
    (DESIGN.md §14).  Keyed on the row's f32 bytes, not its position, so a
    grown or re-ordered collection still hits the cache for the rows it
    shares with an earlier query; the same row gives the same digest in
    both packages."""
    emb = _host_f32(embeddings)
    return [hashlib.blake2b(emb[i].tobytes(), digest_size=16).hexdigest()
            for i in range(emb.shape[0])]


def collection_fingerprint(fps: List[str]) -> str:
    """Order-insensitive digest over the row fingerprints."""
    h = hashlib.blake2b(digest_size=16)
    for fp in sorted(fps):
        h.update(bytes.fromhex(fp))
    return h.hexdigest()


@dataclasses.dataclass
class Collection:
    """A named table: (N, D) embeddings + machine-readable attr columns,
    optionally ground-truth ``entities`` for simulated crowds."""

    name: str
    embeddings: np.ndarray
    attrs: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    entities: Optional[np.ndarray] = None

    def __post_init__(self):
        self.embeddings = _host_f32(self.embeddings)
        n = len(self.embeddings)
        self.attrs = {k: np.asarray(v) for k, v in self.attrs.items()}
        for k, v in self.attrs.items():
            if len(v) != n:
                raise ValueError(
                    f"attr {self.name}.{k} has {len(v)} values for "
                    f"{n} rows")
        if self.entities is not None:
            self.entities = np.asarray(self.entities)
            if len(self.entities) != n:
                raise ValueError(
                    f"entities of {self.name} has {len(self.entities)} "
                    f"values for {n} rows")
        self._fps: Optional[List[str]] = None

    def __len__(self) -> int:
        return len(self.embeddings)

    def fingerprints(self) -> List[str]:
        if self._fps is None:
            self._fps = row_fingerprints(self.embeddings)
        return self._fps

    def fingerprint(self) -> str:
        return collection_fingerprint(self.fingerprints())

    def columns(self) -> FrozenSet[str]:
        return frozenset(f"{self.name}.{k}" for k in self.attrs)

    def column(self, qualified: str) -> np.ndarray:
        coll, attr = qualified.split(".", 1)
        if coll != self.name or attr not in self.attrs:
            raise KeyError(qualified)
        return self.attrs[attr]


# -- predicates (machine-checkable, evaluated host-side) ---------------------

_OPS = {
    "==": np.equal, "!=": np.not_equal, "<": np.less, "<=": np.less_equal,
    ">": np.greater, ">=": np.greater_equal,
}


class Predicate:
    """Machine-checkable predicate over qualified columns.  ``mask`` takes a
    resolver ``col_name -> value array`` (all arrays same length) and returns
    a bool mask — usable both on a single collection's rows and on joined
    tuples."""

    def columns(self) -> FrozenSet[str]:
        raise NotImplementedError

    def mask(self, resolve) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Cmp(Predicate):
    col: str
    op: str
    value: object

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(
                f"unknown comparison {self.op!r}; valid: {sorted(_OPS)}")

    def columns(self) -> FrozenSet[str]:
        return frozenset((self.col,))

    def mask(self, resolve) -> np.ndarray:
        return np.asarray(_OPS[self.op](resolve(self.col), self.value), bool)


@dataclasses.dataclass(frozen=True)
class IsIn(Predicate):
    col: str
    values: Tuple[object, ...]

    def columns(self) -> FrozenSet[str]:
        return frozenset((self.col,))

    def mask(self, resolve) -> np.ndarray:
        return np.isin(resolve(self.col), np.asarray(self.values))


@dataclasses.dataclass(frozen=True)
class And(Predicate):
    a: Predicate
    b: Predicate

    def columns(self) -> FrozenSet[str]:
        return self.a.columns() | self.b.columns()

    def mask(self, resolve) -> np.ndarray:
        return self.a.mask(resolve) & self.b.mask(resolve)


@dataclasses.dataclass(frozen=True)
class Or(Predicate):
    a: Predicate
    b: Predicate

    def columns(self) -> FrozenSet[str]:
        return self.a.columns() | self.b.columns()

    def mask(self, resolve) -> np.ndarray:
        return self.a.mask(resolve) | self.b.mask(resolve)


@dataclasses.dataclass(frozen=True)
class Not(Predicate):
    p: Predicate

    def columns(self) -> FrozenSet[str]:
        return self.p.columns()

    def mask(self, resolve) -> np.ndarray:
        return ~self.p.mask(resolve)


def conjuncts(p: Predicate) -> List[Predicate]:
    """Flatten a conjunction into its top-level terms (pushdown unit)."""
    if isinstance(p, And):
        return conjuncts(p.a) + conjuncts(p.b)
    return [p]


def conjoin(terms: List[Predicate]) -> Optional[Predicate]:
    if not terms:
        return None
    out = terms[0]
    for t in terms[1:]:
        out = And(out, t)
    return out


# -- plan nodes --------------------------------------------------------------


class Plan:
    def children(self) -> Tuple["Plan", ...]:
        raise NotImplementedError

    def columns(self) -> FrozenSet[str]:
        raise NotImplementedError

    def ordered_columns(self) -> Tuple[str, ...]:
        """Output column order of the LOGICAL plan (leaf order) — the
        executor materializes in this order regardless of how the optimizer
        reorders execution, so rewrites are tuple-for-tuple comparable."""
        out: List[str] = []
        for child in self.children():
            out.extend(c for c in child.ordered_columns() if c not in out)
        return tuple(out)

    def collections(self) -> Dict[str, Collection]:
        """Name -> collection, in leaf order.  Names must be unique — a
        self-join needs two differently-named Collection views."""
        out: Dict[str, Collection] = {}
        for child in self.children():
            for name, coll in child.collections().items():
                if name in out and out[name] is not coll:
                    raise ValueError(
                        f"collection name {name!r} appears twice in the "
                        "plan with different contents — alias one side")
                out[name] = coll
        return out

    def describe(self, indent: int = 0) -> str:
        pad = "  " * indent
        head = f"{pad}{type(self).__name__}{self._describe_args()}"
        kids = [c.describe(indent + 1) for c in self.children()]
        return "\n".join([head, *kids])

    def _describe_args(self) -> str:
        return ""


@dataclasses.dataclass
class Scan(Plan):
    collection: Collection

    def children(self) -> Tuple[Plan, ...]:
        return ()

    def columns(self) -> FrozenSet[str]:
        return self.collection.columns()

    def collections(self) -> Dict[str, Collection]:
        return {self.collection.name: self.collection}

    def ordered_columns(self) -> Tuple[str, ...]:
        return tuple(f"{self.collection.name}.{k}"
                     for k in self.collection.attrs)

    def _describe_args(self) -> str:
        return f"({self.collection.name}, {len(self.collection)} rows)"


@dataclasses.dataclass
class Filter(Plan):
    pred: Predicate
    child: Plan

    def __post_init__(self):
        missing = self.pred.columns() - self.child.columns()
        if missing:
            raise ValueError(
                f"filter references unknown columns {sorted(missing)}")

    def children(self) -> Tuple[Plan, ...]:
        return (self.child,)

    def columns(self) -> FrozenSet[str]:
        return self.child.columns()

    def _describe_args(self) -> str:
        return f"({self.pred})"


@dataclasses.dataclass
class Project(Plan):
    cols: Tuple[str, ...]
    child: Plan

    def __post_init__(self):
        self.cols = tuple(self.cols)
        missing = frozenset(self.cols) - self.child.columns()
        if missing:
            raise ValueError(
                f"project references unknown columns {sorted(missing)}")

    def children(self) -> Tuple[Plan, ...]:
        return (self.child,)

    def columns(self) -> FrozenSet[str]:
        return frozenset(self.cols)

    def ordered_columns(self) -> Tuple[str, ...]:
        return self.cols

    def _describe_args(self) -> str:
        return f"({', '.join(self.cols)})"


@dataclasses.dataclass
class CrowdJoin(Plan):
    """Binary crowdsourced entity join at a machine-phase cosine
    ``threshold``: candidate pairs above it are resolved by the crowd (plus
    transitive deduction); output tuples pair rows of one resolved entity."""

    left: Plan
    right: Plan
    threshold: float

    def children(self) -> Tuple[Plan, ...]:
        return (self.left, self.right)

    def columns(self) -> FrozenSet[str]:
        return self.left.columns() | self.right.columns()

    def _describe_args(self) -> str:
        return f"(threshold={self.threshold})"


@dataclasses.dataclass
class MultiJoin(Plan):
    """N-way crowdsourced join over one shared entity universe: every
    cross-collection pair above ``threshold`` is a candidate, tuples take
    one row per collection from each resolved entity cluster.  The input
    order is the execution order — the optimizer reorders it by expected
    crowd cost (DESIGN.md §14)."""

    inputs: List[Plan]
    threshold: float

    def __post_init__(self):
        if len(self.inputs) < 2:
            raise ValueError("MultiJoin needs at least two inputs")

    def children(self) -> Tuple[Plan, ...]:
        return tuple(self.inputs)

    def columns(self) -> FrozenSet[str]:
        out: FrozenSet[str] = frozenset()
        for child in self.inputs:
            out = out | child.columns()
        return out

    def _describe_args(self) -> str:
        return f"(threshold={self.threshold}, {len(self.inputs)} legs)"


def leg(plan: Plan) -> Optional[Tuple[Collection, np.ndarray]]:
    """Resolve a join leg — a Filter*/Scan chain — to (collection, row mask).
    Returns None when the subtree contains a join or projection (not a
    leg)."""
    if isinstance(plan, Scan):
        return plan.collection, np.ones(len(plan.collection), bool)
    if isinstance(plan, Filter):
        below = leg(plan.child)
        if below is None:
            return None
        coll, mask = below
        return coll, mask & plan.pred.mask(coll.column)
    return None
