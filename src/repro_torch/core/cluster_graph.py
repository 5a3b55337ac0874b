"""ClusterGraph — the paper's deduction structure (§2.2, §3.2, Algorithm 1),
the port's copy of ``repro/core/cluster_graph.py``.

Union-find clusters over *matching* edges, plus cluster-level
*non-matching* edges.  ``DeduceLabel`` (Algorithm 1) is
:meth:`ClusterGraph.deduce`:

* same cluster                       -> deduced ``POS``
* neg edge between the two clusters  -> deduced ``NEG``
* otherwise                          -> undeduced, ``None`` (every path
  has >= 2 neg edges)

The port speaks one label encoding throughout: the integer codes below,
which the engine, the crowds and this graph share (the reference's graph
speaks the strings ``"M"`` / ``"N"``).  This is the exact sequential
oracle the array engine (:mod:`repro_torch.core.graph`) is held against.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Set, Tuple

UNKNOWN = -1
NEG = 0
POS = 1


class ClusterGraph:
    """Union-find with path compression + union by size, and cluster-level
    negative adjacency merged small-into-large on union."""

    __slots__ = ("parent", "size", "neg", "n_conflicts")

    def __init__(self, n_objects: int):
        self.parent = list(range(n_objects))
        self.size = [1] * n_objects
        # neg[root] = set of enemy roots (kept consistent under unions)
        self.neg: Dict[int, Set[int]] = {}
        self.n_conflicts = 0  # contradictory labels seen (noisy crowds only)

    # -- union-find ----------------------------------------------------------
    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:  # path compression
            p[x], x = root, p[x]
        return root

    def connected(self, a: int, b: int) -> bool:
        return self.find(a) == self.find(b)

    def _union(self, ra: int, rb: int) -> int:
        """Union two roots; returns the surviving root. Maintains neg sets."""
        if ra == rb:
            return ra
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]
        # merge neg adjacency of rb into ra (small-to-large overall)
        enemies_b = self.neg.pop(rb, None)
        if enemies_b:
            ea = self.neg.setdefault(ra, set())
            for e in enemies_b:
                se = self.neg.get(e)
                if se is not None:
                    se.discard(rb)
                    se.add(ra)
                ea.add(e)
            ea.discard(ra)  # self-loops can't arise under consistent labels
        return ra

    def _has_neg_edge(self, ra: int, rb: int) -> bool:
        sa = self.neg.get(ra)
        if sa is None:
            return False
        return rb in sa

    # -- paper API ------------------------------------------------------------
    def deduce(self, o: int, o2: int) -> Optional[int]:
        """Algorithm 1 (DeduceLabel): ``POS``, ``NEG`` or ``None``."""
        ra, rb = self.find(o), self.find(o2)
        if ra == rb:
            return POS
        if self._has_neg_edge(ra, rb):
            return NEG
        return None

    def add_label(self, o: int, o2: int, label: int) -> bool:
        """Insert a labeled pair (``POS`` or ``NEG``).  Returns False iff it
        contradicts the graph (only possible with noisy crowd labels);
        contradictions are dropped to keep the graph consistent, and
        counted."""
        ra, rb = self.find(o), self.find(o2)
        if label == POS:
            if self._has_neg_edge(ra, rb):
                self.n_conflicts += 1
                return False
            self._union(ra, rb)
            return True
        if label == NEG:
            if ra == rb:
                self.n_conflicts += 1
                return False
            self.neg.setdefault(ra, set()).add(rb)
            self.neg.setdefault(rb, set()).add(ra)
            return True
        raise ValueError(f"bad label {label!r}: use POS ({POS}) or NEG "
                         f"({NEG})")

    def add_labels(self, triples: Iterable[Tuple[int, int, int]]) -> None:
        for o, o2, lab in triples:
            self.add_label(o, o2, lab)

    # -- introspection ---------------------------------------------------------
    def clusters(self) -> Dict[int, list]:
        out: Dict[int, list] = {}
        for i in range(len(self.parent)):
            out.setdefault(self.find(i), []).append(i)
        return out

    def n_clusters(self) -> int:
        return sum(1 for i, p in enumerate(self.parent) if self.find(i) == i)
