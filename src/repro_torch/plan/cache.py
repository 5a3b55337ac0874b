"""Cross-query transitive-cluster cache (DESIGN.md §14; the port of
``repro/plan/cache.py``, with its file format: a cache saved by either
package loads into the other and seeds identically).

The crowd's verdicts buy transitive clusters; this cache is where they
persist between queries.  Objects are identified by content fingerprint
(``algebra.row_fingerprints``), so overlap detection is positional-layout
free: the same row bytes in a different collection, position, or query hit
the same cluster.

Storage is a host-side union-find over fingerprints (POS verdicts union)
plus a set of NEG edges between fingerprints.  ``seed`` answers a batch of
pair lookups: same root -> POS, roots joined by a recorded NEG edge -> NEG,
otherwise UNKNOWN (novel — this query pays for it).  NEG edges whose
endpoints have since been unioned are dropped at lookup-index rebuild
(clusters outvote a stale cross edge, the §9 trust-the-graph stance) and
counted in ``n_neg_dropped``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.cluster_graph import NEG, POS, UNKNOWN


class ClusterCache:
    def __init__(self):
        self._parent: Dict[str, str] = {}
        self._negs: Set[Tuple[str, str]] = set()   # sorted fp endpoints
        self._neg_roots: Optional[Set[FrozenSet[str]]] = None
        self.n_hits = 0
        self.n_misses = 0
        self.n_neg_dropped = 0

    # -- union-find over fingerprints ----------------------------------------
    def _find(self, fp: str) -> str:
        parent = self._parent
        if fp not in parent:
            return fp
        root = fp
        while parent.get(root, root) != root:
            root = parent[root]
        while parent.get(fp, fp) != root:
            parent[fp], fp = root, parent[fp]
        return root

    def _union(self, a: str, b: str) -> None:
        ra, rb = self._find(a), self._find(b)
        if ra != rb:
            # deterministic orientation so save/load round-trips exactly
            lo, hi = sorted((ra, rb))
            self._parent.setdefault(lo, lo)
            self._parent[hi] = lo
            self._neg_roots = None  # root-pair index is stale

    def _neg_index(self) -> Set[FrozenSet[str]]:
        if self._neg_roots is None:
            idx: Set[FrozenSet[str]] = set()
            dropped = 0
            for a, b in self._negs:
                ra, rb = self._find(a), self._find(b)
                if ra == rb:
                    dropped += 1  # later POS evidence merged the clusters
                else:
                    idx.add(frozenset((ra, rb)))
            self._neg_roots = idx
            self.n_neg_dropped = dropped
        return self._neg_roots

    # -- stats ---------------------------------------------------------------
    @property
    def n_objects(self) -> int:
        return len(self._parent)

    @property
    def n_clusters(self) -> int:
        return len({self._find(fp) for fp in self._parent})

    @property
    def n_neg_edges(self) -> int:
        return len(self._negs)

    # -- deposit / seed ------------------------------------------------------
    def deposit(self, fps_u: List[str], fps_v: List[str],
                labels: np.ndarray) -> None:
        """Record a completed session's verdicts: per-pair int32
        {UNKNOWN, NEG, POS} (UNKNOWN slots — e.g. budget-stopped pairs —
        deposit nothing)."""
        labels = np.asarray(labels, np.int32)
        if not (len(fps_u) == len(fps_v) == len(labels)):
            raise ValueError("deposit arrays must be same length")
        for a, b, lab in zip(fps_u, fps_v, labels):
            if lab == POS:
                self._union(a, b)
            elif lab == NEG:
                self._negs.add((a, b) if a <= b else (b, a))
                self._neg_roots = None

    def seed(self, fps_u: List[str], fps_v: List[str]) -> np.ndarray:
        """(P,) int32 verdicts for a new query's candidate pairs — POS/NEG
        where the cache already knows, UNKNOWN where the pair is novel."""
        neg_idx = self._neg_index()
        out = np.full(len(fps_u), UNKNOWN, np.int32)
        for i, (a, b) in enumerate(zip(fps_u, fps_v)):
            ra, rb = self._find(a), self._find(b)
            if ra == rb:
                out[i] = POS
            elif frozenset((ra, rb)) in neg_idx:
                out[i] = NEG
        known = int((out != UNKNOWN).sum())
        self.n_hits += known
        self.n_misses += len(out) - known
        return out

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        clusters: Dict[str, List[str]] = {}
        for fp in self._parent:
            clusters.setdefault(self._find(fp), []).append(fp)
        payload = {
            "clusters": [sorted(members) for _, members in
                         sorted(clusters.items())],
            "negs": sorted(list(e) for e in self._negs),
        }
        # write-tmp-then-rename (same commit point as CheckpointManager):
        # a crash mid-write leaves at most a stray .tmp next to an intact
        # previous cache, never a truncated cache at ``path``
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "ClusterCache":
        with open(path) as f:
            payload = json.load(f)
        cache = cls()
        for members in payload["clusters"]:
            for fp in members[1:]:
                cache._union(members[0], fp)
        cache._negs = {tuple(e) for e in payload["negs"]}
        return cache
