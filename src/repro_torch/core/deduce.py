"""Brute-force transitive deduction oracle (Lemma 1 / §2.2 conditions), the
port's copy of ``repro/core/deduce.py``.

Used by tests to validate :class:`repro_torch.core.cluster_graph.ClusterGraph`:
a pair (o, o') is

* deduced ``POS``  iff some path o..o' uses only matching edges,
* deduced ``NEG``  iff some path o..o' uses exactly one non-matching edge,
* undeduced        iff every path contains >= 2 non-matching edges.

Implemented as BFS over states (vertex, #neg-edges-used in {0,1}).  Labels
are the engine codes ``POS`` / ``NEG``.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

from .cluster_graph import NEG, POS


def deduce_bruteforce(
    n_objects: int,
    labeled: List[Tuple[int, int, int]],
    o: int,
    o2: int,
) -> Optional[int]:
    adj: Dict[int, List[Tuple[int, int]]] = {}
    for u, v, lab in labeled:
        w = 0 if lab == POS else 1
        adj.setdefault(u, []).append((v, w))
        adj.setdefault(v, []).append((u, w))

    # visited[vertex][neg_used]
    seen = [[False, False] for _ in range(n_objects)]
    seen[o][0] = True
    q = deque([(o, 0)])
    reach = [False, False]  # can reach o2 with 0 / 1 neg edges
    while q:
        u, k = q.popleft()
        if u == o2:
            reach[k] = True
        for v, w in adj.get(u, ()):
            nk = k + w
            if nk <= 1 and not seen[v][nk]:
                seen[v][nk] = True
                q.append((v, nk))
    if reach[0]:
        return POS
    if reach[1]:
        return NEG
    return None
