"""Synthetic entity-resolution datasets calibrated to the paper's §6 setup:
the port's copy of the JAX package's ``data/entities.py``, draw for draw.

The paper evaluates on Cora ("Paper": 997 records, heavy-tailed cluster
sizes with one 102-record cluster -> transitive relations save ~95%) and
Abt-Buy ("Product": 1081+1092 records, tiny clusters -> ~10-20% savings).
Neither is redistributable offline, so the datasets are synthetic with the
same *structure*: ground-truth entity clusters drawn from calibrated
cluster-size distributions, a machine-likelihood model (Beta mixtures)
calibrated so that candidate-set sizes across thresholds 0.1-0.5 land in
the paper's ballpark, and record strings (corrupted canonical names) for
the LM scorer to embed.  :func:`make_session_pairsets` builds small
entity-clustered join sessions for tests and benchmarks.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.pairs import PairSet

_WORDS = (
    "apple ipad iphone galaxy pixel thinkpad core ultra pro max mini air "
    "gen nd rd th edition series model black white silver gb tb wifi lte "
    "camera lens speaker dock hub charger cable adapter mount stand case "
    "paper learning entity resolution crowd database query join index "
    "neural transitive relation cluster graph parallel label order"
).split()


@dataclasses.dataclass
class EntityDataset:
    name: str
    entity_of: np.ndarray       # (N,) int32 ground-truth entity id per record
    records: List[str]          # synthetic record strings
    pairs: PairSet              # all candidate pairs with likelihood >= 0.1
    total_true_matches: int     # matching pairs over the WHOLE dataset

    @property
    def n_objects(self) -> int:
        return len(self.entity_of)

    def cluster_sizes(self) -> np.ndarray:
        _, counts = np.unique(self.entity_of, return_counts=True)
        return np.sort(counts)[::-1]


def _corrupt(rng: np.random.Generator, s: str) -> str:
    toks = s.split()
    ops = rng.integers(0, 4)
    for _ in range(ops):
        k = rng.integers(0, 4)
        if k == 0 and len(toks) > 1:           # drop a token
            toks.pop(int(rng.integers(len(toks))))
        elif k == 1:                            # duplicate-ish abbreviation
            i = int(rng.integers(len(toks)))
            toks[i] = toks[i][: max(2, len(toks[i]) - 2)]
        elif k == 2:                            # swap adjacent
            if len(toks) > 1:
                i = int(rng.integers(len(toks) - 1))
                toks[i], toks[i + 1] = toks[i + 1], toks[i]
        else:                                   # inject noise token
            toks.insert(int(rng.integers(len(toks) + 1)),
                        _WORDS[int(rng.integers(len(_WORDS)))])
    return " ".join(toks)


def _make_records(rng: np.random.Generator, sizes: np.ndarray
                  ) -> Tuple[np.ndarray, List[str]]:
    entity_of = []
    records: List[str] = []
    for eid, s in enumerate(sizes):
        n_tok = int(rng.integers(3, 7))
        canon = " ".join(_WORDS[int(rng.integers(len(_WORDS)))]
                         for _ in range(n_tok))
        for _ in range(int(s)):
            entity_of.append(eid)
            records.append(_corrupt(rng, canon))
    return np.asarray(entity_of, np.int32), records


def _likelihoods(
    rng: np.random.Generator,
    entity_of: np.ndarray,
    match_beta: Tuple[float, float],
    non_beta: Tuple[float, float],
    min_lik: float,
    cross_only_split: int = 0,
    hard_neg_frac: float = 0.0,
    hard_neg_beta: Tuple[float, float] = (2.5, 6.0),
) -> Tuple[PairSet, int]:
    """Materialize all pairs with likelihood >= min_lik.  Matching pairs draw
    from ``match_beta``, non-matching from ``non_beta`` except a
    ``hard_neg_frac`` fraction of confusable non-matches drawn from
    ``hard_neg_beta`` (near-duplicate different products).  With
    ``cross_only_split`` > 0, only cross-source pairs (i < split <= j) are
    candidates (the bipartite Abt-Buy setting)."""
    n = len(entity_of)
    iu, ju = np.triu_indices(n, k=1)
    if cross_only_split:
        m = (iu < cross_only_split) & (ju >= cross_only_split)
        iu, ju = iu[m], ju[m]
    truth = entity_of[iu] == entity_of[ju]
    lik = np.empty(len(iu), np.float32)
    nm = int(truth.sum())
    n_non = len(iu) - nm
    lik[truth] = rng.beta(*match_beta, size=nm)
    non = rng.beta(*non_beta, size=n_non)
    if hard_neg_frac > 0:
        # Confusability is a property of *entity pairs*, not record pairs: two
        # similar-but-different entities make ALL their cross-record pairs look
        # alike (this cluster-pair correlation is what makes the real Cora
        # negatives deducible cheaply — one crowdsourced neg edge kills the
        # whole cluster pair).
        eu = entity_of[iu[~truth]].astype(np.int64)
        ev = entity_of[ju[~truth]].astype(np.int64)
        elo, ehi = np.minimum(eu, ev), np.maximum(eu, ev)
        n_entities = int(entity_of.max()) + 1
        ekey = elo * n_entities + ehi
        uniq, inv = np.unique(ekey, return_inverse=True)
        confusable = rng.random(len(uniq)) < hard_neg_frac
        hard = confusable[inv]
        non[hard] = rng.beta(*hard_neg_beta, size=int(hard.sum()))
    lik[~truth] = non
    keep = lik >= min_lik
    ps = PairSet(iu[keep], ju[keep], lik[keep], truth[keep], n_objects=n)
    return ps, nm


def make_paper_dataset(seed: int = 0, n_records: int = 997) -> EntityDataset:
    """Cora-like: 997 records, heavy-tailed clusters, one of size ~102
    (Figure 11 left)."""
    rng = np.random.default_rng(seed)
    sizes = [102]
    remaining = n_records - 102
    # heavy tail: a few tens-sized clusters, then geometric fall-off
    for s in (74, 61, 52, 47, 40, 35, 31, 27, 24, 21, 19, 17, 15, 13, 12,
              11, 10, 9, 8, 8, 7, 7, 6, 6, 5, 5, 5, 4, 4, 4, 3, 3, 3, 3):
        if remaining - s < 0:
            break
        sizes.append(s)
        remaining -= s
    while remaining > 0:
        s = min(int(rng.integers(1, 4)), remaining)
        sizes.append(s)
        remaining -= s
    sizes = np.asarray(sizes)
    entity_of, records = _make_records(rng, sizes)
    # calibration: matching ~ Beta(6, 2.5)  (P[>0.3] ~ .97, P[>0.5] ~ .84);
    # easy non-match ~ Beta(1, 24); ~4% of entity pairs are confusable
    # (similar papers) with record-pair lik ~ Beta(2.2, 4.0)
    pairs, total_true = _likelihoods(
        rng, entity_of, (6.0, 2.5), (1.0, 24.0), min_lik=0.1,
        hard_neg_frac=0.04, hard_neg_beta=(2.2, 4.0))
    return EntityDataset("paper", entity_of, records, pairs, total_true)


def make_product_dataset(seed: int = 1, n_a: int = 1081, n_b: int = 1092
                         ) -> EntityDataset:
    """Abt-Buy-like: bipartite, ~1050 matched entities, mostly 1-1 matches
    with a tail of small multi-record entities (Figure 11 right)."""
    rng = np.random.default_rng(seed)
    n = n_a + n_b
    entity_of = np.full(n, -1, np.int32)
    eid = 0
    # ~920 1-1 matches, ~60 entities with 2 records on one side (size 3),
    # ~15 of size 4-5 — mirrors Abt-Buy's small-cluster tail.
    a_ids = list(rng.permutation(n_a))
    b_ids = list(rng.permutation(np.arange(n_a, n)))
    for _ in range(920):
        entity_of[a_ids.pop()] = eid
        entity_of[b_ids.pop()] = eid
        eid += 1
    for _ in range(60):
        entity_of[a_ids.pop()] = eid
        entity_of[b_ids.pop()] = eid
        entity_of[b_ids.pop() if rng.random() < 0.5 else a_ids.pop()] = eid
        eid += 1
    for _ in range(15):
        for _ in range(int(rng.integers(4, 6))):
            pool = a_ids if (rng.random() < 0.5 and a_ids) else b_ids
            entity_of[pool.pop()] = eid
        eid += 1
    for i in range(n):           # singletons
        if entity_of[i] < 0:
            entity_of[i] = eid
            eid += 1
    # strings: generate per record from its entity canon
    canon = {}
    records = []
    for i in range(n):
        e = int(entity_of[i])
        if e not in canon:
            n_tok = int(rng.integers(3, 7))
            canon[e] = " ".join(
                _WORDS[int(rng.integers(len(_WORDS)))] for _ in range(n_tok))
        records.append(_corrupt(rng, canon[e]))
    # product matching is harder: match ~ Beta(3.2, 2.2); bulk non-matches are
    # easy (Beta(1,45), mostly < 0.1) but ~0.6% are confusable near-duplicates
    # (Beta(2.5,6)) — this reproduces Abt-Buy's candidate counts (§6: 8315 at
    # th=0.2, 3154 at th=0.3).
    pairs, total_true = _likelihoods(
        rng, entity_of, (3.2, 2.2), (1.0, 45.0), min_lik=0.1,
        cross_only_split=n_a, hard_neg_frac=0.006)
    return EntityDataset("product", entity_of, records, pairs, total_true)


DATASETS = {"paper": make_paper_dataset, "product": make_product_dataset}


def load_dataset(name: str, seed: int = 0) -> EntityDataset:
    return DATASETS[name](seed=seed)


def make_session_pairsets(
    n_sessions: int,
    seed: int = 0,
    n_objects: Tuple[int, int] = (12, 24),
    n_pairs: Tuple[int, int] = (20, 60),
    n_entities: Optional[int] = 5,
    likelihood: Tuple[float, float, float] = (0.8, 0.3, 0.15),
) -> List[PairSet]:
    """Small entity-clustered join sessions for benchmarks and tests.

    Each session draws ``n ~ U[n_objects)`` records over ground-truth entity
    clusters (``n_entities``; None scales it as ``max(n // 6, 2)``), samples
    ``m ~ U[n_pairs)`` distinct candidate pairs, and assigns likelihoods
    correlated with truth — ``base_match`` / ``base_non`` + ``noise``
    uniform jitter."""
    rng = np.random.default_rng(seed)
    base_match, base_non, noise = likelihood
    out: List[PairSet] = []
    for _ in range(n_sessions):
        n = int(rng.integers(*n_objects))
        k = n_entities if n_entities is not None else max(n // 6, 2)
        ent = rng.integers(0, k, n)
        all_e = list(itertools.combinations(range(n), 2))
        # clamp both ends: a small n may not have n_pairs[0] distinct pairs
        m_hi = min(n_pairs[1], len(all_e))
        m_lo = min(n_pairs[0], m_hi)
        m = int(rng.integers(m_lo, m_hi + 1))
        sel = rng.permutation(len(all_e))[:m]
        u = np.array([all_e[i][0] for i in sel], np.int32)
        v = np.array([all_e[i][1] for i in sel], np.int32)
        truth = ent[u] == ent[v]
        lik = (np.where(truth, base_match, base_non)
               + noise * rng.random(m)).astype(np.float32)
        out.append(PairSet(u, v, lik, truth, n_objects=n))
    return out
