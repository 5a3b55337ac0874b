"""Deterministic, sharded LM token pipeline with exact skip-ahead (a copy of
the JAX package's ``data/tokens.py``, numpy throughout).

The likelihood models of the machine phase are trained on record text (or any
corpus).  Requirements at scale: per-host sharding (each host loads only its
slice of the global batch), determinism under a seed, and EXACT restart —
``state = (epoch, step)`` fully determines the next batch, so resuming from a
checkpoint neither replays nor skips data.  ``TokenPipeline.batch_at`` gives
the reference's batch bit for bit (the same numpy generator and slices).

Tokenization is a hash-based subword stub (no external vocab files offline);
it is deterministic and collision-spread over the configured vocab.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterator, List

import numpy as np


def hash_tokenize(text: str, vocab: int, max_len: int) -> np.ndarray:
    """Deterministic subword-ish tokenizer: word + position-salted hashes."""
    toks = []
    for w in text.lower().split():
        h = int.from_bytes(hashlib.blake2b(w.encode(), digest_size=4).digest(),
                           "little")
        toks.append(h % (vocab - 2) + 2)          # 0=pad, 1=sep
        if len(toks) >= max_len:
            break
    return np.asarray(toks[:max_len], np.int32)


def pack_documents(docs: List[np.ndarray], seq_len: int,
                   sep: int = 1) -> np.ndarray:
    """Pack token docs into fixed-length rows (standard LM packing)."""
    flat: List[int] = []
    for d in docs:
        flat.extend(int(t) for t in d)
        flat.append(sep)
    n = max(1, len(flat) // seq_len)
    flat = flat[: n * seq_len]
    return np.asarray(flat, np.int32).reshape(n, seq_len)


@dataclasses.dataclass
class TokenPipeline:
    """Deterministic epoch-shuffled loader over a packed token matrix."""
    rows: np.ndarray                  # (N, seq_len) int32
    global_batch: int
    shard_index: int = 0              # this host's shard
    shard_count: int = 1
    seed: int = 0

    def __post_init__(self):
        if self.global_batch % self.shard_count:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {self.shard_count} shards")
        self.local_batch = self.global_batch // self.shard_count
        self.steps_per_epoch = max(1, len(self.rows) // self.global_batch)

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(len(self.rows))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The batch for a GLOBAL step index — pure function of (seed, step);
        this is the exact skip-ahead restart property.  ``targets`` are the
        tokens shifted left by one, the last position ``-1`` (masked)."""
        epoch = step // self.steps_per_epoch
        k = step % self.steps_per_epoch
        perm = self._perm(epoch)
        start = k * self.global_batch
        idx = perm[start: start + self.global_batch]
        # this host's slice of the global batch
        lo = self.shard_index * self.local_batch
        idx = idx[lo: lo + self.local_batch]
        toks = self.rows[idx]
        targets = np.concatenate(
            [toks[:, 1:], np.full((len(toks), 1), -1, np.int32)], axis=1)
        return {"tokens": toks, "targets": targets}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def corpus_from_records(records: List[str], vocab: int, seq_len: int,
                        repeat: int = 4) -> np.ndarray:
    docs = [hash_tokenize(r, vocab, seq_len) for r in records] * repeat
    return pack_documents(docs, seq_len)
