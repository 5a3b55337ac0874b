"""Record tokenization for the LM scorer (a copy of ``hash_tokenize`` in the
JAX package's ``data/tokens.py``).

Tokenization is a hash-based subword stub (no external vocab files offline);
it is deterministic and collision-spread over the configured vocab.  The
token pipeline for training is not ported yet (ROADMAP A12).
"""
from __future__ import annotations

import hashlib

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
