"""Plain PyTorch version of the fused union–deduce step (DESIGN.md §13),
composed from the round engine's own primitives: the CPU path of
:mod:`.ops` and the version the CUDA kernel is held against on the card.

Per lane, given a compressed forest and a sorted neg-key index:

* ``roots``    — the forest after uniting every ``pos_mask`` edge;
* ``deduced``  — POS when a pair's endpoints share a root under the new
  forest, NEG when its canonical root key is in the re-keyed index, else
  UNKNOWN;
* ``conflict`` — True when an existing neg key's endpoints now share a root.
"""
from __future__ import annotations

import torch


def union_deduce_ref(parent0: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     pos_mask: torch.Tensor, neg_keys: torch.Tensor,
                     n_objects: int):
    """Stacked lanes: parent0 (B, n), u/v/pos_mask/neg_keys (B, P).
    Returns ``(roots (B, n) int32, deduced (B, P) int32, conflict (B,)
    bool)``."""
    # the primitives live with the engine, which imports this package
    from repro_torch.core.graph import (_decompose_keys, _deduce_lookup_impl,
                                        _rekey_impl, _take, _union_impl)
    roots = _union_impl(parent0, u, v, pos_mask, n_objects)
    lo, hi, is_pad = _decompose_keys(neg_keys, n_objects)
    conflict = (~is_pad & (_take(roots, lo) == _take(roots, hi))).any(-1)
    rekeyed = _rekey_impl(neg_keys, roots, n_objects)
    deduced = _deduce_lookup_impl(roots, rekeyed, u, v, n_objects)
    return roots, deduced, conflict
