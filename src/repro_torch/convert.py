"""Carry state between the JAX package and the port as numpy arrays.

The JAX package holds no weights: its state is the embeddings and the
``SessionState`` pytree.  These functions move both across, so the two
engines can start from the same mid-run state (the parity tests) and a
session captured on one side can continue on the other.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.graph import KEY_DTYPE, SessionState
from repro_torch.device import DeviceLike, pick_device

_DTYPES = {"u": torch.int32, "v": torch.int32, "labels": torch.int32,
           "published": torch.bool, "roots": torch.int32,
           "neg_keys": KEY_DTYPE, "rounds": torch.int32,
           "conflicts": torch.int32, "priority": torch.float32}


def session_state_from_numpy(fields: Dict[str, np.ndarray],
                             device: DeviceLike = None) -> SessionState:
    """A :class:`SessionState` (single or stacked) from a JAX
    ``SessionState``'s array fields as numpy arrays.  ``n_objects`` is the
    forest's length, as it is in the reference."""
    dev = pick_device(device)
    missing = set(_DTYPES) - set(fields)
    if missing:
        raise ValueError(f"session state fields missing: {sorted(missing)}")
    if np.asarray(fields["neg_keys"]).dtype != np.int32:
        raise ValueError(
            "neg_keys must be int32 (the reference's default key dtype); "
            "64-bit keys are not ported")
    return SessionState(
        **{f: torch.tensor(np.asarray(fields[f]), dtype=dt, device=dev)
           for f, dt in _DTYPES.items()},
        n_objects=int(np.asarray(fields["roots"]).shape[-1]))


def session_state_to_numpy(state: SessionState) -> Dict[str, np.ndarray]:
    """The state's array fields as host numpy arrays."""
    return {f: getattr(state, f).cpu().numpy() for f in _DTYPES}


def embeddings_from_numpy(x: np.ndarray, device: DeviceLike = None
                          ) -> torch.Tensor:
    """An (N, D) embedding table on the port's device, keeping its dtype
    (bf16 tables arrive as float32 numpy and are cast by the caller)."""
    return torch.tensor(np.asarray(x), device=pick_device(device))
