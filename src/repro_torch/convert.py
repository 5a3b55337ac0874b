"""Carry state between the JAX package and the port as numpy arrays.

The join side's state is the embeddings and the ``SessionState`` pytree;
the LM scorer's is the model's parameter pytree, and its training's the
train state ``{"params", "opt": {"m", "v", "step"}, ["err"]}``.  These
functions move them across, so the two packages can start from the same
state (the parity tests) and what one side captured can continue on the
other.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.graph import SessionState
from repro_torch.device import DeviceLike, pick_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, model_specs

_DTYPES = {"u": torch.int32, "v": torch.int32, "labels": torch.int32,
           "published": torch.bool, "roots": torch.int32,
           "neg_keys": None,   # kept: int32, or int64 under x64
           "rounds": torch.int32,
           "conflicts": torch.int32, "priority": torch.float32}


def session_state_from_numpy(fields: Dict[str, np.ndarray],
                             device: DeviceLike = None) -> SessionState:
    """A :class:`SessionState` (single or stacked) from a JAX
    ``SessionState``'s array fields as numpy arrays.  ``n_objects`` is the
    forest's length, as it is in the reference.  ``neg_keys`` keep their
    dtype: int32 (the reference's default) or int64 (under
    ``jax_enable_x64``)."""
    dev = pick_device(device)
    missing = set(_DTYPES) - set(fields)
    if missing:
        raise ValueError(f"session state fields missing: {sorted(missing)}")
    if np.asarray(fields["neg_keys"]).dtype not in (np.int32, np.int64):
        raise ValueError(
            f"neg_keys must be int32 or int64, got "
            f"{np.asarray(fields['neg_keys']).dtype}")
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


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "/"))
        else:
            out[path] = val
    return out


def model_params_from_numpy(cfg: ModelConfig, params: Dict[str, Any],
                            device: DeviceLike = None) -> Model:
    """The port's :class:`Model` from the JAX package's nested parameter
    dict (``embed/table``, ``layers/{ln1,ln2}/scale``,
    ``layers/attn/{wq,wk,wv,wo}``, ``layers/mlp/{wi_gate,wi_up,wo}``,
    ``final_norm/scale``, ``lm_head/w``; the layer axis leading; the
    experts' ``layers/moe/...``, RWKV's ``layers/{mu_*,w_*,w0,wA,wB,
    bonus_u,ln_x}``, zamba2's ``layers/mamba/...`` and its shared block's
    ``shared/{ln_in,attn,ln_mlp,mlp}/...`` with no layer axis; whatever
    :func:`..models.model.model_specs` lists) as numpy arrays, every
    tensor in its ``ParamSpec`` dtype on ``device``.  numpy
    has no bf16: pass bf16 leaves as ``np.asarray(x, np.float32)``, which is
    exact, and the cast back to bf16 here is exact too.  Raises ValueError
    on a missing, unexpected or misshaped leaf (:class:`Model` checks).
    The tensors are copies: the caller's arrays are never written."""
    dev = pick_device(device)
    specs = model_specs(cfg)
    flat = _flatten(params)
    return Model(cfg, {
        path: torch.tensor(np.asarray(arr), device=dev,
                           dtype=specs[path].dtype if path in specs else None)
        for path, arr in flat.items()})


def _tensors(tree: Dict[str, Any], dev: torch.device) -> Dict[str, Any]:
    return {k: _tensors(v, dev) if isinstance(v, dict)
            else torch.tensor(np.asarray(v), device=dev)
            for k, v in tree.items()}


def _arrays(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _arrays(v) if isinstance(v, dict) else _host(v)
            for k, v in tree.items()}


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def train_state_from_numpy(cfg: ModelConfig, state: Dict[str, Any],
                           device: DeviceLike = None) -> Dict[str, Any]:
    """The port's train state from the JAX package's (``train_step.
    init_state``'s tree) as numpy arrays: the parameters as a trainable
    :class:`Model` (:func:`model_params_from_numpy`; bf16 leaves as f32
    arrays), the f32 moments, the int32 step and, when present, the f32
    error buffers, all copies on ``device``."""
    dev = pick_device(device)
    model = model_params_from_numpy(cfg, state["params"], dev)
    model.requires_grad_(True)
    out: Dict[str, Any] = {"params": model,
                           "opt": _tensors(state["opt"], dev)}
    if "err" in state:
        out["err"] = _tensors(state["err"], dev)
    return out


def train_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The train state as the reference's tree of host numpy arrays (bf16
    leaves as f32, which is exact)."""
    out = {k: v for k, v in state.items() if k != "params"}
    return {"params": _arrays(state["params"].params), **_arrays(out)}
