"""Assigned input shapes and abstract ``input_specs`` per (arch, shape)
(the port of ``repro/configs/shapes.py``).

  train_4k     seq_len=4096   global_batch=256   (training: train_step)
  prefill_32k  seq_len=32768  global_batch=32    (inference prefill)
  decode_32k   seq_len=32768  global_batch=128   (one-token decode over a
                                                  32k KV cache: serve_step)
  long_500k    seq_len=524288 global_batch=1     (long-context decode; only
                                                  SSM/hybrid — see DESIGN.md)

``input_specs`` returns meta tensors (shape and dtype, no storage) for
every model input, as the reference returns ``jax.ShapeDtypeStruct``s.
Modality frontends are stubs: the VLM ships precomputed patch embeddings +
M-RoPE position ids, the audio arch ships conditioning frame embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the skip reason."""
    if shape_name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return "skipped(full-attention O(S^2) prefill; long_500k scoped to SSM/hybrid)"
    return None


def _i32(*shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _bf16(*shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


def train_input_specs(cfg: ModelConfig, shape: Shape,
                      batch_override: int = 0) -> Dict[str, torch.Tensor]:
    """Batch dict for loss_fn / train_step.  The total sequence (prefix stub
    tokens + text/codec tokens) equals shape.seq_len."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    specs: Dict[str, torch.Tensor] = {}
    n_prefix = cfg.n_patch_tokens + cfg.n_cond_tokens
    specs["tokens"] = _i32(B, S - n_prefix)
    specs["targets"] = _i32(B, S)
    if n_prefix:
        specs["prefix_embeds"] = _bf16(B, n_prefix, cfg.d_model)
    if cfg.mrope:
        specs["positions3"] = _i32(B, S, 3)
    return specs


def prefill_input_specs(cfg: ModelConfig, shape: Shape,
                        batch_override: int = 0) -> Dict[str, torch.Tensor]:
    B = batch_override or shape.global_batch
    S = shape.seq_len
    specs: Dict[str, torch.Tensor] = {}
    n_prefix = cfg.n_patch_tokens + cfg.n_cond_tokens
    specs["tokens"] = _i32(B, S - n_prefix)
    if n_prefix:
        specs["prefix_embeds"] = _bf16(B, n_prefix, cfg.d_model)
    if cfg.mrope:
        specs["positions3"] = _i32(B, S, 3)
    return specs


def decode_input_specs(cfg: ModelConfig, shape: Shape,
                       batch_override: int = 0) -> Dict[str, torch.Tensor]:
    B = batch_override or shape.global_batch
    specs = {"tokens": _i32(B, 1)}
    if cfg.mrope:
        specs["positions3"] = _i32(B, 1, 3)
    return specs


def input_specs(cfg: ModelConfig, shape_name: str,
                batch_override: int = 0) -> Dict[str, torch.Tensor]:
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return train_input_specs(cfg, shape, batch_override)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape, batch_override)
    return decode_input_specs(cfg, shape, batch_override)


def dummy_batch(cfg: ModelConfig, seq_len: int, batch: int, kind: str,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Concrete random batch matching the spec layout (smoke tests and
    examples), drawn from ``generator`` on its device.  torch's draws are
    not JAX's; the layout, the dtypes, the vision stub's positions and the
    ``-1`` prefix targets are the reference's."""
    dev = generator.device
    n_prefix = cfg.n_patch_tokens + cfg.n_cond_tokens

    def randint(*shape):
        return torch.randint(0, cfg.vocab, shape, generator=generator,
                             device=dev, dtype=torch.int32)

    if kind == "decode":
        return {"tokens": randint(batch, 1)}
    out: Dict[str, torch.Tensor] = {"tokens": randint(batch,
                                                      seq_len - n_prefix)}
    if n_prefix:
        out["prefix_embeds"] = (torch.randn(
            (batch, n_prefix, cfg.d_model), generator=generator, device=dev,
            dtype=torch.float32) * 0.02).to(torch.bfloat16)
    if cfg.mrope:
        # vision stub: patches on a sqrt grid (t=0), then text positions
        side = max(int(cfg.n_patch_tokens ** 0.5), 1)
        idx = torch.arange(seq_len, device=dev)
        is_text = idx >= n_prefix
        text = idx - n_prefix + side
        t = torch.where(is_text, text, 0)
        h = torch.where(is_text, text, idx // side)
        w = torch.where(is_text, text, idx % side)
        pos3 = torch.stack([t, h, w], dim=-1).to(torch.int32)
        out["positions3"] = pos3.expand(batch, seq_len, 3)
    if kind == "train":
        tgt = randint(batch, seq_len)
        if n_prefix:
            tgt[:, :n_prefix] = -1
        out["targets"] = tgt
    return out
