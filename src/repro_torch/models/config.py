"""Model configuration for the 10 assigned architectures + the paper's own
likelihood-scorer model: a copy of the JAX package's ``models/config.py``,
field for field, so one config drives both packages."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                # 0 => attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 => d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0         # zamba2: shared attention every k mamba layers
    rwkv: bool = False
    rwkv_decay_rank: int = 64
    # --- positions / frontends ---
    rope_theta: float = 1e6
    mrope: bool = False         # qwen2-vl M-RoPE (t/h/w sections)
    mrope_sections: Tuple[int, int, int] = (32, 16, 16)  # pairs of head_dim/2
    n_patch_tokens: int = 0     # vlm stub: image patch embeddings prepended
    n_cond_tokens: int = 0      # audio stub: conditioning frame embeddings
    tie_embeddings: bool = False
    # --- numerics / runtime ---
    kv_quant: bool = False      # int8 KV cache (decode hillclimb)
    moe_impl: str = "gspmd"     # gspmd | a2a (shard_map all-to-all EP)
    norm_eps: float = 1e-5
    attn_impl: str = "chunked"  # chunked | pallas (naive raises)
    attn_chunk_q: int = 512
    attn_chunk_k: int = 1024
    ssm_chunk: int = 128
    remat: str = "block"        # none | block
    logits_f32: bool = True

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        assert self.n_heads > 0
        return self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm" and self.rwkv

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def n_shared_attn(self) -> int:
        """zamba2: number of shared-attention invocations."""
        if self.attn_every <= 0:
            return 0
        return (self.n_layers + self.attn_every - 1) // self.attn_every

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2 if self.attn_every <= 0 else 4),
            d_model=128,
            d_ff=256,
            vocab=min(self.vocab, 512),
            head_dim=32,
            attn_chunk_q=64,
            attn_chunk_k=64,
            ssm_chunk=32,
            rwkv_decay_rank=8,
        )
        if self.n_heads:
            kw["n_heads"] = 4
            kw["n_kv_heads"] = min(self.n_kv_heads, 2) or 2
        if self.is_moe:
            kw["n_experts"] = 4
            kw["top_k"] = 2
        if self.ssm_state:
            kw["ssm_state"] = 16
            kw["ssm_head_dim"] = 32
        if self.attn_every:
            kw["attn_every"] = 2
        if self.n_patch_tokens:
            kw["n_patch_tokens"] = 8
        if self.n_cond_tokens:
            kw["n_cond_tokens"] = 8
        if self.mrope:
            kw["mrope_sections"] = (8, 4, 4)
        return self.replace(**kw)
