"""Registry of the 10 assigned architectures (+ the paper's own scorer).

Each ``configs/<id>.py`` holds the exact config of the JAX package's module of
the same name (data only, copied); reduced smoke configs are derived via
``ModelConfig.reduced()``.  Which families the port's model runs is said in
:mod:`repro_torch.models.model`.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import (deepseek_67b, granite_3_2b, internlm2_1_8b, moonshot_v1_16b_a3b,
               musicgen_medium, olmoe_1b_7b, paper_scorer, phi3_medium_14b,
               qwen2_vl_2b, rwkv6_3b, zamba2_1_2b)

_MODULES = [
    moonshot_v1_16b_a3b, olmoe_1b_7b, qwen2_vl_2b, deepseek_67b,
    internlm2_1_8b, phi3_medium_14b, granite_3_2b, zamba2_1_2b,
    rwkv6_3b, musicgen_medium, paper_scorer,
]

ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ASSIGNED = [n for n in ARCHS if n != "paper-scorer"]


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
