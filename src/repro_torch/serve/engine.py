"""Batched LM serving: request queue -> wave prefill -> whole-wave greedy
decode, and the LM edition of the paper's machine phase.  A port of the JAX
package's ``serve/engine.py``.

Requests run in lane-sized waves: the wave's prompts are left-padded with
token 0 (no padding mask, as in the reference) and prefilled together, then
the whole wave decodes greedily for the longest request's token budget.
The decode loop is a host loop of :func:`..models.model.decode_step` with
the KV cache resident on the card and updated in place; the cache length
stays a device scalar, so the loop never waits on the card until the
wave's tokens come back at its end.  On the card, prefill and backbone
attention run the hand-written ``flash_attention`` kernel and decode
attention the ``decode_attention`` kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.pair_scores.ops import pair_scores
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None


class ServeEngine:
    """Single-device engine over a :class:`..models.model.Model`; it runs
    where the model's parameters lie.  Decoding is greedy whatever
    ``greedy`` says, as in the reference, which stores the flag and never
    reads it.  A wave whose prompts and new tokens do not fit in
    ``max_len`` raises ValueError (the reference's cache writes clamp to
    the last position instead)."""

    def __init__(self, cfg: ModelConfig, model: M.Model,
                 batch_lanes: int = 4, max_len: int = 512,
                 greedy: bool = True):
        if model.cfg != cfg:
            raise ValueError(f"the model was built for {model.cfg.name}, "
                             f"not for the config given ({cfg.name})")
        self.cfg = cfg
        self.model = model
        self.lanes = batch_lanes
        self.max_len = max_len
        self.greedy = greedy

    def generate(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Processes requests in lane-sized waves (prefill batch, then decode
        until every lane finishes).  Returns {rid: generated tokens}."""
        results: Dict[int, List[int]] = {}
        for i in range(0, len(requests), self.lanes):
            wave = requests[i:i + self.lanes]
            results.update(self._run_wave(wave))
        return results

    def _run_wave(self, wave: List[Request]) -> Dict[int, List[int]]:
        B = len(wave)
        S = max(len(r.prompt) for r in wave)
        steps = max(r.max_new_tokens for r in wave)
        if S + max(steps, 1) - 1 > self.max_len:
            raise ValueError(
                f"a wave of {S}-token prompts and {steps} new tokens needs "
                f"{S + steps - 1} cache positions; max_len is {self.max_len}")
        toks = np.zeros((B, S), np.int32)
        for j, r in enumerate(wave):
            toks[j, S - len(r.prompt):] = r.prompt   # left-pad
        tokens = torch.from_numpy(toks).to(self.model.device)
        cache, logits = M.prefill(self.model, {"tokens": tokens},
                                  self.max_len)
        cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        if steps <= 0:
            return {r.rid: [] for r in wave}
        # the wave emits cur, then steps-1 continuations, one decode_step
        # each; the tokens stay on the device until the wave is done
        emitted = [cur]
        for _ in range(steps - 1):
            logits, cache = M.decode_step(self.model, cache,
                                          {"tokens": cur[:, None]})
            cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            emitted.append(cur)
        out = torch.stack(emitted).cpu().numpy()
        return {r.rid: out[:r.max_new_tokens, j].tolist()
                for j, r in enumerate(wave)}


def embed_records(cfg: ModelConfig, model: M.Model, texts: List[str],
                  vocab: Optional[int] = None,
                  batch: int = 32) -> torch.Tensor:
    """Each record hash-tokenized into 32 positions (zero-padded), run
    through the backbone in batches of ``batch``, and mean-pooled over all
    32 positions, padding included: (len(texts), d_model) f32 on the
    model's device."""
    from repro_torch.data.tokens import hash_tokenize

    vocab = vocab or cfg.vocab
    S = 32
    outs = []
    for i in range(0, len(texts), batch):
        chunk = texts[i:i + batch]
        toks = np.zeros((len(chunk), S), np.int32)
        for j, t in enumerate(chunk):
            tt = hash_tokenize(t, vocab, S)
            toks[j, :len(tt)] = tt
        x, pos = M._embed_inputs(
            model, {"tokens": torch.from_numpy(toks).to(model.device)})
        h = M.backbone(model, x, pos)
        outs.append(h.mean(dim=1).to(torch.float32))
    return torch.cat(outs)


def score_pairs_with_lm(cfg: ModelConfig, model: M.Model,
                        texts_a: List[str], texts_b: List[str],
                        vocab: Optional[int] = None,
                        batch: int = 32) -> np.ndarray:
    """The machine phase of the paper's pipeline, LM edition: embed each
    record with the backbone (mean-pooled hidden states,
    :func:`embed_records`) and return the (len(a), len(b)) likelihood
    matrix ``(cosine + 1) / 2`` through the ``pair_scores`` kernel."""
    ea = embed_records(cfg, model, texts_a, vocab, batch)
    eb = embed_records(cfg, model, texts_b, vocab, batch)
    scores, _ = pair_scores(ea, eb, threshold=-1.0)
    # map cosine [-1, 1] -> likelihood [0, 1]
    return ((scores + 1.0) / 2.0).cpu().numpy()
