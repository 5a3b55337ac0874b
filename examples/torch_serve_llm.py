"""Batched serving on the PyTorch port: ``examples/serve_llm.py`` with
``repro_torch``.  Generates continuations for a wave of requests with an
assigned architecture at its reduced config, on the card unless
``--device cpu`` says otherwise.  The engine passes tokens only, as the
reference's does: an M-RoPE config (``qwen2-vl-2b``) raises and is served
through the model-level ``prefill`` / ``decode_step``.

    PYTHONPATH=src python examples/torch_serve_llm.py                # card
    PYTHONPATH=src python examples/torch_serve_llm.py --device cpu
    PYTHONPATH=src python examples/torch_serve_llm.py --arch olmoe-1b-7b
    PYTHONPATH=src python examples/torch_serve_llm.py --arch rwkv6-3b
    PYTHONPATH=src python examples/torch_serve_llm.py --arch zamba2-1.2b
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.device import pick_device
from repro_torch.models.model import init_params
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None, model=None) -> None:
    """``model``: a :class:`repro_torch.models.model.Model` of the reduced
    ``--arch`` to serve (by default one drawn from a seeded generator on
    the device)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="where the model runs: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = get(args.arch).reduced()
    if model is None:
        dev = pick_device(args.device)
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    engine = ServeEngine(cfg, model, batch_lanes=3, max_len=128)
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(2, cfg.vocab, size=int(rng.integers(
                4, 20))).astype(np.int32), max_new_tokens=8)
            for i in range(args.n)]
    out = engine.generate(reqs)
    for rid in sorted(out):
        print(f"[{args.arch}] request {rid} -> tokens {out[rid]}")


if __name__ == "__main__":
    main()
