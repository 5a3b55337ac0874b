"""Serving launcher of the port: batched generation with the ServeEngine.

    # paper-scorer at full width on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-scorer --full

    # the reduced config on the CPU (the plain PyTorch paths)
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Flags as the JAX package's ``launch/serve.py`` has them.  Its durable join
mode (``--mode join``) is not ported yet and raises (ROADMAP A10).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def _generate(args) -> None:
    from repro_torch.configs import get
    from repro_torch.device import pick_device
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Request, ServeEngine

    dev = pick_device(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_params(cfg, gen, dev)
    engine = ServeEngine(cfg, model, batch_lanes=args.lanes, max_len=256)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(2, cfg.vocab, size=rng.integers(4, 24)
                                        ).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    out = engine.generate(reqs)
    for rid in sorted(out):
        more = "..." if len(out[rid]) > 12 else ""
        print(f"req {rid}: {out[rid][:12]}{more}")
    print(f"[serve] {len(out)} requests completed on {dev}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("generate", "join"),
                    default="generate")
    ap.add_argument("--arch", default="paper-scorer")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.mode == "join":
        raise NotImplementedError(
            "--mode join (durable join serving with checkpoints) is not "
            "ported to repro_torch yet (ROADMAP A10)")
    _generate(args)


if __name__ == "__main__":
    main()
