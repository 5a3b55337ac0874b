"""Serving launcher of the port: batched generation with the ServeEngine, or
the durable join service with kill/restore recovery (DESIGN.md §16).

    # paper-scorer at full width on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-scorer --full

    # the reduced config on the CPU (the plain PyTorch paths)
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

    # durable join serving: run with checkpoints, killed after N commits...
    PYTHONPATH=src python -m repro_torch.launch.serve --mode join \
        --checkpoint-dir /tmp/join_ckpt --kill-after 2

    # ...then resume from the latest checkpoint and finish
    PYTHONPATH=src python -m repro_torch.launch.serve --mode join \
        --checkpoint-dir /tmp/join_ckpt --resume

Flags as the JAX package's ``launch/serve.py`` has them, plus ``--device``
(the card unless ``cpu`` is asked for); the join mode prints the reference
launcher's lines.
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


def _join_workload(seed: int, n: int = 48, p: int = 160):
    from repro_torch.core.pairs import PairSet
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, 8, n)
    u = rng.integers(0, n, p).astype(np.int32)
    v = rng.integers(0, n, p).astype(np.int32)
    keep = u != v
    u, v = u[keep], v[keep]
    truth = assign[u] == assign[v]
    lik = np.clip(rng.random(len(u)) * 0.5 + truth * 0.4, 0.0, 1.0)
    return PairSet(u=u, v=v, likelihood=lik.astype(np.float32),
                   truth=truth, n_objects=n)


def _join(args) -> None:
    """Durable join serving (DESIGN.md §16): a fresh run with checkpoints —
    killed after N commits with ``--kill-after`` — or ``--resume`` from the
    latest checkpoint in ``--checkpoint-dir``."""
    from repro_torch.core.crowd import NoisyCrowd
    from repro_torch.serve.join_service import JoinService, ServiceKilled

    if args.resume:
        service = JoinService.restore(args.checkpoint_dir,
                                      device=args.device)
        info = service.last_recovery
        print(f"[serve] restored step {info['step']}: {info['n_lanes']} "
              f"lanes, {info['n_queued']} queued, {info['n_results']} "
              f"finished, {info['in_flight']} tickets in flight, "
              f"{info['spent_cents']:.1f} cents already committed")
    else:
        service = JoinService(lanes=args.lanes,
                              checkpoint_dir=args.checkpoint_dir,
                              checkpoint_every=args.checkpoint_every,
                              device=args.device)
        for s in range(args.requests):
            service.submit(_join_workload(s), crowd=NoisyCrowd(seed=s))
        if args.kill_after:
            service._crash_after_checkpoints = args.kill_after
    try:
        results = service.run()
    except ServiceKilled as e:
        print(f"[serve] killed: {e}")
        print("[serve] re-run with --resume to recover")
        return
    for rid in sorted(results):
        res = results[rid]
        f = (f", F={res.quality.f_measure:.3f}"
             if res.quality is not None else "")
        print(f"req {rid}: {len(res.labels)} pairs, "
              f"{res.n_crowdsourced} crowdsourced, "
              f"{res.n_spent_cents:.1f} cents{f}")
    print(f"[serve] {len(results)} join requests completed")


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
    # join-mode recovery controls (DESIGN.md §16)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="join mode: checkpoint serving state here")
    ap.add_argument("--checkpoint-every", type=int, default=1)
    ap.add_argument("--kill-after", type=int, default=0,
                    help="join mode: die after N checkpoint commits")
    ap.add_argument("--resume", action="store_true",
                    help="join mode: restore from --checkpoint-dir")
    args = ap.parse_args(argv)
    if args.mode == "join":
        if (args.resume or args.kill_after) and not args.checkpoint_dir:
            ap.error("--resume/--kill-after require --checkpoint-dir")
        _join(args)
    else:
        _generate(args)


if __name__ == "__main__":
    main()
