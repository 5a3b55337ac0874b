"""Training launcher of the port.

    # paper-scorer at full width on the card
    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 200

    # the reduced config on the CPU (the plain PyTorch paths)
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3

Flags as the JAX package's ``launch/train.py`` has them, plus ``--device``
(the card unless ``cpu`` is asked for).  ``--reduced`` is the default and
``--full`` turns it off, as in the reference.  ``--production-mesh``
builds the reference's 16 x 16 mesh over the process group this process
is a rank of (256 ranks, one a card, started by a cluster launcher that
initializes ``torch.distributed``), and trains on it; with fewer ranks it
raises ``make_production_mesh``'s ``RuntimeError``.  The default is one
device.  A smaller mesh of ranks on one host:
``repro_torch.launch.mesh.spawn`` of a function that builds the ``Runner``
on the mesh it is given (``README.md``).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-scorer")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--checkpoint-dir", default="checkpoints/train")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--dataset", default="paper",
                    help="entity dataset providing the training text")
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 mesh (requires 256 ranks)")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a simulated node failure at this step")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get
    from repro_torch.data.entities import load_dataset
    from repro_torch.data.tokens import TokenPipeline, corpus_from_records
    from repro_torch.device import pick_device
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train.fault import FailureInjector
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.runner import Runner, RunnerConfig

    dev = pick_device(args.device)
    mesh = make_production_mesh(device=dev) if args.production_mesh \
        else dev
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    ds = load_dataset(args.dataset)
    rows = corpus_from_records(ds.records, cfg.vocab, args.seq)
    pipe = TokenPipeline(rows, global_batch=args.batch)
    injector = FailureInjector(
        fail_at_steps=(args.fail_at,) if args.fail_at >= 0 else ())
    runner = Runner(
        cfg,
        AdamWConfig(lr=args.lr, total_steps=args.steps,
                    warmup_steps=max(2, args.steps // 20)),
        RunnerConfig(total_steps=args.steps,
                     checkpoint_every=args.checkpoint_every,
                     checkpoint_dir=args.checkpoint_dir,
                     microbatches=args.microbatches,
                     compress_grads=args.compress_grads),
        mesh, pipe, injector=injector)
    out = runner.run()
    hist = out["history"]
    print(f"[train] done: {out['final_step']} steps, "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
