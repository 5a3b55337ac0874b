"""End-to-end training script of the port: train the paper-scorer
likelihood model on the entity-record corpus with the full fault-tolerant
runner (checkpoint/restart, skip-ahead data pipeline, optional int8
gradient compression), on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_train_likelihood_model.py --steps 200
    # full ~163M-param config (181 packed rows of 128 tokens, batch 8):
    PYTHONPATH=src python examples/torch_train_likelihood_model.py --full --steps 300
    # the reduced config on the CPU:
    PYTHONPATH=src python examples/torch_train_likelihood_model.py --device cpu --steps 20
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get
from repro_torch.data.entities import make_paper_dataset
from repro_torch.data.tokens import TokenPipeline, corpus_from_records
from repro_torch.train.fault import FailureInjector
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.runner import Runner, RunnerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="full ~163M-param paper-scorer")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--inject-failure", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = get("paper-scorer")
    if not args.full:
        cfg = cfg.reduced()
    ds = make_paper_dataset()
    rows = corpus_from_records(ds.records, cfg.vocab, args.seq)
    pipe = TokenPipeline(rows, global_batch=args.batch)
    inj = FailureInjector(fail_at_steps=(args.inject_failure,)
                          if args.inject_failure >= 0 else ())
    runner = Runner(
        cfg,
        AdamWConfig(lr=3e-4, total_steps=args.steps,
                    warmup_steps=max(2, args.steps // 20)),
        RunnerConfig(total_steps=args.steps, checkpoint_every=50,
                     checkpoint_dir="checkpoints/likelihood",
                     compress_grads=args.compress_grads, log_every=20),
        args.device, pipe, injector=inj)
    out = runner.run()
    h = out["history"]
    print(f"[example] trained {out['final_step']} steps on the record corpus; "
          f"loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f}")


if __name__ == "__main__":
    main()
