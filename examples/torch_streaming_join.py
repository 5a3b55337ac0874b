"""Streaming ingest on the PyTorch port (DESIGN.md §11):
``examples/streaming_join.py`` with ``repro_torch``.

A corpus of records opens a join session; three arrival epochs then land
while the session is live.  Each epoch is scored incrementally against the
cached corpus (new-vs-corpus and new-vs-new blocks only), its candidate
pairs fold into the live session state, and everything already labeled or
deduced stays paid for.  The example contrasts that with resubmitting the
accumulated candidate set from scratch every epoch.  The service and the
embeddings live on the card unless ``--device cpu`` says otherwise; the
mesh is the single device's (``mesh=None``).

    PYTHONPATH=src python examples/torch_streaming_join.py               # card
    PYTHONPATH=src python examples/torch_streaming_join.py --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.convert import embeddings_from_numpy
from repro_torch.core.crowd import PerfectCrowd
from repro_torch.kernels.pair_scores.blocking import BlockingConfig
from repro_torch.serve.join_service import JoinService


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the service runs: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)

    # a shared entity universe; records arrive in one seed corpus + 3 epochs
    n_ent, D = 24, 24
    cents = rng.normal(size=(n_ent, D))

    def arrive(n):
        ids = rng.integers(0, n_ent, n)
        emb = (cents[ids] + 0.3 * rng.normal(size=(n, D))).astype(np.float32)
        return list(ids), embeddings_from_numpy(emb, args.device)

    a_ids, emb_a = arrive(60)
    b_ids, emb_b = arrive(50)
    epochs = [(arrive(20), arrive(16)) for _ in range(3)]

    # -- streaming: one live session, grown per epoch -----------------------
    svc = JoinService(lanes=1, device=args.device)
    all_a, all_b = list(a_ids), list(b_ids)

    def truth_fn(r, c):
        return np.asarray(all_a)[r] == np.asarray(all_b)[c]

    rid = svc.submit_embeddings(emb_a, emb_b, 0.75, None,
                                crowd=PerfectCrowd(), truth_fn=truth_fn,
                                streaming=True)
    for (na, ea), (nb, eb) in epochs:
        all_a += na
        all_b += nb
        svc.append_embeddings(rid, ea, eb)  # incremental: only new blocks
    res = svc.run()[rid]
    print(f"streaming: {len(res.labels)} pairs, "
          f"crowdsourced={res.n_crowdsourced}, deduced={res.n_deduced}, "
          f"precision={res.quality.precision:.2f} "
          f"recall={res.quality.recall:.2f}")

    # -- streaming + blocking (DESIGN.md §12): arrivals hash into the
    #    existing buckets and only the tiles their buckets touch are scored
    cfg = BlockingConfig.for_recall(0.95, threshold=0.75, n_bits=5)
    svc_b = JoinService(lanes=1, device=args.device)
    all_a, all_b = list(a_ids), list(b_ids)
    rid_b = svc_b.submit_embeddings(emb_a, emb_b, 0.75, None,
                                    crowd=PerfectCrowd(), truth_fn=truth_fn,
                                    streaming=True, blocking=cfg)
    for (na, ea), (nb, eb) in epochs:
        all_a += na
        all_b += nb
        svc_b.append_embeddings(rid_b, ea, eb)  # only touched buckets
    res_b = svc_b.run()[rid_b]
    print(f"streaming+blocking ({cfg.n_tables} tables): {len(res_b.labels)} "
          f"pairs, crowdsourced={res_b.n_crowdsourced}, "
          f"precision={res_b.quality.precision:.2f}")

    # -- the alternative: full resubmission after every epoch ---------------
    resubmit_crowd = 0
    ca, cb = emb_a, emb_b
    for (na, ea), (nb, eb) in epochs:
        ca = torch.cat([ca, ea])
        cb = torch.cat([cb, eb])
        fresh = JoinService(lanes=1, device=args.device)
        r = fresh.submit_embeddings(ca, cb, 0.75, None, crowd=PerfectCrowd(),
                                    truth_fn=truth_fn)
        resubmit_crowd += fresh.run()[r].n_crowdsourced
    print(f"resubmit-from-scratch: {resubmit_crowd} crowd questions "
          f"across 3 epochs vs {res.n_crowdsourced} streamed "
          f"({1 - res.n_crowdsourced / resubmit_crowd:.0%} saved)")


if __name__ == "__main__":
    main()
